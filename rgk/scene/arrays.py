"""Frozen SoA scene arrays — the device-resident scene representation.

This is the device-side counterpart of the reference's committed
scene (reference src/scene.cpp Scene::Commit): all geometry, material,
texture, and light data flattened into dense arrays that live in
device memory, replicated per device, and are gathered into by the
wavefront kernels.

Structure-of-arrays layout notes:
* geometry: vertices/normals/tangents [V,3], uvs [V,2], triangles as
  int32 index triples + int32 material ids (one gather per attribute);
* materials: one row per material with a `bxdf_type` enum driving
  branchless dispatch in ops/bxdf.py;
* textures: one flat texel buffer [N,3] plus (offset, width, height)
  descriptors — bilinear fetch is 4 gathers regardless of which
  texture a lane addresses (no divergent "texture objects");
* lights: prefix-sum power tables for O(log n) binary-search sampling.

Everything here is a NamedTuple of arrays => a JAX pytree that can be
donated, sharded, and differentiated.  Static (shape-determining)
metadata lives in `SceneMeta`, which is closed over by the jitted
render functions rather than traced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# BxDF type enum (dispatch indices for ops/bxdf.py).  Mirrors the
# reference's BxDF class hierarchy (src/bxdf/bxdf.hpp).
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_TRANSPARENT = 2
BSDF_DIELECTRIC = 3
BSDF_LTC_BECKMANN = 4
BSDF_LTC_GGX = 5
BSDF_LTC_BECKMANN_DIFFUSE = 6
BSDF_LTC_GGX_DIFFUSE = 7
BSDF_MIX = 8

BSDF_NAMES = {
    "diffuse": BSDF_DIFFUSE,
    "diffusecosine": BSDF_DIFFUSE,
    "mirror": BSDF_MIRROR,
    "transparent": BSDF_TRANSPARENT,
    "dielectric": BSDF_DIELECTRIC,
    "ltc_beckmann": BSDF_LTC_BECKMANN,
    "ltc_ggx": BSDF_LTC_GGX,
    "ltc_beckmann_diffuse": BSDF_LTC_BECKMANN_DIFFUSE,
    "ltc_ggx_diffuse": BSDF_LTC_GGX_DIFFUSE,
    "mix": BSDF_MIX,
}


class MaterialTable(NamedTuple):
    bxdf_type: jnp.ndarray     # int32 [NM]
    emission: jnp.ndarray      # f32 [NM,3]
    diffuse: jnp.ndarray       # f32 [NM,3] solid diffuse / base color
    diffuse_tex: jnp.ndarray   # int32 [NM], -1 = use solid color
    specular: jnp.ndarray      # f32 [NM,3] solid specular / mirror color
    specular_tex: jnp.ndarray  # int32 [NM]
    bump_tex: jnp.ndarray      # int32 [NM]
    roughness: jnp.ndarray     # f32 [NM]
    ior: jnp.ndarray           # f32 [NM]
    mix_m1: jnp.ndarray        # int32 [NM] (self when not a mix)
    mix_m2: jnp.ndarray        # int32 [NM]
    mix_amt: jnp.ndarray       # f32 [NM]
    no_russian: jnp.ndarray    # bool [NM]
    is_thinglass: jnp.ndarray  # bool [NM]


class TextureAtlas(NamedTuple):
    texels: jnp.ndarray  # f32 [N, 3] flat texel pool (>=1 row)
    desc: jnp.ndarray    # int32 [T, 3] = (offset, width, height)


class LightTable(NamedTuple):
    # Point lights (reference Light::FULL_SPHERE)
    point_pos: jnp.ndarray        # f32 [P,3]
    point_color: jnp.ndarray      # f32 [P,3]
    point_intensity: jnp.ndarray  # f32 [P]
    point_size: jnp.ndarray       # f32 [P]
    point_cum: jnp.ndarray        # f32 [P] inclusive prefix of power
    # Areal lights, flattened to emissive triangles.  weight(tri) =
    # area(tri) * sum(emission(group)) — identical distribution to the
    # reference's two-level group/triangle pick (scene.cpp:686-745).
    areal_tri: jnp.ndarray        # int32 [K] triangle indices
    areal_cum: jnp.ndarray        # f32 [K] inclusive prefix of weight
    # De-indexed per-areal-triangle rows (va, vb, vc, normal_a,
    # emission) [K, 15]: the queued tracer samples the path light
    # every loop iteration, so the areal pick must be ONE row-fetch,
    # not a tri->vertices indirection chain of five.
    areal_rows: jnp.ndarray       # f32 [K, 15]
    total_point_power: jnp.ndarray  # f32 []
    total_areal_power: jnp.ndarray  # f32 []


class BVHArrays(NamedTuple):
    """Flattened 2-wide BVH (see scene/bvh.py).  nodes has one row per
    node: [min(3), max(3)] f32 and int32 meta (left/start, count,
    skip-link)."""
    node_min: jnp.ndarray   # f32 [NN,3]
    node_max: jnp.ndarray   # f32 [NN,3]
    node_meta: jnp.ndarray  # int32 [NN,3] = (first, count, skip)
    prim_idx: jnp.ndarray   # int32 [M] leaf->triangle permutation


class SceneArrays(NamedTuple):
    vertices: jnp.ndarray   # f32 [V,3]
    normals: jnp.ndarray    # f32 [V,3]
    tangents: jnp.ndarray   # f32 [V,3]
    uvs: jnp.ndarray        # f32 [V,2]
    tri_vidx: jnp.ndarray   # int32 [M,3]
    tri_mat: jnp.ndarray    # int32 [M]
    tri_normal: jnp.ndarray  # f32 [M,3] geometric plane normal
    # Badouel intersection coefficients, one affine system per
    # triangle (see builder.build_tri_pack): [M, 13] =
    # (n.xyz, d, b0, bv.xyz, g0, gv.xyz, is_thinglass).  Hit t and
    # both barycentrics are affine in (ro, t*rd), so a ray-triangle
    # test is a handful of FMAs (the reference's per-triangle Badouel
    # test, src/primitives.cpp:75-166).
    tri_pack: jnp.ndarray   # f32 [M, 13]
    # (v0, v1, v2, mat) as one row: one gather per hit.
    tri_meta: jnp.ndarray   # int32 [M, 4]
    # Per-triangle shading attributes, de-indexed: the 3 vertex
    # normals (9), uvs (6) and tangents (9) of each triangle in one
    # row.  One [R,24] gather replaces nine [V,*] gathers per hit.
    tri_shade: jnp.ndarray  # f32 [M, 24]
    # (areal-light sampling reads the de-indexed lights.areal_rows
    # table; per-triangle vertex positions are NOT carried — a dead
    # [M,9] field cost 36 MB of HBM + upload at 1M tris)
    # LTC fit tables ride in the pytree (ops/ltc.py): closure-constant
    # gather operands hit an XLA slow path; traced args do not.
    ltc_rows: jnp.ndarray   # f32 [2*64*64, 10]
    # Thin-glass triangle SUBSET for the ordered hit-list query
    # (ops/thinglass.py): the reference's fourth traversal collects
    # thin-glass hits while skipping them (src/scene_intersect.cpp:
    # 385-399); here that's a SECOND narrow sweep over just the
    # glass triangles (panes are few) instead of K-lists inside the
    # hot any-hit kernel.  One never-hit row (d=1) when the scene has
    # no thin glass.
    glass_pack: jnp.ndarray  # f32 [G, 12] Badouel rows of glass tris
    glass_ids: jnp.ndarray   # i32 [G] original triangle ids (-1 pad)
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    bvh: BVHArrays
    # Sky (reference scene.cpp GetSkyboxRay): constant color or latlong
    # envmap with Y rotation; sky_tex < 0 selects the constant.
    sky_color: jnp.ndarray      # f32 [3]
    sky_intensity: jnp.ndarray  # f32 []
    sky_rotate: jnp.ndarray     # f32 [] (degrees)
    sky_tex: jnp.ndarray        # int32 []
    epsilon: jnp.ndarray        # f32 [] dynamic scene epsilon
    world_min: jnp.ndarray      # f32 [3]
    world_max: jnp.ndarray      # f32 [3]


@dataclass(frozen=True)
class SceneMeta:
    """Static facts about a committed scene (never traced).

    The has_* flags let the integrator drop whole code paths at trace
    time (mix second-pass evals, LTC table fetches, bump shading) —
    branchless dispatch only pays for lobes the scene can reach.
    """
    n_triangles: int
    n_materials: int
    n_point_lights: int
    n_areal_tris: int
    has_bvh: bool
    has_textures: bool
    has_thinglass: bool
    has_mix: bool = True
    has_ltc: bool = True
    has_envmap: bool = True
    material_names: tuple = ()


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32))
