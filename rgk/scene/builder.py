"""Host-side scene assembly: materials, textures, geometry, lights.

The builder mirrors the responsibilities of the reference's mutable
Scene (reference src/scene.cpp): material registration with override
semantics, a path-keyed texture cache, growing geometry buffers, point
and areal light registration, then a single `commit()` that freezes
everything into device-ready SoA `SceneArrays` (scene/arrays.py) and
builds the BVH.

All assembly is numpy on the host; nothing touches JAX until commit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..io.texture_io import load_texture
from ..utils import log as out
from ..utils.lru import LRU
from . import transforms as xf
from .arrays import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_LTC_BECKMANN,
    BSDF_LTC_BECKMANN_DIFFUSE,
    BSDF_LTC_GGX,
    BSDF_LTC_GGX_DIFFUSE,
    BSDF_MIRROR,
    BSDF_MIX,
    BSDF_NAMES,
    BSDF_TRANSPARENT,
    BVHArrays,
    LightTable,
    MaterialTable,
    SceneArrays,
    SceneMeta,
    TextureAtlas,
    _f32,
    _i32,
)
from .json_utils import ConfigError


def _ltc_rows():
    from ..ops.ltc import _load_tables_np
    return _f32(_load_tables_np())


def build_tri_pack(vertices: np.ndarray, tri_vidx: np.ndarray) -> np.ndarray:
    """Per-triangle Badouel intersection coefficients, [M, 12].

    For triangle (A, B, C) with plane normal n and offset d
    (n = normalize(cross(C-A, B-A)), the reference's winding,
    src/primitives.cpp:24-36), barycentric weights of B and C at a hit
    point p are *affine in p*:
        beta(p)  = b0 + bv . p
        gamma(p) = g0 + gv . p
    computed by solving the 2x2 system on the dominant-axis projection
    (the reference's 2D Badouel test, primitives.cpp:75-166).  This
    turns ray-triangle testing into matmuls over the ray wavefront:
        t     = -(d + ro.n) / (rd.n)
        beta  = b0 + ro.bv + t * (rd.bv)      (and likewise gamma)
    i.e. 6 thin [R,3]x[3,M] products + elementwise masks.
    """
    a = vertices[tri_vidx[:, 0]].astype(np.float64)
    b = vertices[tri_vidx[:, 1]].astype(np.float64)
    c = vertices[tri_vidx[:, 2]].astype(np.float64)
    n = np.cross(c - a, b - a)
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(nl, 1e-30)
    d = -np.sum(n * a, axis=-1)

    # Dominant axis per tri; project the other two.  Pure column
    # selects (no per-element fancy indexing — the gather/scatter
    # form cost ~1.4 s of the 1M-tri commit; i1 in {0,1} and
    # i2 in {1,2}, so two wheres per read and three per write cover
    # every case).
    k = np.argmax(np.abs(n), axis=-1)
    i1 = np.where(k == 0, 1, 0)
    i2 = np.where(k == 2, 1, 2)

    def sel(v, idx):
        return np.where(idx == 0, v[:, 0],
                        np.where(idx == 1, v[:, 1], v[:, 2]))

    a1, a2 = sel(a, i1), sel(a, i2)
    b1 = sel(b, i1) - a1
    b2 = sel(b, i2) - a2
    c1 = sel(c, i1) - a1
    c2 = sel(c, i2) - a2
    denom = b1 * c2 - b2 * c1
    denom = np.where(np.abs(denom) > 1e-30, denom, 1e-30)

    def place(v1, v2):
        """Vector with component i1 = v1, component i2 = v2, rest 0."""
        col0 = np.where(i1 == 0, v1, 0.0)          # i2 is never 0
        col1 = np.where(i1 == 1, v1, np.where(i2 == 1, v2, 0.0))
        col2 = np.where(i2 == 2, v2, 0.0)          # i1 is never 2
        return np.stack([col0, col1, col2], axis=1)

    bv = place(c2 / denom, -c1 / denom)
    gv = place(-b2 / denom, b1 / denom)
    b0 = -(a1 * c2 - a2 * c1) / denom
    g0 = -(a2 * b1 - a1 * b2) / denom

    pack = np.concatenate([
        n, d[:, None], b0[:, None], bv, g0[:, None], gv], axis=1)
    return pack.astype(np.float32)


def append_thinglass_column(pack: np.ndarray, tri_mat: np.ndarray,
                            is_thinglass: np.ndarray) -> np.ndarray:
    """Column 12: 1.0 for triangles of thin-glass materials.

    The reference's thin-glass traversal skips these triangles while
    recording hits for a tint filter that is disabled in live code
    (reference src/path_tracer.cpp ApplyThinglass:97-104 — TODO'd
    out), so behavioral parity = rays and shadow rays pass straight
    through.  The intersectors mask them out when the column is set.
    """
    col = is_thinglass[tri_mat].astype(np.float32)[:, None]
    return np.concatenate([pack, col], axis=1).astype(np.float32)


def phong_exponent_to_roughness(exponent: float) -> float:
    """The reference's Phong-exponent -> LTC roughness map
    (src/bxdf/bxdf.cpp:142-143 and 176-180)."""
    return float(np.sqrt(2.0 / (2.0 + exponent)))


@dataclass
class MaterialSpec:
    """Host-side material description, later packed into MaterialTable."""
    name: str
    bxdf: int = BSDF_DIFFUSE
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    diffuse_tex: int = -1
    specular: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    specular_tex: int = -1
    bump_tex: int = -1
    roughness: float = 0.5
    ior: float = 1.0
    mix_m1: str = ""
    mix_m2: str = ""
    mix_amt: float = 0.5
    no_russian: bool = False
    is_thinglass: bool = False


class SceneBuilder:
    def __init__(self):
        self.materials: List[MaterialSpec] = []
        self.material_index: Dict[str, int] = {}
        self.textures: List[np.ndarray] = []
        self.texture_index: Dict[str, int] = {}

        self.vertices: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tri_vidx: List[np.ndarray] = []
        self.tri_mat: List[np.ndarray] = []
        self._vertex_count = 0
        self._tri_count = 0

        # Areal light groups: (material_index, [triangle indices])
        self.areal_groups: List[tuple] = []

        self.point_lights: List[dict] = []

        self.sky_color = np.zeros(3, np.float32)
        self.sky_intensity = 1.0
        self.sky_rotate = 0.0
        self.sky_tex = -1

        self.thinglass_phrases: List[str] = []

    # ---------------- materials & textures ----------------

    def register_material(self, spec: MaterialSpec, override: bool = False) -> int:
        """Register by name; duplicates are kept or replaced per
        `override` (reference scene.cpp RegisterMaterial:73-94)."""
        if spec.name in self.material_index:
            idx = self.material_index[spec.name]
            if override:
                self.materials[idx] = spec
            return idx
        idx = len(self.materials)
        self.materials.append(spec)
        self.material_index[spec.name] = idx
        return idx

    def material_id(self, name: str) -> int:
        if name not in self.material_index:
            raise ConfigError(f'Material named "{name}" was not defined')
        return self.material_index[name]

    # Decoded-texture LRU shared across SceneBuilder instances: the
    # animation loop (driver/cli.py -r) rebuilds the scene per frame
    # and would otherwise re-decode identical PNGs/JPEGs 250 times.
    # Keyed by (path, mtime); ~64 entries bounds host memory.
    _decoded_lru = LRU(64)

    def get_texture(self, path: str) -> int:
        """Load-once texture cache keyed by path (scene.cpp:252-278)."""
        path = os.path.normpath(path)
        if path in self.texture_index:
            return self.texture_index[path]
        key = (path, os.path.getmtime(path) if os.path.exists(path) else 0)
        img = SceneBuilder._decoded_lru.get(key)
        if img is None:
            img = load_texture(path)
            SceneBuilder._decoded_lru.put(key, img)
        idx = len(self.textures)
        self.textures.append(img)
        self.texture_index[path] = idx
        out.log(5, f"Loaded texture '{path}' {img.shape[1]}x{img.shape[0]}")
        return idx

    # ---------------- geometry ----------------

    def add_soup(self, positions, normals, uvs, tangents, material: str,
                 transform: Optional[np.ndarray] = None,
                 texture_transform: Optional[np.ndarray] = None) -> None:
        """Add an unindexed triangle soup (3 consecutive rows = 1 face).

        Used for built-in primitives (reference scene.cpp AddPrimitive):
        points get the full 4x4, direction attributes the linear part
        (renormalized), uvs the 3x3 texture transform.
        """
        positions = np.asarray(positions, np.float64)
        n = positions.shape[0]
        assert n % 3 == 0
        if transform is not None:
            positions = xf.apply_points(transform, positions)
            normals = xf.apply_vectors(transform, np.asarray(normals, np.float64))
            tangents = xf.apply_vectors(transform, np.asarray(tangents, np.float64))
        uvs = np.asarray(uvs, np.float64)
        if texture_transform is not None:
            uv1 = np.concatenate([uvs, np.ones((n, 1))], axis=1)
            uvs = uv1 @ texture_transform.T
            uvs = uvs[:, :2]
        faces = np.arange(n, dtype=np.int64).reshape(-1, 3)
        self.add_mesh(positions, normals, uvs, tangents, faces, material)

    def add_mesh(self, positions, normals, uvs, tangents, faces,
                 material: str) -> None:
        """Add an indexed mesh with shared-per-vertex attributes."""
        mat_id = self.material_id(material)
        v0 = self._vertex_count
        positions = np.asarray(positions, np.float32)
        nverts = positions.shape[0]
        self.vertices.append(positions)
        self.normals.append(np.asarray(normals, np.float32))
        self.tangents.append(
            np.zeros((nverts, 3), np.float32) if tangents is None
            else np.asarray(tangents, np.float32))
        self.uvs.append(
            np.zeros((nverts, 2), np.float32) if uvs is None
            else np.asarray(uvs, np.float32))
        faces = np.asarray(faces, np.int64) + v0
        nf = faces.shape[0]
        self.tri_vidx.append(faces.astype(np.int32))
        self.tri_mat.append(np.full(nf, mat_id, np.int32))
        self._vertex_count += nverts

        spec = self.materials[mat_id]
        if np.any(spec.emission != 0.0):
            tri_ids = np.arange(self._tri_count, self._tri_count + nf)
            self.areal_groups.append((mat_id, tri_ids))
        self._tri_count += nf

    # ---------------- lights & sky ----------------

    def add_point_light(self, pos, color, intensity: float, size: float = 0.0):
        self.point_lights.append(dict(
            pos=np.asarray(pos, np.float32),
            color=np.asarray(color, np.float32),
            intensity=float(intensity), size=float(size)))

    def set_sky_color(self, color, intensity: float = 1.0) -> None:
        self.sky_color = np.asarray(color, np.float32)
        self.sky_intensity = float(intensity)
        self.sky_tex = -1

    def set_sky_envmap(self, path: str, intensity: float = 1.0,
                       rotate: float = 0.0) -> None:
        self.sky_tex = self.get_texture(path)
        self.sky_intensity = float(intensity)
        self.sky_rotate = float(rotate)

    def make_thinglass_set(self, phrases: List[str]) -> None:
        """Materials whose name contains any phrase become thin-glass
        (reference scene.cpp MakeThinglassSet:659-668)."""
        self.thinglass_phrases = list(phrases)
        for spec in self.materials:
            if any(p in spec.name for p in phrases):
                spec.is_thinglass = True

    # ---------------- commit ----------------

    def commit(self, build_bvh: bool = True, bvh_leaf_size: int = 4,
               bvh_threshold: int = 4096):
        """Freeze to SoA arrays + light tables + BVH.

        Equivalent of Scene::Commit (reference scene.cpp:294-419):
        computes the dynamic epsilon (1e-5 x bbox diameter,
        scene.cpp:390), per-triangle geometric normals, areal light
        power tables, and the acceleration structure.
        """
        if self._tri_count == 0:
            raise ConfigError("cannot commit an empty scene")

        vertices = np.concatenate(self.vertices, axis=0)
        normals = np.concatenate(self.normals, axis=0)
        tangents = np.concatenate(self.tangents, axis=0)
        uvs = np.concatenate(self.uvs, axis=0)
        tri_vidx = np.concatenate(self.tri_vidx, axis=0)
        tri_mat = np.concatenate(self.tri_mat, axis=0)

        # Geometric plane normal per triangle: normalize(cross(C-A, B-A))
        # — the reference's winding convention (primitives.cpp:24-36).
        a = vertices[tri_vidx[:, 0]]
        b = vertices[tri_vidx[:, 1]]
        c = vertices[tri_vidx[:, 2]]
        gn = np.cross(c - a, b - a)
        gl = np.linalg.norm(gn, axis=-1, keepdims=True)
        tri_normal = gn / np.maximum(gl, 1e-20)

        # Bounding box & dynamic epsilon.
        wmin = vertices.min(axis=0)
        wmax = vertices.max(axis=0)
        diameter = float(np.linalg.norm(wmax - wmin))
        epsilon = 1e-5 * diameter
        out.log(3, f"Using dynamic epsilon: {epsilon}")

        materials = self._pack_materials()
        textures = self._pack_textures()
        lights = self._pack_lights(vertices, normals, tri_vidx)

        # Scenes up to a few thousand triangles use the flat sweep
        # (every ray tests every triangle); only larger scenes get the
        # BVH.  The cut-over was tuned on the previous accelerator and
        # is untuned for this one.
        pack_glass = append_thinglass_column(
            build_tri_pack(vertices, tri_vidx), tri_mat,
            np.asarray([m.is_thinglass for m in self.materials], bool))
        has_bvh = build_bvh and self._tri_count > bvh_threshold
        if has_bvh:
            from .bvh import build_bvh as _build
            bvh = _build(vertices, tri_vidx, leaf_size=bvh_leaf_size)
        else:
            bvh = BVHArrays(
                node_min=_f32(np.zeros((1, 3))),
                node_max=_f32(np.zeros((1, 3))),
                node_meta=_i32(np.zeros((1, 3))),
                prim_idx=_i32(np.arange(self._tri_count)),
            )

        # Thin-glass subset for the ordered hit-list query
        # (ops/thinglass.py; reference scene_intersect.cpp:385-399).
        gmask = pack_glass[:, 12] > 0.5
        if gmask.any():
            glass_pack = pack_glass[gmask, :12].astype(np.float32)
            glass_ids = np.nonzero(gmask)[0].astype(np.int32)
        else:
            glass_pack = np.zeros((1, 12), np.float32)
            glass_pack[0, 3] = 1.0  # d=1, n=0: never hits
            glass_ids = np.full((1,), -1, np.int32)

        arrays = SceneArrays(
            vertices=_f32(vertices), normals=_f32(normals),
            tangents=_f32(tangents), uvs=_f32(uvs),
            tri_vidx=_i32(tri_vidx), tri_mat=_i32(tri_mat),
            tri_normal=_f32(tri_normal), tri_pack=_f32(pack_glass),
            tri_meta=_i32(np.concatenate(
                [tri_vidx, tri_mat[:, None]], axis=1)),
            tri_shade=_f32(np.concatenate([
                normals[tri_vidx].reshape(-1, 9),
                uvs[tri_vidx].reshape(-1, 6),
                tangents[tri_vidx].reshape(-1, 9)], axis=1)),
            glass_pack=_f32(glass_pack),
            glass_ids=_i32(glass_ids),
            ltc_rows=_ltc_rows(),
            materials=materials,
            textures=textures,
            lights=lights,
            bvh=bvh,
            sky_color=_f32(self.sky_color),
            sky_intensity=_f32(self.sky_intensity),
            sky_rotate=_f32(self.sky_rotate),
            sky_tex=_i32(self.sky_tex),
            epsilon=_f32(epsilon),
            world_min=_f32(wmin - epsilon),
            world_max=_f32(wmax + epsilon),
        )
        meta = SceneMeta(
            n_triangles=int(self._tri_count),
            n_materials=len(self.materials),
            n_point_lights=len(self.point_lights),
            n_areal_tris=int(arrays.lights.areal_tri.shape[0])
            if float(arrays.lights.total_areal_power) > 0 else 0,
            has_bvh=has_bvh,
            has_textures=len(self.textures) > 0,
            has_thinglass=any(m.is_thinglass for m in self.materials),
            has_mix=any(m.bxdf == BSDF_MIX for m in self.materials),
            has_ltc=any(m.bxdf in (
                BSDF_LTC_BECKMANN, BSDF_LTC_GGX,
                BSDF_LTC_BECKMANN_DIFFUSE, BSDF_LTC_GGX_DIFFUSE)
                for m in self.materials),
            has_envmap=int(arrays.sky_tex) >= 0,
            material_names=tuple(m.name for m in self.materials),
        )
        out.log(2, f"Committed {self._vertex_count} vertices, "
                   f"{self._tri_count} triangles, {len(self.textures)} "
                   f"textures, {len(self.point_lights)} pointlights and "
                   f"{len(self.areal_groups)} areal lights to the scene.")
        return arrays, meta

    def _pack_materials(self) -> MaterialTable:
        n = max(1, len(self.materials))
        mats = self.materials or [MaterialSpec(name="__default")]

        def res_mix(name, self_idx):
            return self.material_index.get(name, self_idx)

        return MaterialTable(
            bxdf_type=_i32([m.bxdf for m in mats]),
            emission=_f32([m.emission for m in mats]),
            diffuse=_f32([m.diffuse for m in mats]),
            diffuse_tex=_i32([m.diffuse_tex for m in mats]),
            specular=_f32([m.specular for m in mats]),
            specular_tex=_i32([m.specular_tex for m in mats]),
            bump_tex=_i32([m.bump_tex for m in mats]),
            roughness=_f32([m.roughness for m in mats]),
            ior=_f32([m.ior for m in mats]),
            mix_m1=_i32([res_mix(m.mix_m1, i) for i, m in enumerate(mats)]),
            mix_m2=_i32([res_mix(m.mix_m2, i) for i, m in enumerate(mats)]),
            mix_amt=_f32([m.mix_amt for m in mats]),
            no_russian=_i32([m.no_russian for m in mats]).astype(bool),
            is_thinglass=_i32([m.is_thinglass for m in mats]).astype(bool),
        )

    def _pack_textures(self) -> TextureAtlas:
        if not self.textures:
            return TextureAtlas(
                texels=_f32(np.zeros((1, 3))), desc=_i32(np.zeros((1, 3))))
        descs, chunks, offset = [], [], 0
        for img in self.textures:
            h, w = img.shape[:2]
            descs.append((offset, w, h))
            chunks.append(img.reshape(-1, 3))
            offset += w * h
        return TextureAtlas(
            texels=_f32(np.concatenate(chunks, axis=0)),
            desc=_i32(np.asarray(descs)),
        )

    def _pack_lights(self, vertices, normals, tri_vidx) -> LightTable:
        # Point lights: power = intensity * 4*pi (scene.cpp:344-347).
        if self.point_lights:
            p_pos = np.stack([l["pos"] for l in self.point_lights])
            p_col = np.stack([l["color"] for l in self.point_lights])
            p_int = np.array([l["intensity"] for l in self.point_lights], np.float32)
            p_size = np.array([l["size"] for l in self.point_lights], np.float32)
            p_pow = p_int * 4.0 * np.pi
        else:
            p_pos = np.zeros((1, 3), np.float32)
            p_col = np.zeros((1, 3), np.float32)
            p_int = np.zeros(1, np.float32)
            p_size = np.zeros(1, np.float32)
            p_pow = np.zeros(1, np.float32)
        total_point = float(p_pow.sum())

        # Areal lights flattened to triangles with weight
        # area * sum(emission) — same joint distribution as the
        # reference's group-then-triangle pick (scene.cpp:686-745).
        a_tri, a_w, a_em = [], [], []
        total_areal = 0.0
        for mat_id, tri_ids in self.areal_groups:
            em = np.asarray(self.materials[mat_id].emission, np.float32)
            em_sum = float(em.sum())
            va = vertices[tri_vidx[tri_ids, 0]]
            vb = vertices[tri_vidx[tri_ids, 1]]
            vc = vertices[tri_vidx[tri_ids, 2]]
            areas = 0.5 * np.linalg.norm(
                np.cross(va - vb, vc - vb), axis=-1)
            w = areas * em_sum
            a_tri.append(tri_ids)
            a_w.append(w)
            a_em.append(np.broadcast_to(em, (len(tri_ids), 3)))
            total_areal += float(w.sum())
        if a_tri:
            a_tri = np.concatenate(a_tri)
            a_w = np.concatenate(a_w)
            a_em = np.concatenate(a_em, axis=0)
        else:
            a_tri = np.zeros(1, np.int32)
            a_w = np.zeros(1, np.float32)
            a_em = np.zeros((1, 3), np.float32)

        # De-indexed rows: vertices + vertex-A shading normal +
        # emission per emissive triangle (scene.cpp:725-745 semantics).
        n_a = a_tri.shape[0]
        a_rows = np.zeros((n_a, 15), np.float32)
        if self._tri_count:
            tidx = np.clip(a_tri, 0, tri_vidx.shape[0] - 1)
            a_rows[:, 0:3] = vertices[tri_vidx[tidx, 0]]
            a_rows[:, 3:6] = vertices[tri_vidx[tidx, 1]]
            a_rows[:, 6:9] = vertices[tri_vidx[tidx, 2]]
            a_rows[:, 9:12] = normals[tri_vidx[tidx, 0]]
        a_rows[:, 12:15] = a_em

        out.log(3, f"Total areal lights power: {total_areal}W")
        out.log(3, f"Total point lights power: {total_point}W")

        return LightTable(
            point_pos=_f32(p_pos),
            point_color=_f32(p_col),
            point_intensity=_f32(p_int),
            point_size=_f32(p_size),
            point_cum=_f32(np.cumsum(p_pow)),
            areal_tri=_i32(a_tri),
            areal_cum=_f32(np.cumsum(a_w)),
            areal_rows=_f32(a_rows),
            total_point_power=_f32(total_point),
            total_areal_power=_f32(total_areal),
        )
