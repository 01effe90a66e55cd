"""Lane-parallel light selection over prefix-sum power tables.

Equivalent of the reference's power-proportional light pick (reference
src/scene.cpp GetRandomLight:686-745): choose point vs areal lights by
total power, then the light within the class — point lights by
intensity*4pi, emissive triangles by area*emission (the flattened
single-searchsorted form of the reference's group-then-triangle walk,
which has the identical joint distribution).

Returned lanes describe one light sample per path:
    kind: 0 = point ("full sphere"), 1 = areal ("hemisphere")
    pos, color, intensity, size, normal, valid
The directional factor matches Light::GetDirectionalFactor
(src/primitives.hpp:39-42).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import vecmath as vm
from . import warps

LIGHT_POINT = 0
LIGHT_AREAL = 1


class LightSample(NamedTuple):
    kind: jnp.ndarray       # int32 [...]
    pos: jnp.ndarray        # f32 [...,3]
    color: jnp.ndarray      # f32 [...,3]
    intensity: jnp.ndarray  # f32 [...]
    size: jnp.ndarray       # f32 [...]
    normal: jnp.ndarray     # f32 [...,3]
    valid: jnp.ndarray      # bool [...]

    def directional_factor(self, v):
        """1 for point lights; max(0, dot(v, normal)) for areal."""
        cos = jnp.maximum(0.0, vm.dot(v, self.normal))
        return jnp.where(self.kind == LIGHT_POINT, 1.0, cos)


def sample_light(scene, choice2, light1, tri2) -> LightSample:
    """Pick one light per lane.

    choice2: f32[...,2] — x picks the class & point light, y the
    emissive triangle; light1: f32[...] (consumed for ledger parity);
    tri2: f32[...,2] — uniform point on the chosen triangle.
    """
    del light1  # dimension consumed but not needed by the flat pick
    lt = scene.lights
    total_point = lt.total_point_power
    total_areal = lt.total_areal_power
    total = total_point + total_areal
    valid = total > 0.0

    q = choice2[..., 0] * total
    choose_point = q < total_point

    # Point pick: q is already uniform on [0, total_point) given the
    # class choice (reference reuses the scaled q, scene.cpp:694-704).
    p_idx = jnp.searchsorted(lt.point_cum, q, side="left")
    p_idx = jnp.clip(p_idx, 0, lt.point_pos.shape[0] - 1).astype(jnp.int32)

    # Areal pick: fresh dimension choice2.y over the flat weights.
    q2 = choice2[..., 1] * total_areal
    a_idx = jnp.searchsorted(lt.areal_cum, q2, side="left")
    a_idx = jnp.clip(a_idx, 0, lt.areal_tri.shape[0] - 1).astype(jnp.int32)

    # Row-packed gathers.  The queued tracer samples the
    # light every bounce iteration, so everything areal comes from ONE
    # de-indexed row fetch (LightTable.areal_rows) rather than an
    # index chain through tri_meta/vertices/normals.
    point_pack = jnp.concatenate([
        lt.point_pos, lt.point_color,
        lt.point_intensity[:, None], lt.point_size[:, None]], axis=1)
    prow = vm.take_rows(point_pack, p_idx)

    arow = vm.take_rows(lt.areal_rows, a_idx)
    a_em = arow[..., 12:15]
    tri_pos = warps.to_triangle_uniform(tri2, arow[..., 0:3],
                                        arow[..., 3:6], arow[..., 6:9])
    # Reference uses vertex A's (shading) normal (scene.cpp:738).
    tri_normal = arow[..., 9:12]

    cp = choose_point[..., None]
    return LightSample(
        kind=jnp.where(choose_point, LIGHT_POINT, LIGHT_AREAL).astype(jnp.int32),
        pos=jnp.where(cp, prow[..., 0:3], tri_pos),
        color=jnp.where(cp, prow[..., 3:6], a_em),
        intensity=jnp.where(choose_point, prow[..., 6], 1.0),
        size=jnp.where(choose_point, prow[..., 7], 0.0),
        normal=jnp.where(cp, vm.safe_normalize(prow[..., 0:3]),
                         tri_normal),
        valid=jnp.broadcast_to(valid, choose_point.shape),
    )


def offset_sphere_light(light: LightSample, areal2):
    """For the main light of a path: spherical lights with size > 0 get
    their position offset by size * uniform-sphere(areal_sample), and
    a cosine emission direction around that offset — reference
    TracePath (src/path_tracer.cpp:337-346).

    Returns (light', emission_dir) — emission_dir feeds the light
    subpath when reverse > 0.
    """
    sdir = warps.to_sphere_uniform(areal2)
    is_point = light.kind == LIGHT_POINT
    new_pos = jnp.where(is_point[..., None],
                        light.pos + light.size[..., None] * sdir,
                        light.pos)
    axis = jnp.where(is_point[..., None], sdir, light.normal)
    new_normal = jnp.where(is_point[..., None], vm.safe_normalize(axis),
                           light.normal)
    return light._replace(pos=new_pos, normal=new_normal)
