"""Thin-glass ordered hit lists + the ApplyThinglass filter.

The reference's fourth traversal mode collects every thin-glass
triangle a ray crosses, in order, while SKIPPING them for occlusion
(reference src/scene_intersect.cpp:330-455, esp. 385-399:
`res.thinglass.push_back(...); continue;`), and ApplyThinglass
(src/path_tracer.cpp:81-108) walks the list in ascending t,
de-duplicating hits within scene epsilon (kd-tree clones of one
triangle) and checking orientation so only ENTERING crossings tint
the radiance.  The tint itself is TODO'd out in the reference's live
code, so pass-through is behavioral parity; `tint=True` enables the
diffuse-color filter the reference's comments describe (our
`tint-thinglass` config extension).

Shape: the glass triangles are a tiny SUBSET (panes), so instead of
threading capped K-lists through the hot any-hit kernels, the hit list
is a SECOND dense sweep over just `scene.glass_pack` — [R, G] planes
with G in the tens, a rounding error next to the main traversal.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import vecmath as vm

_BIG = 3.4e38
_PARALLEL_EPS = 1e-9


def collect_thinglass(scene, ro, rd, t_min, t_max, k_max: int = 4):
    """Ordered thin-glass crossings per ray.

    ro/rd: [R,3]; t_min/t_max: scalars or [R].  Returns (ts [R,K],
    tris [R,K]) sorted by ascending t; tris == -1 marks empty slots.
    K = k_max caps the list (the reference's vector is unbounded; a
    ray crossing more than k_max panes keeps the nearest k_max)."""
    pack = scene.glass_pack                   # [G,12]

    def dot_n(v):                             # [R,G], exact-f32 FMAs
        return (v[:, 0:1] * pack[:, 0][None, :]
                + v[:, 1:2] * pack[:, 1][None, :]
                + v[:, 2:3] * pack[:, 2][None, :])

    rddn = dot_n(rd)
    rodn = dot_n(ro) + pack[:, 3][None, :]
    safe = jnp.abs(rddn) > _PARALLEL_EPS
    t = -rodn / jnp.where(safe, rddn, 1.0)
    # beta/gamma affine in the hit point: evaluate via ro + t*rd.
    px = ro[:, 0:1] + t * rd[:, 0:1]
    py = ro[:, 1:2] + t * rd[:, 1:2]
    pz = ro[:, 2:3] + t * rd[:, 2:3]
    beta = (pack[:, 4][None, :] + px * pack[:, 5][None, :]
            + py * pack[:, 6][None, :] + pz * pack[:, 7][None, :])
    gamma = (pack[:, 8][None, :] + px * pack[:, 9][None, :]
             + py * pack[:, 10][None, :] + pz * pack[:, 11][None, :])
    t_min_b = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    t_max_b = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max
    ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > t_min_b) & (t < t_max_b))
    t = jnp.where(ok, t, _BIG)

    ids = scene.glass_ids
    ts, tris = [], []
    cur = jnp.full(t.shape[:1], -jnp.inf)
    for _ in range(k_max):
        tk = jnp.min(jnp.where(t > cur[:, None], t, _BIG), axis=1)
        ik = jnp.argmin(jnp.where(t > cur[:, None], t, _BIG),
                        axis=1).astype(jnp.int32)
        found = tk < _BIG
        ts.append(jnp.where(found, tk, _BIG))
        tris.append(jnp.where(found, ids[ik], -1))
        cur = jnp.where(found, tk, cur)
    return jnp.stack(ts, axis=1), jnp.stack(tris, axis=1)


def apply_thinglass(scene, radiance, ts, tris, rd, tint: bool = False):
    """The reference's ApplyThinglass (src/path_tracer.cpp:81-108):
    walk the crossings in ascending t, skip repeats within scene
    epsilon, and on each ENTERING crossing (dot(N, rd) >= 0 with the
    triangle's generic normal) multiply by the material's diffuse
    color — IF `tint` is set; the reference ships with the tint
    disabled, so the default is an exact pass-through that still
    exercises the dedupe/orientation walk."""
    eps = scene.epsilon
    ct = jnp.full(ts.shape[:1], -1.0)
    out = radiance
    for k in range(ts.shape[1]):
        tk = ts[:, k]
        trik = tris[:, k]
        valid = (trik >= 0) & (tk > ct + eps)
        ct = jnp.where(trik >= 0, jnp.where(valid, tk, ct), ct)
        n = scene.tri_normal[jnp.clip(trik, 0, None)]
        entering = vm.dot(n, rd) >= 0.0
        if tint:
            mat = scene.tri_meta[jnp.clip(trik, 0, None), 3]
            color = scene.materials.diffuse[mat]
            out = jnp.where((valid & entering)[..., None],
                            out * color, out)
        # tint disabled: the walk's state (ct) still advances, and
        # the radiance passes through unchanged — live-code parity.
    return out
