"""Ray-scene intersection: flat sweep and BVH traversal.

Replaces the reference's kd-tree traversal kernels (reference
src/scene_intersect.cpp) with two plain-JAX intersectors, which are
the CPU path and the oracles of the GPU kernels in
ops/triton_intersect.py:

* `intersect_brute` — the whole-scene sweep in *affine form*:
  per-triangle Badouel coefficients (scene/builder.build_tri_pack)
  make hit t and both barycentrics affine in (ro, t*rd), so the test
  is elementwise FMAs over [R, M] plus a masked argmin.
* `intersect_bvh` — stackless skip-link traversal of the flattened
  BVH (scene/bvh.py) inside a `lax.while_loop`; leaves evaluate the
  same Badouel coefficients gathered per lane.

`make_intersector` picks the intersector for a scene and a platform.

Both support the reference's self-intersection avoidance (`exclude` =
index of the triangle the ray starts on, scene_intersect.cpp
FindIntersectKdOtherThan) and an any-hit mode for shadow rays.

Hit records are (t, tri_idx, bary_b, bary_c); barycentric weight of
vertex A = 1 - b - c (matching the reference's Intersection fields,
src/primitives.hpp:98-109).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import vecmath as vm

# Plain float, NOT jnp.float32: a module-level concrete array would
# initialize the JAX backend at import time, breaking later platform
# selection (e.g. the CLI's --cpu).
BIG = 3.4e38
_PARALLEL_EPS = 1e-9


class Hit(NamedTuple):
    t: jnp.ndarray        # f32 [...]; BIG when no hit
    tri: jnp.ndarray      # int32 [...]; -1 when no hit
    bary_b: jnp.ndarray   # f32 [...]
    bary_c: jnp.ndarray   # f32 [...]

    @property
    def valid(self):
        return self.tri >= 0


def intersect_brute(scene, ro, rd, t_min, t_max, exclude=None,
                    any_hit: bool = False) -> Hit:
    """Closest hit over all triangles, as elementwise FMAs.

    ro, rd: [R,3]; t_min/t_max: scalars or [R]; exclude: int32 [R] or
    None.  `any_hit` is accepted for interface parity and ignored: the
    closest hit is also a witness.  Same arithmetic, in the same
    order, as `_pack_test`.
    """
    pack = scene.tri_pack                     # [M,12|13]

    def col(j):
        return pack[:, j][None, :]            # [1,M]

    def dot3(v, j):                           # v . pack[:, j:j+3]
        return (v[:, 0:1] * col(j) + v[:, 1:2] * col(j + 1)
                + v[:, 2:3] * col(j + 2))

    rddn = dot3(rd, 0)                                    # [R,M]
    safe = jnp.abs(rddn) > _PARALLEL_EPS
    t = -(dot3(ro, 0) + col(3)) / jnp.where(safe, rddn, 1.0)
    px = ro[:, 0:1] + t * rd[:, 0:1]
    py = ro[:, 1:2] + t * rd[:, 1:2]
    pz = ro[:, 2:3] + t * rd[:, 2:3]
    beta = col(4) + (px * col(5) + py * col(6) + pz * col(7))
    gamma = col(8) + (px * col(9) + py * col(10) + pz * col(11))

    t_min_b = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    t_max_b = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max
    ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > t_min_b) & (t < t_max_b))
    if pack.shape[1] > 12:
        # Thin-glass triangles never block (see builder
        # append_thinglass_column).
        ok = ok & (col(12) < 0.5)
    if exclude is not None:
        m = jnp.arange(pack.shape[0], dtype=jnp.int32)[None, :]
        ok = ok & (m != exclude[:, None])

    t = jnp.where(ok, t, BIG)
    # The winner's barycentrics by masked reductions over the
    # computed planes, which XLA fuses with their producers.
    best_t = jnp.min(t, axis=1)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    onehot = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == idx[:, None]
    found = best_t < BIG
    return Hit(
        t=best_t,
        tri=jnp.where(found, idx, -1),
        bary_b=jnp.where(found,
                         jnp.sum(jnp.where(onehot, beta, 0.0), axis=1), 0.0),
        bary_c=jnp.where(found,
                         jnp.sum(jnp.where(onehot, gamma, 0.0), axis=1), 0.0),
    )


def _pack_test(pack_rows, ro, rd, t_min, t_max):
    """Badouel test for per-lane gathered coefficient rows [...,12]."""
    n = pack_rows[..., 0:3]
    d = pack_rows[..., 3]
    rddn = vm.dot(rd, n)
    safe = jnp.abs(rddn) > _PARALLEL_EPS
    t = -(vm.dot(ro, n) + d) / jnp.where(safe, rddn, 1.0)
    p = ro + t[..., None] * rd
    beta = pack_rows[..., 4] + vm.dot(p, pack_rows[..., 5:8])
    gamma = pack_rows[..., 8] + vm.dot(p, pack_rows[..., 9:12])
    ok = (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > t_min) & (t < t_max))
    if pack_rows.shape[-1] > 12:
        ok = ok & (pack_rows[..., 12] < 0.5)
    return ok, t, beta, gamma


def intersect_bvh(scene, ro, rd, t_min, t_max, exclude=None,
                  any_hit: bool = False, leaf_size: int = 4) -> Hit:
    """Stackless skip-link BVH traversal in a lax.while_loop.

    Node layout (scene/bvh.py): depth-first order; `meta = (first,
    count, skip)`.  Inner nodes have count == 0 and `first` = index of
    the left child; `skip` = node to jump to when the subtree is
    culled.  Every lane walks its own cursor — no per-lane stack
    memory, so live state is 2 int32 + the hit record per lane
    regardless of tree depth.
    """
    # Traversal is non-differentiable by design (SURVEY §7.6: fixed
    # hit geometry, stop-gradient through Hit): detach the ray inputs
    # so reverse-mode AD treats the while_loop as a constant instead
    # of failing on its dynamic trip count.  Hit geometry depends
    # only on scene GEOMETRY, never on the trainable material/light/
    # texture parameters, so FD gradients still match.
    ro = jax.lax.stop_gradient(ro)
    rd = jax.lax.stop_gradient(rd)
    t_min = jax.lax.stop_gradient(t_min)
    t_max = jax.lax.stop_gradient(t_max)

    node_min = scene.bvh.node_min
    node_max = scene.bvh.node_max
    node_meta = scene.bvh.node_meta
    prim_idx = scene.bvh.prim_idx
    pack = scene.tri_pack

    n_nodes = node_meta.shape[0]
    R = ro.shape[0]

    inv_d = 1.0 / jnp.where(jnp.abs(rd) > 1e-20, rd,
                            jnp.where(rd >= 0, 1e-20, -1e-20))

    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    if exclude is None:
        exclude = jnp.full((R,), -1, jnp.int32)

    def slab(node, best_t):
        bmin = node_min[node]
        bmax = node_max[node]
        t0 = (bmin - ro) * inv_d
        t1 = (bmax - ro) * inv_d
        tn = jnp.minimum(t0, t1).max(axis=-1)
        tf = jnp.maximum(t0, t1).min(axis=-1)
        return (tf >= tn) & (tf >= t_min) & (tn <= jnp.minimum(best_t, t_max))

    def leaf_test(node, active, state):
        best_t, best_tri, bb, bc = state
        first = node_meta[node, 0]
        count = node_meta[node, 1]
        for k in range(leaf_size):
            slot = jnp.clip(first + k, 0, prim_idx.shape[0] - 1)
            pid = prim_idx[slot]
            ok, t, beta, gamma = _pack_test(pack[pid], ro, rd, t_min,
                                            jnp.minimum(best_t, t_max))
            ok = ok & active & (k < count) & (pid != exclude)
            best_tri = jnp.where(ok, pid, best_tri)
            bb = jnp.where(ok, beta, bb)
            bc = jnp.where(ok, gamma, bc)
            best_t = jnp.where(ok, t, best_t)
        return best_t, best_tri, bb, bc

    def cond(state):
        node, _, _, _, _, done = state
        return jnp.any(~done)

    def body(state):
        node, best_t, best_tri, bb, bc, done = state
        nodec = jnp.clip(node, 0, n_nodes - 1)
        active = ~done
        count = node_meta[nodec, 1]
        hit_box = slab(nodec, best_t) & active
        is_leaf = (count > 0) & hit_box

        best_t, best_tri, bb, bc = leaf_test(
            nodec, is_leaf, (best_t, best_tri, bb, bc))

        descend = hit_box & (count == 0)
        nxt = jnp.where(descend, node_meta[nodec, 0], node_meta[nodec, 2])
        nxt = jnp.where(active, nxt, node)
        done2 = done | (nxt >= n_nodes)
        if any_hit:
            done2 = done2 | (best_tri >= 0)
        return nxt, best_t, best_tri, bb, bc, done2

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.broadcast_to(BIG, (R,)),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), bool),
    )
    # Under shard_map the loop carry varies over the mesh axes the rays
    # vary over from the first iteration on; so must its initial value.
    vma = tuple(jax.typeof(ro).vma)
    if vma:
        init = jax.lax.pcast(init, vma, to="varying")
    _, best_t, best_tri, bb, bc, _ = jax.lax.while_loop(cond, body, init)
    found = best_tri >= 0
    return Hit(t=jnp.where(found, best_t, BIG), tri=best_tri,
               bary_b=bb, bary_c=bc)


def make_intersector(meta):
    """The intersection routine for a committed scene.

    BVH scenes traverse the tree, flat scenes sweep every triangle.
    The implementation follows the platform the computation is lowered
    for: the plain-JAX intersector on the CPU, the Pallas kernel of
    ops/triton_intersect.py on CUDA, and a lowering error anywhere
    else.  Hits carry no gradient on either path: the ray inputs are
    detached (SURVEY §7.6).
    """
    from . import triton_intersect as tk

    if meta.has_bvh:
        plain, kernel = intersect_bvh, tk.traverse
    else:
        plain, kernel = intersect_brute, tk.sweep

    def intersect(scene, ro, rd, t_min, t_max, exclude=None,
                  any_hit=False):
        ro, rd, t_min, t_max = jax.lax.stop_gradient(
            (ro, rd, jnp.asarray(t_min, jnp.float32),
             jnp.asarray(t_max, jnp.float32)))
        return jax.lax.platform_dependent(
            scene, ro, rd, t_min, t_max, exclude,
            cpu=partial(plain, any_hit=any_hit),
            cuda=partial(kernel, any_hit=any_hit))

    return intersect


def visibility(scene, intersect_fn, a, b, eps_mult: float = 20.0,
               active=None):
    """Mutual visibility of points a, b: occluded iff any hit in
    (eps*20, |b-a| - eps*20) — reference Scene::Visibility
    (src/scene.cpp:670-673).

    `active` (optional bool [R]) marks lanes whose result is consumed;
    inactive lanes get an empty interval, so the kernels retire them
    at once instead of tracing garbage shade points.

    The ray is traced FROM b TO a (surface point toward the light for
    NEE): occluders cluster near the surface end, where an any-hit
    search can stop early (the reference's Visibility traces
    light->point, scene.cpp:670-673, but the predicate is symmetric —
    only the interval ends are epsilon-trimmed)."""
    d = a - b
    dist = vm.length(d)
    rd = d / dist[..., None]
    eps = scene.epsilon * eps_mult
    t_far = dist - eps
    if active is not None:
        t_far = jnp.where(active, t_far, -1.0)
    hit = intersect_fn(scene, b, rd, eps, t_far, any_hit=True)
    return ~hit.valid
