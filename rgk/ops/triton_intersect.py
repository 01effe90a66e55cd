"""Ray-triangle intersection kernels for NVIDIA GPUs (Pallas on Triton).

Two kernels, one per scene structure, each a drop-in for its plain-JAX
oracle in ops/intersect.py (same arguments, same `Hit`):

* `sweep` — flat scenes (no BVH).  Each program holds `BLOCK` rays in
  registers and loops over every triangle's Badouel row, keeping the
  running (t, tri, b, c) in registers.  It writes only the hit record,
  where the plain sweep (`intersect_brute`) streams [R, M] planes.
* `traverse` — BVH scenes.  Each program walks its own rays through
  the skip-link BVH (scene/bvh.py) in an in-kernel loop that ends when
  the block's slowest ray is done: one launch per wavefront where the
  plain traversal (`intersect_bvh`) runs one XLA loop step, several
  launches and a host-visible predicate per visited node.  Node, leaf
  and triangle rows are gathered per lane with masked loads, so lanes
  that are not in a leaf read no triangle rows.

Both evaluate the same Badouel arithmetic as their oracles, in the
same order, and break exact-t ties toward the lowest triangle slot
(strict `<`), as the oracles do.

Hits carry no gradient: inputs are detached (SURVEY §7.6: fixed hit
geometry, stop-gradient through Hit).

There is no CPU lowering for these kernels; ops/intersect.py chooses
them only when the computation is lowered for CUDA.  Tests run them
with `interpret=True`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import BIG, Hit, _PARALLEL_EPS

# Rays per program: one per thread of a 4-warp program.
BLOCK = 128
NUM_WARPS = 4


def _badouel(row, ro, rd):
    """(t, beta, gamma, safe) of one Badouel row for a block of rays.

    row: 12 coefficient values (scalars or [BLOCK] vectors); ro/rd:
    3-tuples of [BLOCK] vectors.  Same operation order as
    intersect._pack_test."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    nx, ny, nz, d = row[0], row[1], row[2], row[3]
    rddn = rdx * nx + rdy * ny + rdz * nz
    safe = jnp.abs(rddn) > _PARALLEL_EPS
    t = -((rox * nx + roy * ny + roz * nz) + d) / jnp.where(safe, rddn, 1.0)
    px = rox + t * rdx
    py = roy + t * rdy
    pz = roz + t * rdz
    beta = row[4] + (px * row[5] + py * row[6] + pz * row[7])
    gamma = row[8] + (px * row[9] + py * row[10] + pz * row[11])
    return t, beta, gamma, safe


def _accept(t, beta, gamma, safe, t_min, t_max):
    return (safe & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
            & (t > t_min) & (t < t_max))


def _sweep_kernel(pack_ref, rox_ref, roy_ref, roz_ref, rdx_ref, rdy_ref,
                  rdz_ref, tmin_ref, tmax_ref, excl_ref,
                  t_ref, tri_ref, b_ref, c_ref, *, n_tris, ncol, any_hit):
    ro = (rox_ref[...], roy_ref[...], roz_ref[...])
    rd = (rdx_ref[...], rdy_ref[...], rdz_ref[...])
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]
    excl = excl_ref[...]

    def test(j, state):
        best_t, best_tri, bb, bc = state
        base = j * ncol
        row = [pack_ref[base + k] for k in range(12)]
        t, beta, gamma, safe = _badouel(row, ro, rd)
        ok = _accept(t, beta, gamma, safe, t_min,
                     jnp.minimum(best_t, t_max)) & (excl != j)
        if ncol > 12:
            ok = ok & (pack_ref[base + 12] < 0.5)
        return (jnp.where(ok, t, best_t), jnp.where(ok, j, best_tri),
                jnp.where(ok, beta, bb), jnp.where(ok, gamma, bc))

    state = (jnp.full((BLOCK,), BIG, jnp.float32),
             jnp.full((BLOCK,), -1, jnp.int32),
             jnp.zeros((BLOCK,), jnp.float32),
             jnp.zeros((BLOCK,), jnp.float32))
    if any_hit:
        # Stop once every ray of the block with a non-empty window has
        # a witness.
        live = t_max > t_min

        def cond(carry):
            j, st = carry
            return (j < n_tris) & (jnp.min(jnp.where(live, st[1], 0)) < 0)

        def body(carry):
            j, st = carry
            return j + 1, test(j, st)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    else:
        state = jax.lax.fori_loop(0, n_tris, test, state)
    best_t, best_tri, bb, bc = state
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    b_ref[...] = bb
    c_ref[...] = bc


def _traverse_kernel(nmin_ref, nmax_ref, meta_ref, prim_ref, pack_ref,
                     rox_ref, roy_ref, roz_ref, rdx_ref, rdy_ref, rdz_ref,
                     tmin_ref, tmax_ref, excl_ref,
                     t_ref, tri_ref, b_ref, c_ref, *, n_nodes, n_prims,
                     ncol, leaf_size, any_hit):
    ro = (rox_ref[...], roy_ref[...], roz_ref[...])
    rd = (rdx_ref[...], rdy_ref[...], rdz_ref[...])
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]
    excl = excl_ref[...]
    inv_d = [1.0 / jnp.where(jnp.abs(v) > 1e-20, v,
                             jnp.where(v >= 0, 1e-20, -1e-20)) for v in rd]

    def gather(ref, idx, mask, other):
        return plgpu.load(ref.at[idx], mask=mask, other=other)

    def body(state):
        node, best_t, best_tri, bb, bc, done = state
        active = ~done
        nodec = jnp.clip(node, 0, n_nodes - 1)
        t_near = jnp.full((BLOCK,), -BIG, jnp.float32)
        t_far = jnp.full((BLOCK,), BIG, jnp.float32)
        for k in range(3):
            lo = (gather(nmin_ref, nodec * 3 + k, active, 0.0)
                  - ro[k]) * inv_d[k]
            hi = (gather(nmax_ref, nodec * 3 + k, active, 0.0)
                  - ro[k]) * inv_d[k]
            t_near = jnp.maximum(t_near, jnp.minimum(lo, hi))
            t_far = jnp.minimum(t_far, jnp.maximum(lo, hi))
        first = gather(meta_ref, nodec * 3, active, 0)
        count = gather(meta_ref, nodec * 3 + 1, active, 0)
        skip = gather(meta_ref, nodec * 3 + 2, active, n_nodes)
        hit_box = (active & (t_far >= t_near) & (t_far >= t_min)
                   & (t_near <= jnp.minimum(best_t, t_max)))
        is_leaf = hit_box & (count > 0)
        for k in range(leaf_size):
            in_leaf = is_leaf & (k < count)
            slot = jnp.clip(first + k, 0, n_prims - 1)
            pid = gather(prim_ref, slot, in_leaf, 0)
            row = [gather(pack_ref, pid * ncol + c, in_leaf, 0.0)
                   for c in range(12)]
            t, beta, gamma, safe = _badouel(row, ro, rd)
            ok = (_accept(t, beta, gamma, safe, t_min,
                          jnp.minimum(best_t, t_max))
                  & in_leaf & (pid != excl))
            if ncol > 12:
                ok = ok & (gather(pack_ref, pid * ncol + 12, in_leaf, 1.0)
                           < 0.5)
            best_tri = jnp.where(ok, pid, best_tri)
            bb = jnp.where(ok, beta, bb)
            bc = jnp.where(ok, gamma, bc)
            best_t = jnp.where(ok, t, best_t)
        descend = hit_box & (count == 0)
        nxt = jnp.where(descend, first, skip)
        nxt = jnp.where(active, nxt, node)
        done = done | (nxt >= n_nodes)
        if any_hit:
            done = done | (best_tri >= 0)
        return nxt, best_t, best_tri, bb, bc, done

    def cond(state):
        return jnp.min(state[5].astype(jnp.int32)) == 0

    init = (jnp.zeros((BLOCK,), jnp.int32),
            jnp.full((BLOCK,), BIG, jnp.float32),
            jnp.full((BLOCK,), -1, jnp.int32),
            jnp.zeros((BLOCK,), jnp.float32),
            jnp.zeros((BLOCK,), jnp.float32),
            ~(t_max > t_min))
    _, best_t, best_tri, bb, bc, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    b_ref[...] = bb
    c_ref[...] = bc


def _lanes(ro, rd, t_min, t_max, exclude):
    """Detached, block-padded per-component ray arrays.

    Padding lanes get an empty [t_min, t_max] window, so they finish
    at once and report no hit."""
    R = ro.shape[0]
    rp = -(-R // BLOCK) * BLOCK
    ro = jax.lax.stop_gradient(ro)
    rd = jax.lax.stop_gradient(rd)
    t_min = jnp.broadcast_to(
        jax.lax.stop_gradient(jnp.asarray(t_min, jnp.float32)), (R,))
    t_max = jnp.broadcast_to(
        jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32)), (R,))
    if exclude is None:
        exclude = jnp.full((R,), -1, jnp.int32)

    def pad(a, value=0):
        return jnp.pad(a, (0, rp - R), constant_values=value)

    comps = [pad(ro[:, k]) for k in range(3)] + [pad(rd[:, k])
                                                  for k in range(3)]
    return R, rp, comps + [pad(t_min), pad(t_max, -1.0),
                           pad(exclude.astype(jnp.int32), -1)]


def _call(kernel, tables, lanes, rp, interpret):
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    # Under shard_map the outputs vary over the mesh axes the inputs
    # vary over.
    vma = frozenset().union(*(jax.typeof(a).vma for a in tables + lanes))
    f32 = jax.ShapeDtypeStruct((rp,), jnp.float32, vma=vma)
    i32 = jax.ShapeDtypeStruct((rp,), jnp.int32, vma=vma)
    return pl.pallas_call(
        kernel,
        grid=(rp // BLOCK,),
        in_specs=[table_spec] * len(tables) + [lane_spec] * len(lanes),
        out_specs=(lane_spec,) * 4,
        out_shape=(f32, i32, f32, f32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
    )(*tables, *lanes)


def _hit(out, R):
    t, tri, bb, bc = (a[:R] for a in out)
    found = tri >= 0
    return Hit(t=jnp.where(found, t, BIG), tri=tri,
               bary_b=jnp.where(found, bb, 0.0),
               bary_c=jnp.where(found, bc, 0.0))


def sweep(scene, ro, rd, t_min, t_max, exclude=None, any_hit=False,
          interpret=False) -> Hit:
    """Flat-scene intersector: every ray against every triangle of
    `scene.tri_pack`.  With `any_hit`, a block stops at the first
    triangle that gives each of its rays a hit, and the hit returned
    is a witness, not the closest."""
    pack = jax.lax.stop_gradient(scene.tri_pack)
    R, rp, lanes = _lanes(ro, rd, t_min, t_max, exclude)
    kernel = partial(_sweep_kernel, n_tris=pack.shape[0],
                     ncol=pack.shape[1], any_hit=bool(any_hit))
    return _hit(_call(kernel, [pack.reshape(-1)], lanes, rp, interpret), R)


def traverse(scene, ro, rd, t_min, t_max, exclude=None, any_hit=False,
             leaf_size: int = 4, interpret=False) -> Hit:
    """BVH-scene intersector over `scene.bvh` (layout: scene/bvh.py).
    With `any_hit`, a ray stops at its first accepted triangle."""
    bvh = jax.lax.stop_gradient(scene.bvh)
    pack = jax.lax.stop_gradient(scene.tri_pack)
    R, rp, lanes = _lanes(ro, rd, t_min, t_max, exclude)
    kernel = partial(_traverse_kernel, n_nodes=bvh.node_meta.shape[0],
                     n_prims=bvh.prim_idx.shape[0], ncol=pack.shape[1],
                     leaf_size=leaf_size, any_hit=bool(any_hit))
    tables = [bvh.node_min.reshape(-1), bvh.node_max.reshape(-1),
              bvh.node_meta.reshape(-1), bvh.prim_idx, pack.reshape(-1)]
    return _hit(_call(kernel, tables, lanes, rp, interpret), R)
