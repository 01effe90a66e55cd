"""Host-side BVH construction (binned SAH) + skip-link flattening.

The replacement for the reference's SAH kd-tree build
(reference src/scene.cpp UncompressedKdNode::Subdivide +
CompressedKdNode flattening): we build a 2-wide BVH with binned SAH
(16 bins), then flatten depth-first with *skip links* so device
traversal needs no per-lane stack at all (ops/intersect.py,
ops/triton_intersect.py).

The flat layout per node i:
    node_min[i], node_max[i] : AABB
    meta[i] = (first, count, skip)
      leaf:  first = offset into prim_idx, count = #prims (>0)
      inner: first = left child index (== i+1), count = 0
      skip  : next node in DFS order when this subtree is done/culled;
              the root's rightmost path ends at skip == n_nodes.

An optional native C++ builder (rgk/native) is used when available
— same algorithm, ~20x faster for multi-million-triangle scenes; the
numpy path is the always-available fallback and the test oracle.
"""

from __future__ import annotations

import numpy as np

from ..utils import log as out
from .arrays import BVHArrays, _f32, _i32

N_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 2.0


def _build_numpy(centroids, prim_min, prim_max, leaf_size):
    """Iterative binned-SAH build; returns (nodes list, prim order).

    nodes: list of (bbmin, bbmax, first, count, left) where leaves have
    count > 0 and inner nodes carry left-child placeholders patched
    during emission.
    """
    n = centroids.shape[0]
    order = np.arange(n)

    # Each stack entry: (start, end, node_slot); nodes appended in DFS
    # pre-order so left child == parent+1 automatically.
    nodes_min, nodes_max, nodes_first, nodes_count = [], [], [], []
    nodes_skip_patch = []  # indices of nodes awaiting right-child info

    # We emit DFS pre-order by processing a stack of ranges; to get
    # pre-order we must process left before right, with the node row
    # reserved before its children.
    stack = [(0, n, -1, False)]  # (start, end, parent_row, is_right)
    parent_right_child = {}

    while stack:
        start, end, parent_row, is_right = stack.pop()
        row = len(nodes_min)
        if parent_row >= 0 and is_right:
            parent_right_child[parent_row] = row

        bbmin = prim_min[order[start:end]].min(axis=0)
        bbmax = prim_max[order[start:end]].max(axis=0)
        count = end - start

        if count <= leaf_size:
            nodes_min.append(bbmin)
            nodes_max.append(bbmax)
            nodes_first.append(start)
            nodes_count.append(count)
            continue

        # Binned SAH over centroid extent, best of 3 axes.
        cmin = centroids[order[start:end]].min(axis=0)
        cmax = centroids[order[start:end]].max(axis=0)
        extent = cmax - cmin
        best = None
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            c = centroids[order[start:end], axis]
            bins = np.minimum(
                ((c - cmin[axis]) / extent[axis] * N_BINS).astype(np.int32),
                N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            # Per-bin bounds
            bmin = np.full((N_BINS, 3), np.inf)
            bmax = np.full((N_BINS, 3), -np.inf)
            pm = prim_min[order[start:end]]
            px = prim_max[order[start:end]]
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bmin[b] = pm[sel].min(axis=0)
                    bmax[b] = px[sel].max(axis=0)
            # Sweep: left/right cumulative surface areas
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
                    + d[..., 2] * d[..., 0]

            cost = (area(lmin[:-1], lmax[:-1]) * lcount[:-1]
                    + area(rmin[1:], rmax[1:]) * rcount[1:])
            cost = np.where((lcount[:-1] == 0) | (rcount[1:] == 0),
                            np.inf, cost)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (cost[k], axis, k, bins)

        if best is None:
            # Degenerate: all centroids coincide — median split.
            mid = start + count // 2
        else:
            _, axis, k, bins = best
            sel = bins <= k
            seg = order[start:end]
            order[start:end] = np.concatenate([seg[sel], seg[~sel]])
            mid = start + int(sel.sum())
            if mid == start or mid == end:
                mid = start + count // 2

        nodes_min.append(bbmin)
        nodes_max.append(bbmax)
        nodes_first.append(-1)  # patched to left child (row+1)
        nodes_count.append(0)
        # DFS pre-order: push right first so left pops first.
        stack.append((mid, end, row, True))
        stack.append((start, mid, row, False))

    n_nodes = len(nodes_min)
    first = np.asarray(nodes_first, np.int64)
    count = np.asarray(nodes_count, np.int64)
    right = np.full(n_nodes, -1, np.int64)
    for parent, rc in parent_right_child.items():
        right[parent] = rc
    # Inner nodes: left child is the next row in pre-order.
    inner = count == 0
    first[inner] = np.nonzero(inner)[0] + 1

    # Skip links: skip(root)=n_nodes; skip(left)=right sibling;
    # skip(right)=skip(parent).  Computed in DFS order.
    skip = np.full(n_nodes, n_nodes, np.int64)
    stack2 = [(0, n_nodes)]
    while stack2:
        row, s = stack2.pop()
        skip[row] = s
        if count[row] == 0:
            left, rc = first[row], right[row]
            stack2.append((left, rc))
            stack2.append((rc, s))

    return (np.asarray(nodes_min, np.float32),
            np.asarray(nodes_max, np.float32),
            first, count, skip, order)


def build_bvh(vertices: np.ndarray, tri_vidx: np.ndarray,
              leaf_size: int = 4) -> BVHArrays:
    """Build the flattened BVH for a committed triangle soup."""
    a = vertices[tri_vidx[:, 0]]
    b = vertices[tri_vidx[:, 1]]
    c = vertices[tri_vidx[:, 2]]
    prim_min = np.minimum(np.minimum(a, b), c)
    prim_max = np.maximum(np.maximum(a, b), c)
    centroids = (prim_min + prim_max) * 0.5

    builder = _load_native_builder()
    if builder is not None:
        result = builder(centroids, prim_min, prim_max, leaf_size)
    else:
        result = _build_numpy(centroids, prim_min, prim_max, leaf_size)
    node_min, node_max, first, count, skip, order = result

    out.log(3, f"BVH: {len(first)} nodes over {len(order)} triangles "
               f"(leaf size {leaf_size})")
    meta = np.stack([first, count, skip], axis=1).astype(np.int32)
    return BVHArrays(
        node_min=_f32(node_min),
        node_max=_f32(node_max),
        node_meta=_i32(meta),
        prim_idx=_i32(order),
    )


def _load_native_builder():
    """ctypes hook for the C++ builder (rgk/native); None if the
    shared library hasn't been built."""
    try:
        from ..native.bvh_native import build_binned_sah
        return build_binned_sah
    except Exception:
        return None
