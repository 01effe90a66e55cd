"""Native C++ BVH builder vs the numpy oracle."""

import time

import numpy as np
import pytest

from rgk.scene.bvh import _build_numpy


def _soup(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3))
    offs = rng.normal(0, 0.5, (n, 3, 3))
    v = (centers[:, None] + offs).reshape(-1, 3).astype(np.float32)
    tri = np.arange(3 * n).reshape(-1, 3)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    pmin = np.minimum(np.minimum(a, b), c)
    pmax = np.maximum(np.maximum(a, b), c)
    return (pmin + pmax) * 0.5, pmin, pmax


@pytest.fixture(scope="module")
def native():
    from rgk.native.bvh_native import build_binned_sah, _load
    if _load() is None:
        pytest.skip("no C++ compiler for native BVH")
    return build_binned_sah


def test_native_matches_layout_invariants(native):
    cen, pmin, pmax = _soup(5000, seed=1)
    nm, nx, first, count, skip, order = native(cen, pmin, pmax, 4)
    n_nodes = len(first)
    assert sorted(order.tolist()) == list(range(5000))
    leaves = count > 0
    # Every primitive appears in exactly one leaf range.
    covered = np.zeros(5000, bool)
    for f, c in zip(first[leaves], count[leaves]):
        covered[order[f:f + c]] = True
        assert c <= 4
    assert covered.all()
    # Inner nodes point at the next row (DFS pre-order).
    inner = ~leaves
    rows = np.nonzero(inner)[0]
    assert np.array_equal(first[rows], rows + 1)
    # Skip links are strictly forward and within bounds.
    assert (skip > np.arange(n_nodes)).all()
    assert (skip <= n_nodes).all()
    # Child boxes nest within parents.
    for row in rows[:200]:
        l = first[row]
        assert (nm[row] <= nm[l] + 1e-6).all()
        assert (nx[row] >= nx[l] - 1e-6).all()


def test_native_traversal_equivalence(native):
    """Device traversal over the native-built tree matches brute."""
    import jax.numpy as jnp

    from rgk.ops.intersect import intersect_brute, intersect_bvh
    from rgk.scene.arrays import BVHArrays, _f32, _i32
    from rgk.scene.builder import build_tri_pack

    cen, pmin, pmax = _soup(800, seed=2)
    rng = np.random.default_rng(3)
    v = np.empty((2400, 3), np.float32)
    # rebuild the soup's vertices deterministically
    centers = np.random.default_rng(2).uniform(-10, 10, (800, 3))
    offs = np.random.default_rng(2).normal(0, 0.5, (800, 3, 3))
    # regenerate identically to _soup(seed=2)
    rng2 = np.random.default_rng(2)
    centers = rng2.uniform(-10, 10, (800, 3))
    offs = rng2.normal(0, 0.5, (800, 3, 3))
    v = (centers[:, None] + offs).reshape(-1, 3).astype(np.float32)
    tris = np.arange(2400, dtype=np.int32).reshape(-1, 3)

    nm, nx, first, count, skip, order = native(cen, pmin, pmax, 4)
    bvh = BVHArrays(
        node_min=_f32(nm), node_max=_f32(nx),
        node_meta=_i32(np.stack([first, count, skip], 1)),
        prim_idx=_i32(order))

    class S:
        pass

    s = S()
    s.vertices = jnp.asarray(v)
    s.tri_vidx = jnp.asarray(tris)
    s.tri_pack = jnp.asarray(build_tri_pack(v, tris))
    s.bvh = bvh

    ro = jnp.asarray(rng.uniform(-12, 12, (1500, 3)), jnp.float32)
    rd = jnp.asarray(rng.normal(size=(1500, 3)), jnp.float32)
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    hb = intersect_brute(s, ro, rd, 0.0, 1e4)
    hv = intersect_bvh(s, ro, rd, 0.0, 1e4)
    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hv.tri))


def test_native_speed(native):
    cen, pmin, pmax = _soup(30000, seed=5)
    t0 = time.time()
    native(cen, pmin, pmax, 4)
    t_native = time.time() - t0
    t0 = time.time()
    _build_numpy(cen, pmin, pmax, 4)
    t_numpy = time.time() - t0
    assert t_native < t_numpy, (t_native, t_numpy)


def test_skip_links_are_complete_dfs():
    """The skip links the traversals walk (ops/intersect.py,
    ops/triton_intersect.py) must encode a full DFS: starting at the
    root and always descending on inner nodes, every node is visited
    exactly once, in index order, and the walk ends at the sentinel
    n_nodes."""
    import numpy as np

    from rgk.scene.bvh import _build_numpy

    rng = np.random.RandomState(3)
    c = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    node_min, node_max, first, count, skip, _ = _build_numpy(
        c, c - 0.01, c + 0.01, 1)
    n = len(count)
    inner = np.asarray(count) == 0
    visited = []
    node = 0
    while node < n:
        visited.append(node)
        node = first[node] if inner[node] else skip[node]
        assert len(visited) <= n
    assert visited == list(range(n))
    # A culled subtree resumes exactly after its last node.
    for i in np.nonzero(inner)[0]:
        assert skip[i] > first[i] > i
