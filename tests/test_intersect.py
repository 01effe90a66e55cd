"""Intersector correctness: BVH traversal against the brute-force
oracle, and the GPU kernels against both."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgk.driver.parity import compare_hits
from rgk.ops.intersect import intersect_brute, intersect_bvh
from rgk.scene.builder import build_tri_pack
from rgk.scene.bvh import build_bvh


class _MiniScene:
    """Just enough of SceneArrays for the intersectors."""

    def __init__(self, vertices, tri_vidx, bvh=None):
        self.vertices = jnp.asarray(vertices, jnp.float32)
        self.tri_vidx = jnp.asarray(tri_vidx, jnp.int32)
        self.tri_pack = jnp.asarray(
            build_tri_pack(np.asarray(vertices), np.asarray(tri_vidx)))
        self.bvh = bvh
        self.epsilon = jnp.float32(1e-5)


def _random_soup(n_tris, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 3))
    offsets = rng.normal(0, 0.6, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    return verts, tris


def _random_rays(n, seed=1, spread=12.0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def test_bvh_matches_brute_closest_hit():
    verts, tris = _random_soup(300, seed=3)
    bvh = build_bvh(verts, tris, leaf_size=4)
    scene = _MiniScene(verts, tris, bvh)
    ro, rd = _random_rays(2000, seed=4)

    hb = intersect_brute(scene, ro, rd, 0.0, 1e4)
    hv = intersect_bvh(scene, ro, rd, 0.0, 1e4)

    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hv.tri))
    hit = np.asarray(hb.tri) >= 0
    assert hit.mean() > 0.05, "test scene should produce enough hits"
    np.testing.assert_allclose(np.asarray(hb.t)[hit], np.asarray(hv.t)[hit],
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(hb.bary_b)[hit],
                               np.asarray(hv.bary_b)[hit], atol=1e-5)


def test_bvh_exclusion():
    verts, tris = _random_soup(100, seed=5)
    bvh = build_bvh(verts, tris, leaf_size=2)
    scene = _MiniScene(verts, tris, bvh)
    ro, rd = _random_rays(500, seed=6)
    hb = intersect_brute(scene, ro, rd, 0.0, 1e4)
    # Exclude each first hit; neither intersector may return it again.
    excl = hb.tri
    hb2 = intersect_brute(scene, ro, rd, 0.0, 1e4, exclude=excl)
    hv2 = intersect_bvh(scene, ro, rd, 0.0, 1e4, exclude=excl)
    e = np.asarray(excl)
    assert not np.any((np.asarray(hb2.tri) == e) & (e >= 0))
    np.testing.assert_array_equal(np.asarray(hb2.tri), np.asarray(hv2.tri))


def test_bvh_any_hit_agrees_on_occlusion():
    verts, tris = _random_soup(200, seed=7)
    bvh = build_bvh(verts, tris, leaf_size=4)
    scene = _MiniScene(verts, tris, bvh)
    ro, rd = _random_rays(1000, seed=8)
    hb = intersect_brute(scene, ro, rd, 0.1, 20.0)
    hv = intersect_bvh(scene, ro, rd, 0.1, 20.0, any_hit=True)
    np.testing.assert_array_equal(np.asarray(hb.tri) >= 0,
                                  np.asarray(hv.tri) >= 0)


def test_t_window():
    # A single triangle at z = -5; rays from origin pointing -z.
    verts = np.array([[-1, -1, -5], [1, -1, -5], [0, 1, -5]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    scene = _MiniScene(verts, tris)
    ro = jnp.zeros((1, 3))
    rd = jnp.asarray([[0.0, 0.0, -1.0]])
    assert int(intersect_brute(scene, ro, rd, 0.0, 10.0).tri[0]) == 0
    assert int(intersect_brute(scene, ro, rd, 0.0, 4.0).tri[0]) == -1
    assert int(intersect_brute(scene, ro, rd, 6.0, 10.0).tri[0]) == -1


def test_render_brute_vs_bvh(cornell_json):
    """Cornell box must render identically via brute force and BVH."""
    from rgk.integrator.path import render_image_round
    from rgk.scene.config import build_scene, load_config

    def build(build_bvh, **kw):
        cfg = load_config(cornell_json)
        cfg.settings.xres = cfg.settings.yres = 24
        cfg.settings.multisample = 4
        return (cfg,) + build_scene(cfg, build_bvh=build_bvh, **kw)[:2]

    cfg, a_brute, meta_b = build(False)
    cfg2, a_bvh, meta_v = build(True, bvh_threshold=8)
    assert meta_v.has_bvh and not meta_b.has_bvh
    cam = cfg.get_camera()
    r1, c1, _ = render_image_round(a_brute, meta_b, cfg.settings, cam, 0)
    r2, c2, _ = render_image_round(a_bvh, meta_v, cfg2.settings, cam, 0)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                               rtol=1e-4, atol=1e-5)


# ---- GPU kernels (ops/triton_intersect.py) against their oracles ----

def _kernel_scene(n_tris=300, seed=3):
    """Random soup with a thin-glass column; every 17th triangle is
    glass, which no ray may hit."""
    from rgk.scene.builder import append_thinglass_column

    verts, tris = _random_soup(n_tris, seed=seed, spread=4.0)
    scene = _MiniScene(verts, tris, build_bvh(verts, tris, leaf_size=4))
    glass = np.arange(n_tris) % 17 == 0
    scene.tri_pack = jnp.asarray(append_thinglass_column(
        np.asarray(scene.tri_pack), np.arange(n_tris), glass))
    return scene, glass


# 1000 rays: not a multiple of the kernels' 128-ray block.
@pytest.mark.parametrize("mode", ["closest", "exclude", "any_hit",
                                  "t_window", "inactive"])
@pytest.mark.parametrize("kernel,oracle", [
    ("sweep", intersect_brute), ("traverse", intersect_bvh)])
def test_kernel_matches_oracle(kernel, oracle, mode):
    from rgk.ops import triton_intersect as tk

    scene, glass = _kernel_scene()
    ro, rd = _random_rays(1000, seed=4, spread=5.0)
    rng = np.random.default_rng(9)
    t_min, t_max, kw = 0.0, 1e4, {}
    if mode == "exclude":
        kw["exclude"] = oracle(scene, ro, rd, 0.0, 1e4).tri
    elif mode == "any_hit":
        t_min, t_max = 0.1, 20.0
    elif mode == "t_window":
        t_min = jnp.asarray(rng.uniform(0.0, 5.0, 1000), jnp.float32)
        t_max = t_min + jnp.asarray(rng.uniform(0.5, 15.0, 1000),
                                    jnp.float32)
    elif mode == "inactive":
        # visibility()'s culled lanes: an empty interval, no hit.
        t_max = jnp.where(jnp.arange(1000) % 3 == 0, -1.0, 1e4)
    want = oracle(scene, ro, rd, t_min, t_max, **kw)
    got = getattr(tk, kernel)(scene, ro, rd, t_min, t_max,
                              any_hit=(mode == "any_hit"),
                              interpret=True, **kw)
    hit = np.asarray(want.tri) >= 0
    assert 0.05 < hit.mean() < 1.0, "scene should hit some rays, not all"
    if mode == "any_hit":
        np.testing.assert_array_equal(np.asarray(got.tri) >= 0, hit)
        return
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
    assert not glass[np.asarray(got.tri)[hit]].any()
    if mode == "exclude":
        e = np.asarray(kw["exclude"])
        assert not np.any((np.asarray(got.tri) == e) & (e >= 0))
    if mode == "inactive":
        assert not hit[::3].any()
    stats = compare_hits(got, want, scene.tri_pack, ro, rd, diameter=40.0)
    assert stats["ok"], stats


@pytest.mark.parametrize("has_bvh", [False, True])
def test_dispatch_follows_lowering_platform(has_bvh):
    """The plain intersector on CPU, the Triton kernel on CUDA, and a
    lowering error on any other platform."""
    import jax

    from rgk.ops.intersect import make_intersector
    from rgk.scene.arrays import SceneMeta

    from collections import namedtuple

    mini, _ = _kernel_scene(64)
    # The dispatch passes the scene through lax.platform_dependent, so
    # it must be a pytree, as SceneArrays is.
    scene = namedtuple("Scene", "tri_pack bvh")(mini.tri_pack, mini.bvh)
    meta = SceneMeta(n_triangles=64, n_materials=1, n_point_lights=0,
                     n_areal_tris=0, has_bvh=has_bvh, has_textures=False,
                     has_thinglass=True)
    intersect = make_intersector(meta)
    ro, rd = _random_rays(256)
    traced = jax.jit(lambda ro, rd: intersect(
        scene, ro, rd, 0.0, 1e4).t).trace(ro, rd)
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in cpu
    assert "triton" in cuda
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))
    # On the CPU the dispatch computes exactly the oracle.
    oracle = intersect_bvh if has_bvh else intersect_brute
    np.testing.assert_array_equal(
        np.asarray(intersect(scene, ro, rd, 0.0, 1e4).tri),
        np.asarray(oracle(scene, ro, rd, 0.0, 1e4).tri))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,oracle", [
    ("sweep", intersect_brute), ("traverse", intersect_bvh)])
def test_kernel_compiled_on_gpu(kernel, oracle):
    """The compiled kernel (no interpreter) against its oracle."""
    from rgk.ops import triton_intersect as tk

    scene, _ = _kernel_scene()
    ro, rd = _random_rays(1000, seed=4)
    want = oracle(scene, ro, rd, 0.0, 1e4)
    got = getattr(tk, kernel)(scene, ro, rd, 0.0, 1e4)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(want.tri))
