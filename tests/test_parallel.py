"""Sharded rendering over the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgk.integrator.path import render_lanes
from rgk.parallel.mesh import MeshContext
from rgk.scene.config import build_scene, load_config


@pytest.fixture(scope="module")
def small_scene(cornell_json):
    cfg = load_config(cornell_json)
    cfg.settings.xres = cfg.settings.yres = 16
    cfg.settings.multisample = 2
    cfg.settings.recursion_max = 4
    arrays, meta, _ = build_scene(cfg)
    return cfg, arrays, meta, cfg.get_camera()


def _lanes(n=512):
    px = jnp.asarray(np.arange(n) % 16, jnp.int32)
    py = jnp.asarray((np.arange(n) // 16) % 16, jnp.int32)
    si = jnp.asarray(np.arange(n) // 256, jnp.uint32)
    return px, py, si


def test_mesh_available():
    assert len(jax.devices()) >= 8, (
        "conftest must provide 8 virtual CPU devices")


def test_sharded_render_matches_single_device(small_scene):
    cfg, arrays, meta, cam = small_scene
    px, py, si = _lanes()
    seed = jnp.uint32(42)

    r1 = render_lanes(arrays, meta, cfg.settings, cam, px, py, si, seed)
    mesh = MeshContext(8)
    fn = mesh.make_render_fn(meta, cfg.settings)
    r8 = fn(mesh.shard_scene(arrays), cam, px, py, si, seed)

    a = np.asarray(r1.radiance)
    b = np.asarray(r8.radiance)
    # Same samples, same physics; XLA fusion may differ per shard
    # size, so equality is to float32 rounding, not bitwise.
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert int(r1.rays) == int(r8.rays)


def test_sharded_render_deterministic(small_scene):
    cfg, arrays, meta, cam = small_scene
    px, py, si = _lanes()
    mesh = MeshContext(8)
    fn = mesh.make_render_fn(meta, cfg.settings)
    scene = mesh.shard_scene(arrays)
    a = np.asarray(fn(scene, cam, px, py, si, jnp.uint32(7)).radiance)
    b = np.asarray(fn(scene, cam, px, py, si, jnp.uint32(7)).radiance)
    np.testing.assert_array_equal(a, b)


def test_mesh_sizes(small_scene):
    """2- and 4-device meshes agree with 8 within tolerance."""
    cfg, arrays, meta, cam = small_scene
    px, py, si = _lanes(256)
    outs = []
    for n in (2, 4, 8):
        mesh = MeshContext(n)
        fn = mesh.make_render_fn(meta, cfg.settings)
        outs.append(np.asarray(
            fn(mesh.shard_scene(arrays), cam, px, py, si,
               jnp.uint32(1)).radiance))
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[1], outs[2], rtol=1e-4, atol=1e-5)


def test_queued_tracer_under_mesh(small_scene):
    """The queued-regeneration tracer (the occupancy fix) now runs
    under the device mesh via shard_map (parallel/mesh.py
    make_queued_fn): an 8-device driver render must match the
    single-device driver render — per-lane values are pure functions
    of (seed, pixel, sample), so only XLA fusion differences remain.

    This is the wavefront path every multi-chip large-scene render
    takes (driver/render.py no longer falls back to the per-sample
    wavefront when a mesh is present)."""
    from rgk.driver.render import RenderDriver

    cfg, arrays, meta, cam = small_scene
    s = cfg.settings
    assert int(s.reverse) == 0  # queued path active

    d1 = RenderDriver(s, arrays, meta, cam, chunk_lanes=1 << 10)
    assert d1._queued
    d1.render_round(0)
    d1.fetch_accumulation()

    mesh = MeshContext(8)
    d8 = RenderDriver(s, arrays, meta, cam, chunk_lanes=1 << 10,
                      mesh=mesh)
    assert d8._queued  # no wavefront fallback under mesh
    d8.render_round(0)
    d8.fetch_accumulation()

    np.testing.assert_allclose(d1.acc.sum, d8.acc.sum,
                               rtol=1e-4, atol=1e-5)
    assert d1.stats.rays == d8.stats.rays


def test_queued_tracer_under_mesh_bvh(small_scene):
    """The same on the BVH path: the traversal's loop carry must vary
    over the mesh axis like the rays it traces (a replicated initial
    carry is a shard_map type error)."""
    from rgk.driver.render import RenderDriver

    cfg, _, _, cam = small_scene
    s = cfg.settings
    arrays, meta, _ = build_scene(cfg, build_bvh=True, bvh_threshold=8)
    assert meta.has_bvh
    sums = []
    for mesh in (None, MeshContext(4)):
        d = RenderDriver(s, arrays, meta, cam, chunk_lanes=1 << 10,
                         mesh=mesh)
        d.render_round(0)
        d.fetch_accumulation()
        sums.append(d.acc.sum)
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-4, atol=1e-5)
