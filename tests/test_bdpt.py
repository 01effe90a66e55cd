"""Bidirectional-mode (reverse > 0) semantics.

Golden parity against the reference's own BDPT render is covered by
tests/test_golden.py::test_golden_box2_bdpt; these tests pin the
mechanics underneath it:

* the inverse camera projection round-trips the forward projection
  (reference src/camera.cpp GetCoordsFromDirection:48-83);
* light-tracing splats are weight-0 side effects: they add radiance
  to pixels they land on without bumping sample counts (reference
  src/tracer.cpp:18-26);
* a sharded (8-virtual-device) BDPT render matches single-device.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from rgk.driver.render import RenderDriver
from rgk.integrator.path import render_lanes
from rgk.parallel.mesh import MeshContext
from rgk.scene.camera import coords_from_direction, make_camera, pixel_rays
from rgk.scene.config import build_scene, load_config


def test_coords_from_direction_roundtrips_pixel_rays():
    """Forward-project pixel centers, inverse-project the directions:
    must land on the same pixel, in view (camera.cpp:32-38 vs 48-83)."""
    cam = make_camera(position=[1.0, 2.0, 3.0], lookat=[0.0, 0.5, -1.0],
                      up=[0.0, 1.0, 0.0], yview=0.8, xview=1.1,
                      xres=64, yres=48)
    rng = np.random.default_rng(7)
    px = jnp.asarray(rng.integers(0, 64, 256), jnp.int32)
    py = jnp.asarray(rng.integers(0, 48, 256), jnp.int32)
    jitter = jnp.full((256, 2), 0.5, jnp.float32)
    _, rd = pixel_rays(cam, px, py, jitter)
    x, y, in_view = coords_from_direction(cam, rd)
    assert bool(jnp.all(in_view))
    np.testing.assert_array_equal(np.asarray(x), np.asarray(px))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(py))


def test_coords_from_direction_rejects_behind():
    """Directions pointing away from the view screen are out of view."""
    cam = make_camera(position=[0.0, 0.0, 0.0], lookat=[0.0, 0.0, -1.0],
                      up=[0.0, 1.0, 0.0], yview=1.0, xview=1.0,
                      xres=32, yres=32)
    dirs = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                        [1.0, 0.0, 0.0]], jnp.float32)
    _, _, in_view = coords_from_direction(cam, dirs)
    assert not bool(jnp.any(in_view))


def _bdpt_cfg(tmp_path, reverse=2, res=24, ms=8):
    cfg = {
        "output-file": "t.exr",
        "output-width": res, "output-height": res,
        "multisample": ms,
        "recursion-max": 3,
        "reverse": reverse,
        "russian": -1.0,
        "camera": {"position": [0, 2, 4], "lookat": [0, 0.5, 0],
                   "fov": 60},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse": [0.6, 0.6, 0.6]},
            {"name": "glow", "brdf": "diffuse",
             "emission": [8, 8, 8]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [10, 1, 10],
             "material": "floor"},
            # Small emissive quad above the floor, facing down.
            {"primitive": "plane", "axis": "Y",
             "scale": [0.7, 1, 0.7], "rotate": [0, 0, 180],
             "translate": [0, 2.5, 0], "material": "glow"},
        ],
    }
    p = tmp_path / "bdpt.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def test_splats_are_weight0_side_effects(tmp_path):
    """reverse>0 adds splat radiance to the frame WITHOUT adding to
    per-pixel sample counts (reference weight-0 splat pixels,
    src/tracer.cpp:18-26): counts stay ms*rounds everywhere, while the
    light-transport image gains energy vs the NEE-only render."""
    cfg = load_config(_bdpt_cfg(tmp_path, reverse=2))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()

    drv = RenderDriver(cfg.settings, arrays, meta, cam)
    drv.render_round(0)
    drv.fetch_accumulation()
    assert (drv.acc.count == cfg.settings.multisample).all()
    assert np.isfinite(drv.acc.sum).all()
    assert (drv.acc.sum >= 0).all()
    img_bdpt = drv.acc.sum.sum()

    cfg0 = load_config(_bdpt_cfg(tmp_path, reverse=0))
    arrays0, meta0, _ = build_scene(cfg0, build_bvh=False)
    drv0 = RenderDriver(cfg0.settings, arrays0, meta0, cfg0.get_camera())
    drv0.render_round(0)
    drv0.fetch_accumulation()
    # The BDPT estimator includes everything the NEE path sees plus
    # splats + eye-light connections: strictly more recorded energy.
    assert img_bdpt > drv0.acc.sum.sum()


def test_splat_pixels_in_range(tmp_path):
    """Every emitted splat indexes a real pixel and carries finite,
    non-negative radiance; with the light quad over a visible floor a
    healthy fraction of light vertices splat successfully."""
    cfg = load_config(_bdpt_cfg(tmp_path, reverse=2))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    n = 512
    rng = np.random.default_rng(3)
    px = jnp.asarray(rng.integers(0, 24, n), jnp.int32)
    py = jnp.asarray(rng.integers(0, 24, n), jnp.int32)
    si = jnp.asarray(np.arange(n) % 8, jnp.uint32)
    r = render_lanes(arrays, meta, cfg.settings, cam, px, py, si,
                     jnp.uint32(42))
    pix = np.asarray(r.splat_pix)
    val = np.asarray(r.splat_val)
    assert pix.shape == (n, 2)  # one slot per light vertex
    ok = pix >= 0
    assert ok.mean() > 0.3, ok.mean()
    assert (pix[ok] < 24 * 24).all()
    assert np.isfinite(val).all()
    assert (val >= 0).all()
    # Splat slots that missed carry exactly zero radiance.
    assert (val[~ok] == 0).all()


def test_bdpt_sharded_matches_single_device(tmp_path):
    """8-virtual-device BDPT render == single-device (radiance and
    splats); the one cross-device wrinkle is the splat scatter
    (SURVEY §5 'light-tracing splats')."""
    cfg = load_config(_bdpt_cfg(tmp_path, reverse=2))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()

    drv1 = RenderDriver(cfg.settings, arrays, meta, cam)
    drv1.render_round(0)
    drv1.fetch_accumulation()

    mesh = MeshContext(8)
    drv8 = RenderDriver(cfg.settings, arrays, meta, cam, mesh=mesh)
    drv8.render_round(0)
    drv8.fetch_accumulation()

    # Scatter-add order over splats differs per sharding at the last
    # ulp; physics and samples are identical.
    np.testing.assert_allclose(drv8.acc.sum, drv1.acc.sum,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(drv8.acc.count, drv1.acc.count)


def test_queued_bdpt_matches_per_sample_wavefront(tmp_path):
    """The queued-regeneration BDPT tracer (the production path,
    integrator/path.trace_wavefront_queued_bdpt) must reproduce the
    per-sample wavefront's estimator exactly: sampling is a pure
    function of (seed, pixel, sample, dim), so eye radiance is
    bitwise-identical and the splat image agrees to scatter-order
    (1-ulp class) float noise."""
    from rgk.integrator.path import (render_image_round,
                                     trace_wavefront_queued_bdpt)

    cfg = load_config(_bdpt_cfg(tmp_path, reverse=3, res=16, ms=4))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    res, ms = cam.xres, int(cfg.settings.multisample)

    # Reference: the per-sample wavefront (render_image_round drives
    # trace_wavefront + a host-side splat scatter).
    rad_ref, counts, rays_ref = render_image_round(
        arrays, meta, cfg.settings, cam, 0, seed=42)

    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    rad_q, splat_img, rays_q = trace_wavefront_queued_bdpt(
        arrays, meta, cfg.settings, cam, px, py, 0, ms, 42)
    img_q = (np.asarray(rad_q).reshape(res, res, 3)
             + np.asarray(splat_img)[:res * res].reshape(res, res, 3))

    assert int(rays_q) == int(rays_ref)
    np.testing.assert_allclose(img_q, np.asarray(rad_ref),
                               rtol=2e-5, atol=1e-6)
