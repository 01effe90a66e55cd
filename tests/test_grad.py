"""Gradient correctness: VJP through the renderer vs central finite
differences (BASELINE.json: "pixel-grad allclose").

With a fixed seed and russian roulette off, no sampling decision
depends on parameters, so the rendered image is piecewise-smooth in
them and finite differences converge to the analytic gradient.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgk.diff.params import apply_params, extract_params, make_loss_fn
from rgk.scene.config import build_scene, load_config


@pytest.fixture(scope="module")
def grad_setup(tmp_path_factory):
    cfg_d = {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 4, "recursion-max": 2, "russian": -1.0,
        "camera": {"position": [0, 1.5, 1.5], "lookat": [0, 0, 0],
                   "fov": 50},
        "sky": {"color": [0.3, 0.3, 0.4], "intensity": 1.0},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse": [0.6, 0.4, 0.3]},
            {"name": "glow", "brdf": "diffuse", "diffuse": [0.2, 0.2, 0.2],
             "emission": [1.0, 0.8, 0.6]},
            {"name": "shiny", "brdf": "ltc_ggx_diffuse",
             "roughness": 0.35, "specular": [0.4, 0.4, 0.4],
             "diffuse": [0.2, 0.3, 0.2]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
             "material": "floor"},
            {"primitive": "cube", "translate": [-0.4, 0.25, 0],
             "scale": [0.5, 0.5, 0.5], "material": "shiny"},
            {"primitive": "tri", "translate": [0.5, 0.8, 0],
             "rotate": [0, 0, 180], "scale": [0.3, 1, 0.3],
             "material": "glow"},
        ],
        "lights": [{"position": [1, 2, 1], "color": [1, 0.9, 0.8],
                    "intensity": 2.0}],
    }
    p = tmp_path_factory.mktemp("grad") / "scene.json"
    p.write_text(json.dumps(cfg_d))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()

    n = 64
    px = jnp.asarray(np.arange(n) % 8, jnp.int32)
    py = jnp.asarray((np.arange(n) // 8) % 8, jnp.int32)
    si = jnp.zeros((n,), jnp.uint32)
    target = jnp.zeros((n, 3), jnp.float32)
    loss_fn = make_loss_fn(arrays, meta, cfg.settings, cam, px, py, si,
                           jnp.uint32(3), target)
    params = extract_params(arrays)
    return loss_fn, params


def _fd_check(loss_fn, params, key, idx, eps, rtol):
    g = jax.grad(lambda p: loss_fn(p))(params)
    g_val = float(np.asarray(g[key]).reshape(-1)[idx])

    flat = np.asarray(params[key], np.float64).reshape(-1).copy()

    def loss_at(v):
        p2 = dict(params)
        arr = flat.copy()
        arr[idx] = v
        p2[key] = jnp.asarray(arr.reshape(params[key].shape), jnp.float32)
        return float(loss_fn(p2))

    v0 = flat[idx]
    fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
    assert np.isfinite(g_val)
    if abs(fd) < 1e-7 and abs(g_val) < 1e-7:
        return
    assert abs(g_val - fd) <= rtol * max(abs(fd), abs(g_val)) + 1e-6, (
        key, idx, g_val, fd)


def test_grad_diffuse_albedo(grad_setup):
    loss_fn, params = grad_setup
    _fd_check(loss_fn, params, "mat_diffuse", 0, 1e-3, 0.03)


def test_grad_emission(grad_setup):
    loss_fn, params = grad_setup
    # material 1 ("glow"), red channel -> flat index 3
    _fd_check(loss_fn, params, "mat_emission", 3, 1e-3, 0.03)


def test_grad_light_intensity(grad_setup):
    loss_fn, params = grad_setup
    _fd_check(loss_fn, params, "light_intensity", 0, 1e-3, 0.03)


def test_grad_sky(grad_setup):
    loss_fn, params = grad_setup
    _fd_check(loss_fn, params, "sky_intensity", 0, 1e-3, 0.03)


def test_grad_roughness(grad_setup):
    loss_fn, params = grad_setup
    # LTC interpolation is piecewise multilinear; stay inside a cell.
    _fd_check(loss_fn, params, "mat_roughness", 2, 2e-4, 0.08)


def test_grad_specular(grad_setup):
    loss_fn, params = grad_setup
    _fd_check(loss_fn, params, "mat_specular", 6, 1e-3, 0.05)


@pytest.fixture(scope="module")
def nee_setup(tmp_path_factory):
    """A scene lit ONLY by an areal light through NEE: black sky, no
    point lights, recursion-max 1 (camera vertex only, so the one
    radiance pathway is direct areal lighting).  Regression scene for
    the stale-emission bug: apply_params must rebuild the de-indexed
    areal_rows emission columns NEE actually reads (ops/lights.py)."""
    cfg_d = {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 8, "recursion-max": 1, "russian": -1.0,
        "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0],
                   "fov": 50},
        "sky": {"color": [0, 0, 0], "intensity": 0.0},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse": [0.6, 0.6, 0.6]},
            {"name": "glow", "brdf": "diffuse", "diffuse": [0, 0, 0],
             "emission": [2.0, 1.0, 0.5]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
             "material": "floor"},
            {"primitive": "tri", "translate": [0, 1.5, 0],
             "rotate": [0, 0, 180], "scale": [0.5, 1, 0.5],
             "material": "glow"},
        ],
    }
    p = tmp_path_factory.mktemp("nee") / "scene.json"
    p.write_text(json.dumps(cfg_d))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    n = 64
    px = jnp.asarray(np.arange(n) % 8, jnp.int32)
    py = jnp.asarray((np.arange(n) // 8) % 8, jnp.int32)
    si = jnp.zeros((n,), jnp.uint32)
    return cfg, arrays, meta, cam, px, py, si


def _nee_render(arrays, meta, cfg, cam, px, py, si, params):
    from rgk.integrator.path import render_lanes

    s = apply_params(arrays, params)
    return np.asarray(render_lanes(
        s, meta, cfg.settings, cam, px, py, si, jnp.uint32(3),
        differentiable=True).radiance)


def test_nee_emission_follows_params(nee_setup):
    """Scaling mat_emission through apply_params must scale NEE-lit
    pixels (the old bug left areal_rows[:,12:15] stale)."""
    cfg, arrays, meta, cam, px, py, si = nee_setup
    params = extract_params(arrays)
    base = _nee_render(arrays, meta, cfg, cam, px, py, si, params)
    assert base.max() > 1e-4  # floor is NEE-lit

    p2 = dict(params)
    p2["mat_emission"] = params["mat_emission"] * 2.0
    doubled = _nee_render(arrays, meta, cfg, cam, px, py, si, p2)
    lit = base.max(axis=-1) > 1e-4
    np.testing.assert_allclose(doubled[lit], 2.0 * base[lit], rtol=1e-5)


def test_grad_emission_through_nee(nee_setup):
    """d(loss)/d(emission) through the DIRECT-LIGHTING pathway must be
    nonzero and match finite differences (old bug: silently zero)."""
    cfg, arrays, meta, cam, px, py, si = nee_setup
    target = jnp.zeros((64, 3), jnp.float32)
    loss_fn = make_loss_fn(arrays, meta, cfg.settings, cam, px, py, si,
                           jnp.uint32(3), target)
    params = extract_params(arrays)
    g = jax.grad(loss_fn)(params)
    # material 1 ("glow") red channel, flat index 3
    assert abs(float(np.asarray(g["mat_emission"]).reshape(-1)[3])) > 1e-7
    _fd_check(loss_fn, params, "mat_emission", 3, 1e-3, 0.03)
    _fd_check(loss_fn, params, "mat_emission", 4, 1e-3, 0.03)


@pytest.fixture(scope="module")
def texel_setup(tmp_path_factory):
    """A textured floor under a point light plus an envmap sky: the two
    untested leaves of PARAM_KEYS ("texels" through the diffuse-texture
    fetch AND through the sky-escape envmap lookup, ops/textures.py
    sample_bilinear / sky_radiance).  Radiance is LINEAR in texel
    values (bilinear interpolation has constant weights once geometry
    is detached), so central differences are exact up to fp32 noise —
    the bilinear-corner subtlety is in WHICH texels receive gradient,
    which we probe via the argmax texel of the analytic gradient."""
    from rgk.io.texture_io import write_png

    tmp = tmp_path_factory.mktemp("texgrad")
    rng = np.random.RandomState(7)
    write_png(str(tmp / "floor.png"), rng.uniform(0.2, 0.9, (4, 4, 3)))
    write_png(str(tmp / "env.png"), rng.uniform(0.1, 0.8, (4, 8, 3)))
    cfg_d = {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 4, "recursion-max": 2, "russian": -1.0,
        # Camera near the horizon: lower lanes hit the floor (texture
        # pathway), upper lanes escape to the sky (envmap pathway).
        "camera": {"position": [0, 0.8, 2.5], "lookat": [0, 0.6, 0],
                   "fov": 70},
        "sky": {"envmap": "env.png", "intensity": 1.0},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse-texture": "floor.png"},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [3, 1, 3],
             "material": "floor"},
        ],
        "lights": [{"position": [1, 2, 1], "color": [1, 0.9, 0.8],
                    "intensity": 2.0}],
    }
    p = tmp / "scene.json"
    p.write_text(json.dumps(cfg_d))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    n = 64
    px = jnp.asarray(np.arange(n) % 8, jnp.int32)
    py = jnp.asarray((np.arange(n) // 8) % 8, jnp.int32)
    si = jnp.zeros((n,), jnp.uint32)
    target = jnp.zeros((n, 3), jnp.float32)
    loss_fn = make_loss_fn(arrays, meta, cfg.settings, cam, px, py, si,
                           jnp.uint32(3), target)
    params = extract_params(arrays)
    return loss_fn, params, arrays


def _texel_slice(arrays, tex_id):
    """Flat [start, stop) of texture `tex_id` in the texel atlas."""
    off, w, h = (int(v) for v in np.asarray(arrays.textures.desc)[tex_id])
    return 3 * off, 3 * (off + w * h)


def test_grad_texture_texel(texel_setup):
    """FD-check d(loss)/d(texel) for the strongest FLOOR-texture texel
    (SURVEY hard-part #4: bilinear-corner subgradients)."""
    loss_fn, params, arrays = texel_setup
    g = np.asarray(jax.grad(loss_fn)(params)["texels"]).reshape(-1)
    floor_tex = 0 if int(np.asarray(arrays.sky_tex)) != 0 else 1
    lo, hi = _texel_slice(arrays, floor_tex)
    assert np.abs(g[lo:hi]).max() > 1e-7, "no gradient reaches the texture"
    idx = lo + int(np.abs(g[lo:hi]).argmax())
    _fd_check(loss_fn, params, "texels", idx, 1e-3, 0.03)


def test_grad_envmap_texel(texel_setup):
    """FD-check d(loss)/d(texel) for the strongest ENVMAP texel: the
    gradient must flow through the sky-escape lookup (sky_radiance,
    reference scene.cpp:748-763)."""
    loss_fn, params, arrays = texel_setup
    g = np.asarray(jax.grad(loss_fn)(params)["texels"]).reshape(-1)
    sky_tex = int(np.asarray(arrays.sky_tex))
    assert sky_tex >= 0, "scene must have an envmap"
    lo, hi = _texel_slice(arrays, sky_tex)
    assert np.abs(g[lo:hi]).max() > 1e-7, "no gradient reaches the envmap"
    idx = lo + int(np.abs(g[lo:hi]).argmax())
    _fd_check(loss_fn, params, "texels", idx, 1e-3, 0.03)


def test_optimization_step_reduces_loss(grad_setup):
    """One gradient-descent step on all params must reduce the loss."""
    loss_fn, params = grad_setup
    l0, g = jax.value_and_grad(loss_fn)(params)
    lr = 0.05
    params2 = jax.tree_util.tree_map(lambda p, gg: p - lr * gg, params, g)
    l1 = float(loss_fn(params2))
    assert l1 < float(l0)


def _write_uv_sphere(path, n_lat, n_lon):
    """Unit UV sphere as an OBJ with per-vertex normals:
    2 * n_lon * (n_lat - 1) triangles."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    v = np.stack([np.sin(lat)[:, None] * np.cos(lon)[None, :],
                  np.cos(lat)[:, None] + 0.0 * lon[None, :],
                  np.sin(lat)[:, None] * np.sin(lon)[None, :]],
                 axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, e = a + n_lon, b + n_lon
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((b, e, c))
    with open(path, "w") as f:
        for x in v:
            f.write("v %.6f %.6f %.6f\n" % tuple(x))
        for x in v:
            f.write("vn %.6f %.6f %.6f\n" % tuple(x))
        for a, b, c in faces:
            f.write(f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}\n")


@pytest.fixture(scope="module")
def mesh_bvh_setup(tmp_path_factory):
    """FD gradients with hits coming from TREE TRAVERSAL: a mesh
    scene (a 1216-face UV sphere OBJ) committed with build_bvh=True
    and a tiny bvh_threshold so intersect_bvh — not the flat sweep —
    produces every hit.  Proves the designed stop-gradient through Hit
    (integrator/path.py) end-to-end (BASELINE "pixel-grad allclose" on
    a mesh config)."""
    d = tmp_path_factory.mktemp("gradmesh")
    mesh = str(d / "sphere.obj")
    _write_uv_sphere(mesh, n_lat=20, n_lon=32)
    cfg_d = {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 4, "recursion-max": 2, "russian": -1.0,
        "camera": {"position": [0, 1.0, 2.5], "lookat": [0, 0.3, 0],
                   "fov": 50},
        "sky": {"color": [0.2, 0.25, 0.3], "intensity": 1.0},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse": [0.5, 0.45, 0.4]},
            {"name": "ball", "brdf": "diffuse",
             "diffuse": [0.6, 0.3, 0.2]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [5, 1, 5],
             "material": "floor"},
            {"file": mesh, "material": "ball",
             "translate": [0, 0.45, 0], "scale": [0.45, 0.45, 0.45]},
        ],
        "lights": [{"position": [1.5, 2.5, 1.5], "color": [1, 1, 0.9],
                    "intensity": 3.0}],
    }
    p = d / "scene.json"
    p.write_text(json.dumps(cfg_d))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=True, bvh_threshold=8)
    assert meta.has_bvh  # hits must come from the tree
    cam = cfg.get_camera()

    n = 64
    px = jnp.asarray(np.arange(n) % 8, jnp.int32)
    py = jnp.asarray((np.arange(n) // 8) % 8, jnp.int32)
    si = jnp.zeros((n,), jnp.uint32)
    target = jnp.zeros((n, 3), jnp.float32)
    loss_fn = make_loss_fn(arrays, meta, cfg.settings, cam, px, py, si,
                           jnp.uint32(3), target)
    params = extract_params(arrays)
    return loss_fn, params


def test_grad_mesh_bvh_albedo(mesh_bvh_setup):
    loss_fn, params = mesh_bvh_setup
    # the sphere's albedo (material 1, red channel)
    _fd_check(loss_fn, params, "mat_diffuse", 3, 1e-3, 0.03)


def test_grad_mesh_bvh_light(mesh_bvh_setup):
    loss_fn, params = mesh_bvh_setup
    _fd_check(loss_fn, params, "light_intensity", 0, 1e-3, 0.03)


@pytest.mark.parametrize("setup", ["grad_setup", "mesh_bvh_setup"])
def test_grad_equal_with_dispatch(setup, request, monkeypatch):
    """The platform dispatch of ops/intersect.make_intersector changes
    no gradient: every parameter's gradient through a render equals
    the one taken with the plain intersector called directly."""
    from functools import partial

    from rgk.ops import intersect as isect

    loss_fn, params = request.getfixturevalue(setup)
    g_dispatch = jax.grad(loss_fn)(params)

    def plain_intersector(meta):
        fn = isect.intersect_bvh if meta.has_bvh else isect.intersect_brute

        def intersect(scene, ro, rd, t_min, t_max, exclude=None,
                      any_hit=False):
            return partial(fn, any_hit=any_hit)(
                scene, jax.lax.stop_gradient(ro),
                jax.lax.stop_gradient(rd), t_min, t_max, exclude)
        return intersect

    monkeypatch.setattr(isect, "make_intersector", plain_intersector)
    g_plain = jax.grad(loss_fn)(params)
    for key in params:
        np.testing.assert_array_equal(np.asarray(g_dispatch[key]),
                                      np.asarray(g_plain[key]), err_msg=key)
