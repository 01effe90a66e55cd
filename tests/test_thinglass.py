"""Thin-glass parity: matching materials stop blocking rays/shadows.

Reference semantics (SURVEY §2.3, src/scene.cpp MakeThinglassSet +
src/scene_intersect.cpp WithThinglass traversals): materials whose
name contains any configured phrase are skipped by traversal; the tint
filter is disabled in the reference's live code, so pass-through is
the complete behavior.
"""

import json

import numpy as np
import pytest

from rgk.integrator.path import render_image_round
from rgk.scene.config import build_scene, load_config


def _cfg(thinglass):
    return {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "multisample": 8, "recursion-max": 1, "russian": -1.0,
        "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0],
                   "fov": 40},
        "thinglass": thinglass,
        "materials": [
            {"name": "floor", "brdf": "diffuse", "diffuse": [0.5, 0.5, 0.5]},
            {"name": "pane_glass", "brdf": "diffuse",
             "diffuse": [0.1, 0.1, 0.1]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [5, 1, 5],
             "material": "floor"},
            # A pane between light and floor, and between camera & floor
            {"primitive": "plane", "axis": "Y", "translate": [0, 1, 0],
             "scale": [5, 1, 5], "material": "pane_glass"},
        ],
        "lights": [{"position": [0, 3, 0], "color": [1, 1, 1],
                    "intensity": 2.0}],
    }


def _render(tmp_path, cfg_dict, name):
    p = tmp_path / name
    p.write_text(json.dumps(cfg_dict))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    rad, counts, _ = render_image_round(arrays, meta, cfg.settings, cam, 0)
    return np.asarray(rad) / np.asarray(counts)[..., None]


def test_thinglass_passthrough(tmp_path):
    blocked = _render(tmp_path, _cfg([]), "blocked.json")
    passed = _render(tmp_path, _cfg(["glass"]), "passed.json")

    # Without thin-glass the camera sees the dark pane (almost black
    # floor term); with it, the pane vanishes and the lit floor shows.
    expected_floor = 2.0 * (0.5 / np.pi) / 9.0
    c_passed = passed[4, 4].mean()
    c_blocked = blocked[4, 4].mean()
    assert abs(c_passed - expected_floor) / expected_floor < 0.1
    assert c_blocked < c_passed * 0.8  # pane shadows + dark albedo


def test_thinglass_meta_flag(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps(_cfg(["glass"])))
    cfg = load_config(str(p))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    assert meta.has_thinglass
    pack = np.asarray(arrays.tri_pack)
    assert pack.shape[1] == 13
    assert pack[:, 12].sum() == 2  # the 2 pane triangles


def test_thinglass_hit_list_collection(tmp_path):
    """The ordered hit-list query (ops/thinglass.py — the reference's
    fourth traversal, src/scene_intersect.cpp:385-399): rays through
    stacked panes record each crossing in ascending t; dedupe and
    orientation follow ApplyThinglass (path_tracer.cpp:81-108)."""
    import jax.numpy as jnp

    from rgk.ops.thinglass import apply_thinglass, collect_thinglass

    cfg = _cfg(["glass"])
    # Three stacked panes at y = 1, 1.5, 2 (two extra glass panes).
    cfg["scene"].append({"primitive": "plane", "axis": "Y",
                         "translate": [0, 1.5, 0], "scale": [5, 1, 5],
                         "material": "pane_glass"})
    cfg["scene"].append({"primitive": "plane", "axis": "Y",
                         "translate": [0, 2, 0], "scale": [5, 1, 5],
                         "material": "pane_glass"})
    p = tmp_path / "panes.json"
    p.write_text(json.dumps(cfg))
    from rgk.scene.config import build_scene, load_config
    arrays, meta, _ = build_scene(load_config(str(p)), build_bvh=False)
    assert meta.has_thinglass
    assert int(arrays.glass_ids.shape[0]) == 6  # 3 panes x 2 tris

    # A vertical ray from below crosses all three panes; a horizontal
    # ray at y=0.5 crosses none.
    ro = jnp.asarray([[0.3, 0.2, 0.3], [0.3, 0.5, 0.3]], jnp.float32)
    rd = jnp.asarray([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    ts, tris = collect_thinglass(arrays, ro, rd, 0.0, 100.0)
    ts0 = np.asarray(ts[0])
    assert (np.asarray(tris[0, :3]) >= 0).all()
    assert np.asarray(tris[0, 3]) == -1
    np.testing.assert_allclose(ts0[:3], [0.8, 1.3, 1.8], atol=1e-5)
    assert (ts0[:3][1:] > ts0[:3][:-1]).all()  # ascending
    assert (np.asarray(tris[1]) == -1).all()

    # Pass-through default: radiance unchanged (live-code parity).
    rad = jnp.ones((2, 3), jnp.float32)
    out = apply_thinglass(arrays, rad, ts, tris, rd, tint=False)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(rad))
    # Tint enabled: entering crossings multiply by the pane diffuse
    # (0.1), once per DISTINCT crossing.
    out_t = np.asarray(apply_thinglass(arrays, rad, ts, tris, rd,
                                       tint=True))
    n = arrays.tri_normal[np.asarray(tris[0, 0])]
    entering = float(np.dot(np.asarray(n), np.asarray(rd[0]))) >= 0
    expect = 0.1 ** 3 if entering else 1.0
    np.testing.assert_allclose(out_t[0], expect, rtol=1e-5)
    np.testing.assert_array_equal(out_t[1], np.asarray(rad[1]))


def test_thinglass_tint_render(tmp_path):
    """End-to-end: the tint-thinglass extension darkens light crossing
    a pane, while the default render passes through unchanged."""
    base = _cfg(["glass"])
    passed = _render(tmp_path, base, "tint_off.json")

    tint = _cfg(["glass"])
    tint["tint-thinglass"] = True
    tinted = _render(tmp_path, tint, "tint_on.json")

    c_pass = passed[4, 4].mean()
    c_tint = tinted[4, 4].mean()
    # Shadow segment crosses the pane once: incident light scaled by
    # the pane's diffuse (0.1) when entering-oriented, else unchanged.
    assert c_tint <= c_pass + 1e-6
    assert c_tint == pytest.approx(c_pass * 0.1, rel=0.05) or \
        c_tint == pytest.approx(c_pass, rel=1e-3)
