import numpy as np
import pytest

from rgk.scene.json_utils import ConfigError, Node, loads_tolerant
from rgk.scene.config import load_config


def test_strip_comments():
    text = """
    { // a comment
      "a": 1, /* inline */ "b": "he//llo",
      "c": [1, 2, 3], // trailing comma next
    }
    """
    data = loads_tolerant(text)
    assert data == {"a": 1, "b": "he//llo", "c": [1, 2, 3]}


def test_typed_getters():
    n = Node({"s": "x", "i": 3, "f": 1.5, "v": [1, 2, 3], "c255": [255, 0, 0],
              "scalar_v": 2.0, "unused": 1})
    assert n.req_str("s") == "x"
    assert n.req_int("i") == 3
    assert n.req_float("f") == 1.5
    np.testing.assert_allclose(n.req_vec3("v"), [1, 2, 3])
    np.testing.assert_allclose(n.req_vec3_255("c"), [1, 0, 0])
    np.testing.assert_allclose(n.req_vec3("scalar_v"), [2, 2, 2])
    with pytest.raises(ConfigError):
        n.req_str("missing")
    with pytest.raises(ConfigError):
        n.req_int("s")
    assert n.find_unused() == ["unused"]


def test_cornell_box_config(cornell_json):
    cfg = load_config(cornell_json)
    s = cfg.settings
    assert (s.xres, s.yres) == (1024, 1024)
    assert s.multisample == 400
    assert s.rounds == 1
    assert s.recursion_max == 10
    assert abs(s.russian - 0.74) < 1e-6
    assert abs(s.clamp - 20.0) < 1e-6
    cam = cfg.get_camera()
    np.testing.assert_allclose(np.asarray(cam.origin), [0, 1, 6.8], atol=1e-6)
    # fov 19.5 -> xview = 2 tan(fov/2)
    xview = float(np.linalg.norm(np.asarray(cam.viewscreen_x)))
    assert abs(xview - 2.0 * np.tan(np.radians(19.5) / 2.0)) < 1e-4


def test_cornell_box_scene_build(cornell_json):
    from rgk.scene.config import build_scene
    cfg = load_config(cornell_json)
    arrays, meta, builder = build_scene(cfg, build_bvh=False)
    # 5 planes x 2 tris + 2 cubes x 12 tris + 2 light tris = 36
    assert meta.n_triangles == 36
    assert meta.n_materials == 4
    assert float(arrays.lights.total_areal_power) > 0
    assert float(arrays.lights.total_point_power) == 0
    # Light triangles are the last two, at y ~= 1.98
    lt = np.asarray(arrays.lights.areal_tri)
    assert len(lt) == 2
    v = np.asarray(arrays.vertices)
    tri = np.asarray(arrays.tri_vidx)
    ys = v[tri[lt]][..., 1]
    np.testing.assert_allclose(ys, 1.98, atol=1e-5)


def _mix_cfg(nested: bool) -> dict:
    mats = [
        {"name": "a", "brdf": "diffuse", "diffuse": [0.5, 0.5, 0.5]},
        {"name": "b", "brdf": "mirror"},
        {"name": "m1", "brdf": "mix", "material1": "a", "material2": "b",
         "amount": 0.5},
    ]
    if nested:
        mats.append({"name": "m2", "brdf": "mix", "material1": "m1",
                     "material2": "a", "amount": 0.25})
    top = mats[-1]["name"]
    return {
        "output-file": "t.exr", "output-width": 8, "output-height": 8,
        "camera": {"position": [0, 2, 0.001], "lookat": [0, 0, 0],
                   "fov": 40},
        "materials": mats,
        "scene": [{"primitive": "plane", "axis": "Y", "material": top}],
    }


def test_nested_mix_rejected(tmp_path):
    """The runtime expands exactly one mix level; a mix whose leaf is
    itself a mix (legal for the reference's BxDFMix pointer
    composition, reference src/bxdf/bxdf.cpp:221-249) must be rejected
    at config load, not silently evaluate to zero."""
    import json

    from rgk.scene.config import build_scene

    ok = tmp_path / "mix1.json"
    ok.write_text(json.dumps(_mix_cfg(nested=False)))
    _, meta, _ = build_scene(load_config(str(ok)), build_bvh=False)
    assert meta.has_mix  # one-level mix builds

    bad = tmp_path / "mix2.json"
    bad.write_text(json.dumps(_mix_cfg(nested=True)))
    with pytest.raises(ConfigError, match="nested mix"):
        build_scene(load_config(str(bad)), build_bvh=False)
