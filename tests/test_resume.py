"""Checkpoint/resume: a resumed render must continue with FRESH
sample indices (reference progressive semantics,
src/render_driver.cpp:227-248) — N rounds straight and k rounds +
checkpoint + resume (N-k) must produce bitwise-identical accumulation.
"""

import json

import numpy as np

from rgk.driver.render import RenderDriver
from rgk.scene.config import build_scene, load_config


def _cfg(tmp_path, rounds):
    cfg = {
        "output-file": "t.exr",
        "output-width": 8, "output-height": 8,
        "multisample": 2,
        "recursion-max": 2,
        "rounds": rounds,
        "russian": -1.0,
        "camera": {"position": [0, 2, 2], "lookat": [0, 0, 0], "fov": 60},
        "materials": [
            {"name": "floor", "brdf": "diffuse", "diffuse": [0.5, 0.5, 0.5]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [8, 1, 8],
             "material": "floor"},
        ],
        "lights": [{"position": [0, 3, 0], "color": [1, 1, 1],
                    "intensity": 10.0}],
        "sky": {"color": [0.2, 0.3, 0.4], "intensity": 1.0},
    }
    p = tmp_path / f"scene{rounds}.json"
    p.write_text(json.dumps(cfg))
    return load_config(str(p))


def _driver(cfg, arrays, meta):
    return RenderDriver(cfg.settings, arrays, meta, cfg.get_camera(),
                        seed=42)


def test_resume_matches_straight_run(tmp_path):
    cfg4 = _cfg(tmp_path, 4)
    cfg2 = _cfg(tmp_path, 2)
    arrays, meta, _ = build_scene(cfg4, build_bvh=False)

    out4 = str(tmp_path / "straight.exr")
    d_straight = _driver(cfg4, arrays, meta)
    d_straight.render_frame(out4)

    out2 = str(tmp_path / "resumed.exr")
    d_first = _driver(cfg2, arrays, meta)
    d_first.render_frame(out2)
    assert d_first.stats.rounds == 2

    d_resume = _driver(cfg4, arrays, meta)
    nr = d_resume.load_checkpoint(out2 + ".ckpt.npz")
    assert nr == 2
    d_resume.render_frame(out2)

    # Fresh rounds: the resumed run renders rounds 2 and 3, not 0 and 1
    # again — bitwise-identical to the straight 4-round accumulation.
    assert d_resume.stats.rounds == 4
    np.testing.assert_array_equal(
        np.asarray(d_resume.acc.sum), np.asarray(d_straight.acc.sum))
    np.testing.assert_array_equal(
        np.asarray(d_resume.acc.count), np.asarray(d_straight.acc.count))


def test_resume_checkpoint_not_duplicated(tmp_path):
    """The old bug: resume re-traced rounds 0..k-1, doubling the sum of
    the already-accumulated samples.  Guard against exact doubling."""
    cfg2 = _cfg(tmp_path, 2)
    cfg4 = _cfg(tmp_path, 4)
    arrays, meta, _ = build_scene(cfg4, build_bvh=False)

    out2 = str(tmp_path / "first.exr")
    d_first = _driver(cfg2, arrays, meta)
    d_first.render_frame(out2)
    first_sum = np.asarray(d_first.acc.sum).copy()

    d_resume = _driver(cfg4, arrays, meta)
    d_resume.load_checkpoint(out2 + ".ckpt.npz")
    d_resume.render_frame(out2)
    assert not np.allclose(np.asarray(d_resume.acc.sum), 2.0 * first_sum)
