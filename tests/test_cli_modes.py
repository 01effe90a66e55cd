"""Driver/CLI mode coverage: preview, timed, compare, no-overwrite,
orbit animation, resume (reference src/main.cpp:58-260,
render_driver.cpp:227-248).

Each test drives `rgk.driver.cli.main` in-process on the CPU
backend with a tiny analytic scene, so the full argument plumbing,
frame loop and file handling run for real.
"""

import json
import os

import numpy as np
import pytest

from rgk.driver import cli
from rgk.io.exr import read_exr


@pytest.fixture()
def tiny_scene(tmp_path):
    cfg = {
        "output-file": "out.exr",
        "output-width": 32, "output-height": 32,
        "multisample": 1, "rounds": 1, "recursion-max": 2,
        "russian": -1.0,
        "camera": {"position": [0, 1, 2.5], "lookat": [0, 0.3, 0],
                   "fov": 50},
        "sky": {"color": [0.2, 0.3, 0.4]},
        "materials": [
            {"name": "floor", "brdf": "diffuse",
             "diffuse": [0.5, 0.5, 0.5]},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [4, 1, 4],
             "material": "floor"},
            {"primitive": "cube", "translate": [0, 0.3, 0],
             "scale": [0.6, 0.6, 0.6], "material": "floor"},
        ],
        "lights": [{"position": [1, 2, 1], "color": [1, 1, 1],
                    "intensity": 3.0}],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(cfg))
    return str(p), str(tmp_path)


def _run(args):
    assert cli.main(args) == 0


def test_cli_basic_render(tiny_scene):
    cfg, d = tiny_scene
    _run([cfg, "-D", d, "-q", "--cpu"])
    img = np.asarray(read_exr(os.path.join(d, "out.exr")))
    assert img.shape[:2] == (32, 32) and img.max() > 0


def test_cli_preview_quarters_resolution(tiny_scene):
    """-p renders at dims/4 and ms/2 (reference main.cpp preview,
    global_config.hpp:10-12)."""
    cfg, d = tiny_scene
    _run([cfg, "-p", "-D", d, "-q", "--cpu"])
    img = np.asarray(read_exr(os.path.join(d, "out.exr")))
    assert img.shape[:2] == (8, 8)


def test_cli_timed_mode_stops(tiny_scene):
    """-t MIN runs the timed loop (render_driver.cpp:227-248): with a
    ~0 budget it must stop after the first round and still write the
    EXR."""
    cfg, d = tiny_scene
    _run([cfg, "-t", "0.0001", "-D", d, "-q", "--cpu"])
    img = np.asarray(read_exr(os.path.join(d, "out.exr")))
    assert img.max() > 0


def test_cli_compare_suffix(tiny_scene):
    """-c renames the output to *.cmp.exr (reference
    main.cpp:129-131, 196)."""
    cfg, d = tiny_scene
    _run([cfg, "-c", "-D", d, "-q", "--cpu"])
    assert os.path.exists(os.path.join(d, "out.cmp.exr"))
    assert not os.path.exists(os.path.join(d, "out.exr"))


def test_cli_no_overwrite_skips(tiny_scene):
    """--no-overwrite skips frames whose output exists — the
    reference's shared-FS multi-machine farming hack
    (main.cpp:242-245)."""
    cfg, d = tiny_scene
    target = os.path.join(d, "out.exr")
    with open(target, "wb") as f:
        f.write(b"sentinel")
    _run([cfg, "--no-overwrite", "-D", d, "-q", "--cpu"])
    with open(target, "rb") as f:
        assert f.read() == b"sentinel"  # untouched


def test_cli_orbit_animation(tiny_scene, monkeypatch):
    """-r renders the orbit animation, one file per frame with the
    camera rotated about the lookat (reference main.cpp frames loop +
    config.cpp GetCamera(t):357-359)."""
    cfg, d = tiny_scene
    monkeypatch.setattr(cli, "ANIMATION_FRAMES", 2)
    _run([cfg, "-r", "-D", d, "-q", "--cpu"])
    f0 = np.asarray(read_exr(os.path.join(d, "out.0000.exr")))
    f1 = np.asarray(read_exr(os.path.join(d, "out.0001.exr")))
    assert f0.shape == f1.shape
    # Half an orbit moves the camera: the frames must differ.
    assert not np.array_equal(f0, f1)


def test_cli_resume_continues_rounds(tiny_scene):
    """--resume restores (sum, count, round) from the checkpoint and
    traces FRESH samples: a 1-round run resumed into a 2-round config
    must end with 2 rounds accumulated, matching an uninterrupted
    2-round run bitwise (SURVEY §5 checkpoint/resume)."""
    cfg, d = tiny_scene
    _run([cfg, "-D", d, "-q", "--cpu"])               # round 0
    ck = os.path.join(d, "out.exr.ckpt.npz")
    assert os.path.exists(ck)
    assert int(np.load(ck)["next_round"]) == 1

    # Bump the config to 2 rounds and resume.
    with open(cfg) as f:
        c = json.load(f)
    c["rounds"] = 2
    with open(cfg, "w") as f:
        json.dump(c, f)
    _run([cfg, "--resume", "-D", d, "-q", "--cpu"])
    resumed = np.asarray(read_exr(os.path.join(d, "out.exr")))
    assert int(np.load(ck)["next_round"]) == 2

    # Uninterrupted 2-round reference in a fresh directory.
    d2 = os.path.join(d, "ref")
    os.makedirs(d2)
    _run([cfg, "-D", d2, "-q", "--cpu"])
    straight = np.asarray(read_exr(os.path.join(d2, "out.exr")))
    np.testing.assert_array_equal(resumed, straight)
