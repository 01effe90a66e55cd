"""Integrator smoke renders for branches the goldens don't reach.

Golden-image tests (test_golden.py) pin cornell-box / spheres /
rubiks-bump / box2 against the reference renderer; the corpus test
only *builds* scenes.  These render small frames through the
remaining integrator branches — depth-of-field (thin-lens camera,
reference camera.cpp:39-46), and the mirror / mix / transparent
BxDFs (reference bxdf.cpp:265-276, 221-249, 412-423) that no
buildable corpus scene with in-repo assets exercises.
"""

import json
import os

import numpy as np
import pytest

from rgk.driver.render import RenderDriver
from rgk.scene.config import build_scene, load_config

from conftest import REFERENCE_SCENES

CUBE3B = os.path.join(REFERENCE_SCENES, "cube3-b.json")


def _render(cfg, rounds=1):
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    driver = RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())
    for r in range(rounds):
        driver.render_round(r)
    driver.stats.rounds = rounds
    driver.fetch_accumulation()
    cnt = np.maximum(driver.acc.count, 1.0)[..., None]
    return np.asarray(driver.acc.sum / cnt, np.float32)


@pytest.mark.timeout(600)
def test_dof_lens_scene_renders():
    """cube3-b.json: thin-lens camera (lens-size) + LTC materials over
    an 9k-triangle mesh; the only corpus config with depth of field
    that has all assets in-repo."""
    if not os.path.exists(CUBE3B):
        pytest.skip("reference corpus not available")
    cfg = load_config(CUBE3B)
    s = cfg.settings
    s.xres = s.yres = 32
    s.multisample = 2
    s.recursion_max = 3
    assert cfg.get_camera().lens_size > 0.0, \
        "cube3-b must exercise the thin lens"
    img = _render(cfg)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0
    assert (img.sum(axis=-1) > 0).mean() > 0.3


@pytest.mark.timeout(600)
def test_mirror_mix_transparent_render(tmp_path):
    """Mirror, mix(diffuse,mirror) and transparent floor panels seen
    from above: drives the delta-BxDF sampling paths end-to-end.
    The mirror panel reflects the sky upward; the transparent panel
    passes through to the diffuse floor underneath."""
    cfg_d = {
        "output-file": "t.exr", "output-width": 48, "output-height": 48,
        "multisample": 8, "recursion-max": 4, "russian": -1.0,
        "camera": {"position": [0, 3.0, 0.001], "lookat": [0, 0, 0],
                   "fov": 60},
        "sky": {"color": [0.4, 0.5, 0.6], "intensity": 1.0},
        "materials": [
            {"name": "white", "brdf": "diffuse",
             "diffuse": [0.7, 0.7, 0.7]},
            {"name": "chrome", "brdf": "mirror",
             "specular": [0.9, 0.9, 0.9]},
            {"name": "blend", "brdf": "mix", "material1": "white",
             "material2": "chrome", "amount": 0.5},
            {"name": "glassy", "brdf": "transparent"},
        ],
        "scene": [
            {"primitive": "plane", "axis": "Y", "scale": [8, 1, 8],
             "material": "white"},
            {"primitive": "plane", "axis": "Y",
             "translate": [-1.0, 0.4, 0], "scale": [0.6, 1, 0.6],
             "material": "chrome"},
            {"primitive": "plane", "axis": "Y",
             "translate": [1.0, 0.4, 0], "scale": [0.6, 1, 0.6],
             "material": "blend"},
            {"primitive": "plane", "axis": "Y",
             "translate": [0, 0.4, 1.0], "scale": [0.5, 1, 0.5],
             "material": "glassy"},
        ],
        "lights": [{"position": [2, 5, 2], "color": [1, 1, 1],
                    "intensity": 8.0}],
    }
    p = tmp_path / "mirrormix.json"
    p.write_text(json.dumps(cfg_d))
    cfg = load_config(str(p))
    img = _render(cfg, rounds=2)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0
    # Every lane lands on the floor or a panel; nothing may be black.
    assert (img.sum(axis=-1) > 0).mean() > 0.95
    # The mirror panel (left of center) reflects the sky: blue-ish,
    # clearly distinct from the warm lit floor.
    h, w = img.shape[:2]
    mirror_px = img[h // 2 - 2:h // 2 + 2, w // 4 - 2:w // 4 + 2]
    assert mirror_px.max() > 0.01
    sky_ratio = mirror_px[..., 2].mean() / (mirror_px[..., 0].mean() + 1e-9)
    assert sky_ratio > 1.05, "mirror panel should reflect the blue-ish sky"
