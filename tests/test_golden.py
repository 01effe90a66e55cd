"""Golden-image parity against the reference renderer (RGKrt).

The goldens under tests/goldens/ are REFERENCE renders: the reference
renderer itself, compiled locally from the reference's src/ by
tools/refbuild/build.sh, rendered small-res high-spp variants of its
own scene corpus (tools/make_goldens.py), and its OpenEXR output
(reference src/texture.cpp:356-374) was dumped to .npy with exr2npy.

    cornell-box_96.npy          96x96 @ 4096 spp  (analytic prims, NEE)
    cornell-box-spheres_96.npy  96x96 @ 4096 spp  (sphere.obj mesh, LTC
                                                   Beckmann, dielectric)
    rubiks-bump_96.npy          96x96 @ 1024 spp  (OBJ model, textures,
                                                   bump map, point light)
    box2_96.npy                 96x96 @ 4096 spp  (bidirectional,
                                                   reverse=4)

Each test renders the same scene through our pipeline and compares
mean-normalized images (normalization cancels the reference's
auto-exposure write scaling, texture.cpp:376-400).  Two assertions:

* full-res Pearson correlation — bounds structural agreement;
* mean |diff| after 4x4 box downsampling — bounds systematic bias
  with per-pixel Monte-Carlo noise averaged down ~4x.

Both renderers integrate the pixel area with a box filter (jittered
samples), so 2x2 box-downsampling a 96^2 golden equals a 48^2 golden
in expectation — used where the CPU test budget wants quarter-res.

Tolerances are ~2x the measured agreement at these budgets; they
catch wrong-BRDF / wrong-transform / wrong-radiometry regressions,
not noise.
"""

import os

import numpy as np
import pytest

from rgk.driver.render import RenderDriver
from rgk.scene.config import build_scene, load_config

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
from conftest import REFERENCE_SCENES as SCENES  # noqa: E402


def load_golden(name: str, res: int) -> np.ndarray:
    path = os.path.join(GOLDEN_DIR, f"{name}_96.npy")
    if not os.path.exists(path):
        pytest.skip(f"golden {path} not generated "
                    "(tools/make_goldens.py)")
    g = np.load(path)[..., :3].astype(np.float64)
    while g.shape[0] > res:
        h = g.shape[0] // 2
        g = g.reshape(h, 2, h, 2, 3).mean(axis=(1, 3))
    return g


def render_ours(name: str, res: int, ms: int, rounds: int = 1,
                build_bvh: bool = True) -> np.ndarray:
    cfg = load_config(os.path.join(SCENES, f"{name}.json"))
    s = cfg.settings
    s.xres = s.yres = res
    s.multisample = ms
    s.rounds = rounds
    arrays, meta, _ = build_scene(cfg, build_bvh=build_bvh)
    cam = cfg.get_camera()
    driver = RenderDriver(s, arrays, meta, cam)
    for r in range(rounds):
        driver.render_round(r)
    driver.fetch_accumulation()
    return driver.acc.sum / driver.acc.count[..., None]


def assert_matches_golden(name: str, img: np.ndarray, *,
                          min_corr: float, max_bias: float) -> None:
    res = img.shape[0]
    g = load_golden(name, res)
    a = img / img.mean()
    b = g / g.mean()
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    k = 4
    n = res // k
    d4 = np.abs(a.reshape(n, k, n, k, 3).mean(axis=(1, 3))
                - b.reshape(n, k, n, k, 3).mean(axis=(1, 3)))
    bias = float(d4.mean())
    assert corr >= min_corr, (name, corr, min_corr)
    assert bias <= max_bias, (name, bias, max_bias)


@pytest.fixture(autouse=True)
def _need_corpus(reference_scenes):
    return reference_scenes


@pytest.mark.timeout(600)
def test_golden_cornell_box():
    """Flagship config: analytic primitives, areal light, NEE, RR
    (reference scenes/cornell-box.json; measured agreement at this
    budget: corr 0.9995, bias 0.010)."""
    img = render_ours("cornell-box", 96, ms=128, rounds=2,
                      build_bvh=False)
    assert_matches_golden("cornell-box", img,
                          min_corr=0.998, max_bias=0.022)


@pytest.mark.timeout(600)
def test_golden_cornell_box_spheres():
    """Mesh import (meshes/sphere.obj through the OBJ loader), LTC
    Beckmann roughness 0.11, dielectric ior 1.5 — pins mini-assimp /
    OBJ-loader fidelity and the LTC + Fresnel paths."""
    img = render_ours("cornell-box-spheres", 48, ms=96)
    assert_matches_golden("cornell-box-spheres", img,
                          min_corr=0.99, max_bias=0.05)


@pytest.mark.timeout(600)
def test_golden_rubiks_bump():
    """model-file OBJ with PNG textures + bump mapping (bumpscale 15)
    + point light (reference scenes/rubiks-bump.json)."""
    img = render_ours("rubiks-bump", 48, ms=96)
    assert_matches_golden("rubiks-bump", img,
                          min_corr=0.99, max_bias=0.05)


@pytest.mark.timeout(600)
def test_golden_box2_bdpt():
    """Bidirectional mode (reverse=4): light-path camera splats +
    eye x light connections (reference path_tracer.cpp:367-398,
    463-480) against the reference's own BDPT render.

    Quarter-res with high spp: the BDPT eye x light connection loop
    is the most expensive CPU test in the suite, and 24^2 @ 128 spp
    (measured corr 0.983, bias 0.014) fits the test budget where
    48^2 @ 64 spp timed out cold-cache."""
    img = render_ours("box2", 24, ms=128)
    assert_matches_golden("box2", img, min_corr=0.97, max_bias=0.05)


@pytest.mark.skipif(
    not os.environ.get("RGK_FULL_GOLDEN"),
    reason="full-res BDPT golden: ~10 min on 2-vCPU CI; run with "
           "RGK_FULL_GOLDEN=1")
@pytest.mark.timeout(1800)
def test_golden_box2_bdpt_96():
    """The production-resolution BDPT pin: box2
    at the golden's FULL 96x96 with 64 spp, corr >= 0.98 — at 4x the
    pixel count this bounds structure a splat-weighting or
    connection-MIS bias could still hide under the quarter-res
    test's 0.97."""
    # 16 rounds x 4 spp: the BDPT wavefront is per-(pixel, sample),
    # and 96^2 x 64 lanes of [R, M] brute planes would not fit hosts.
    img = render_ours("box2", 96, ms=4, rounds=16)
    assert_matches_golden("box2", img, min_corr=0.98, max_bias=0.045)
