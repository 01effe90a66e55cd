"""The image parity gate (rgk/driver/parity.py) on synthetic images."""

import numpy as np

from rgk.driver.parity import compare_images


def _frame(seed=0, res=64):
    rng = np.random.default_rng(seed)
    img = rng.gamma(2.0, 0.1, (res, res, 3))
    img[:6, 28:36] = 100.0          # a bright light in one tile
    return img


def test_identical_frames_pass():
    img = _frame()
    assert compare_images(img, img)["ok"]


def test_float_noise_at_the_light_is_not_an_outlier():
    """Rounding-level differences concentrate where radiance is
    largest; they must not trip the clustering bound."""
    ref = _frame()
    img = ref * (1.0 + 1e-6 * np.random.default_rng(1).standard_normal(
        ref.shape))
    stats = compare_images(img, ref)
    assert stats["ok"], stats
    assert stats["outlier_pixels"] == 0


def test_scattered_sample_flips_pass():
    ref = _frame()
    img = ref.copy()
    rng = np.random.default_rng(2)
    flat = img.reshape(-1, 3)
    idx = rng.choice(len(flat), 30, replace=False)
    flat[idx] += rng.uniform(0.5, 2.0, (30, 3))
    assert compare_images(img, ref)["ok"]


def test_localized_defect_fails():
    """A wrong 8x8 block (e.g. a traversal bug in one subtree) fails
    even when global correlation stays high."""
    ref = _frame()
    img = ref.copy()
    img[40:48, 8:16] *= 3.0
    stats = compare_images(img, ref)
    assert not stats["ok"], stats


def test_global_bias_fails():
    ref = _frame()
    assert not compare_images(ref * 1.1, ref)["ok"]
