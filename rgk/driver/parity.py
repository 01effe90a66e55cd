"""Correctness gates shared by the tests, `bench.py` and `chip_smoke.py`.

* `compare_hits` — an intersection kernel's hit records against its
  plain-JAX oracle on the same rays.
* `image_parity` / `compare_images` — a frame rendered on the
  accelerator against the same frame rendered on the host CPU at
  identical (seed, pixel, sample): a traversal or shading bug that
  biased hits would pass a throughput run but fail here (oracle
  pairing in the spirit of comparing against the reference's own EXR
  output, reference src/texture.cpp:356-374).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

# Hit records agree to this relative error (see compare_hits).
HIT_RTOL = 1e-5
# At least this share of lanes must name the same triangle.
HIT_MIN_AGREE = 0.9999
# image_parity: a pixel value differing by less than this, relative to
# its own magnitude plus the image mean, is float32 noise, not an
# outlier.
OUTLIER_RTOL = 1e-3


def _rel_scale(ro, rd, t, rows):
    """Magnitudes against which t, b and c are relative.

    Each of the three is a sum of products (scene/builder
    build_tri_pack); a float32 sum is exact only relative to the sum
    of its terms' magnitudes, which cancellation can make far larger
    than the result."""
    n, d = rows[:, 0:3], rows[:, 3]
    rddn = np.abs(np.sum(rd * n, axis=1))
    t_scale = np.maximum(np.abs(t), (np.sum(np.abs(ro * n), axis=1)
                                     + np.abs(d)) / np.maximum(rddn, 1e-30))
    p = ro + t[:, None] * rd
    b_scale = np.abs(rows[:, 4]) + np.sum(np.abs(p * rows[:, 5:8]), axis=1)
    c_scale = np.abs(rows[:, 8]) + np.sum(np.abs(p * rows[:, 9:12]), axis=1)
    return t_scale, b_scale, c_scale


def compare_hits(got, want, tri_pack, ro, rd, diameter: float,
                 any_hit: bool = False) -> dict:
    """Compare two `Hit` records of the same rays.

    * The triangle index agrees on at least HIT_MIN_AGREE of lanes.
    * Where it differs, the hit is a tie: both t within 1e-5 of the
      scene diameter (two triangles sharing an edge, or overlapping).
    * Where it agrees, t, b and c agree to HIT_RTOL relative to the
      magnitude of the terms they are summed from (`_rel_scale`).

    With `any_hit`, only hit/no-hit is compared: the triangle is a
    witness, not the closest.  Returns the statistics and `ok`."""
    g_tri, w_tri = np.asarray(got.tri), np.asarray(want.tri)
    if any_hit:
        same = (g_tri >= 0) == (w_tri >= 0)
        return dict(lanes=int(same.size), agree=float(same.mean()),
                    hit_rate=float((w_tri >= 0).mean()),
                    ok=bool(same.mean() >= HIT_MIN_AGREE))
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    g_t = np.asarray(got.t, np.float64)
    w_t = np.asarray(want.t, np.float64)
    same = g_tri == w_tri
    differ = ~same
    tie_tol = 1e-5 * diameter
    ties = differ & (g_tri >= 0) & (w_tri >= 0) & (np.abs(g_t - w_t)
                                                   <= tie_tol)
    hit = same & (w_tri >= 0)
    rows = np.asarray(tri_pack, np.float64)[w_tri[hit]]
    ts, bs, cs = _rel_scale(ro[hit], rd[hit], w_t[hit], rows)
    err = {}
    for name, scale in (("t", ts), ("bary_b", bs), ("bary_c", cs)):
        d = np.abs(np.asarray(getattr(got, name), np.float64)[hit]
                   - np.asarray(getattr(want, name), np.float64)[hit])
        err[name] = float((d / np.maximum(scale, 1e-30)).max()) \
            if d.size else 0.0
    ok = (same.mean() >= HIT_MIN_AGREE and int(ties.sum()) == int(
        differ.sum()) and max(err.values()) <= HIT_RTOL)
    return dict(lanes=int(same.size), agree=float(same.mean()),
                hit_rate=float((w_tri >= 0).mean()),
                differ=int(differ.sum()), ties=int(ties.sum()),
                max_rel_err=err, ok=bool(ok))


def image_parity(arrays, meta, settings, camera, res: int = 64,
                 ms: int = 4, depth: int = 3) -> dict:
    """Render a small frame on the default device and on the host CPU
    at identical (seed, pixel, sample) and compare the images.

    Gate (all must hold): 1%-trimmed correlation > 0.998, full
    correlation > 0.98, mean relative difference < 5%, and no single
    8x8 pixel tile may hold more outlier pixels (trimmed away and
    beyond OUTLIER_RTOL) than a quarter of the trimmed-away pixels —
    so a localized systematic defect cannot hide inside the trimmed
    1%.

    Returns the statistics and `ok`."""
    import jax

    from .render import RenderDriver

    s = copy.deepcopy(settings)
    s.xres = s.yres = res
    s.multisample = ms
    s.recursion_max = depth
    cam = dataclasses.replace(camera, xres=res, yres=res)

    def render(device):
        with jax.default_device(device):
            local = jax.device_put(arrays, device)
            d = RenderDriver(s, local, meta, cam)
            d.render_round(0)
            d.fetch_accumulation()
            return np.asarray(d.acc.sum, np.float64)

    return compare_images(render(jax.devices()[0]),
                          render(jax.devices("cpu")[0]))


def compare_images(img, ref) -> dict:
    """The gate of `image_parity` on two [H, W, 3] images: `img`
    against the reference `ref`.  Returns the statistics and `ok`."""
    a = np.asarray(img, np.float64).ravel()
    b = np.asarray(ref, np.float64).ravel()
    width = np.shape(ref)[1]
    corr = float(np.corrcoef(a, b)[0, 1])
    # Tie-level hit decisions at high-emission edges can flip a handful
    # of samples between the two float pipelines (stochastic, not
    # systematic), so the systematic gate is the trimmed correlation
    # and the full correlation only bounds the outlier mass.
    d = np.abs(a - b)
    order = np.argsort(d)
    keep = order[:int(len(d) * 0.99)]
    corr_trim = float(np.corrcoef(a[keep], b[keep])[0, 1])
    rel = float(d.mean() / max(b.mean(), 1e-9))
    # Stochastic tie flips scatter across the frame; a systematic bug
    # confined to one region concentrates there.  Trimmed-away values
    # that agree to float32 accumulation noise are not outliers: when
    # the two images match to rounding, the largest differences sit
    # where the radiance is largest (the light) and would always look
    # clustered.
    tail = order[int(len(d) * 0.99):]
    tile_cap = max(8, len(np.unique(tail // 3)) // 4)
    tail = tail[d[tail] > OUTLIER_RTOL * (np.abs(b[tail]) + b.mean())]
    pix = np.unique(tail // 3)
    tiles = (pix // width // 8) * ((width + 7) // 8) + (pix % width) // 8
    max_tile = int(np.bincount(tiles).max()) if len(tiles) else 0
    ok = (corr_trim > 0.998 and corr > 0.98 and rel < 0.05
          and max_tile <= tile_cap)
    return dict(corr=corr, corr_trimmed=corr_trim, mean_rel_diff=rel,
                outlier_pixels=int(len(pix)),
                max_outliers_per_tile=max_tile, tile_cap=tile_cap,
                ok=bool(ok))
