"""Numerical parity of the LTC runtime against the reference renderer.

tests/goldens/ltc_inputs.npy + ltc_ref.npy are produced by
tools/make_ltc_goldens.py: the REFERENCE's own LTC::GetPDF /
LTC::GetRandom (reference src/LTC/ltc.cpp:59-143, compiled locally via
tools/refbuild) evaluated with N = +Z on a deterministic grid of
(kind, Vi, Vr, alpha, rand_hscos) rows.  These pin:

* the bilinear table fetch incl. the 0.999 clamps (ltc.cpp:20-57),
* the unnormalized (Vi_cast, tangent, N) frame whose xy columns carry
  a sin(theta) scale (ltc.cpp:64-72),
* the amplitude * D / Jacobian PDF (ltc.cpp:73-86),
* GetRandom's pi/4 theta floor and z >= 1e-4 clamp (ltc.cpp:123-137).

LTC-GGX-diffuse is the material every imported mesh gets (reference
src/bxdf/bxdf.cpp:141-180), so this grid protects every OBJ golden.
"""

import os

import numpy as np
import pytest

from rgk.ops import ltc

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


@pytest.fixture(scope="module")
def grid():
    in_path = os.path.join(GOLDEN_DIR, "ltc_inputs.npy")
    ref_path = os.path.join(GOLDEN_DIR, "ltc_ref.npy")
    if not (os.path.exists(in_path) and os.path.exists(ref_path)):
        pytest.skip("LTC goldens not generated (tools/make_ltc_goldens.py)")
    return np.load(in_path), np.load(ref_path)


def test_pdf_matches_reference(grid):
    inp, ref = grid
    tables = ltc.load_tables()
    kind = inp[:, 0].astype(np.int32)
    vi, vr, alpha = inp[:, 1:4], inp[:, 4:7], inp[:, 7]
    ours = np.asarray(ltc.pdf(tables, kind, vi, vr, alpha))
    want = ref[:, 0]
    # f32 all the way down on both sides; the reference converts its
    # double tables to float per fetch.  Mixed tolerance: relative for
    # the body, absolute near the D(Loriginal.z<=0) zero cut.
    np.testing.assert_allclose(ours, want, rtol=2e-3, atol=2e-4)


def test_sample_matches_reference(grid):
    inp, ref = grid
    tables = ltc.load_tables()
    kind = inp[:, 0].astype(np.int32)
    vi, alpha, rnd = inp[:, 1:4], inp[:, 7], inp[:, 8:11]
    ours = np.asarray(ltc.sample(tables, kind, vi, alpha, rnd))
    want = ref[:, 1:4]
    np.testing.assert_allclose(ours, want, rtol=2e-3, atol=2e-4)


def test_density_integrates_to_amplitude():
    """Energy self-consistency of the table + Jacobian math: the raw
    Z-frame LTC density amp * D(normalize(M^-1 v)) / J integrates over
    the sphere to the amplitude (the classic LTC norm property; the
    reference's GetPDFZ form, ltc.cpp:90-110).  The frame-carrying
    pdf() additionally applies the reference's unnormalized
    (Vi_cast, tangent, N) frame whose sin(theta)-scaled columns distort
    the density off-normal — a deliberate behavioral-parity quirk
    covered by test_pdf_matches_reference instead."""
    tables = ltc.load_tables()
    n_th, n_ph = 256, 256
    th = (np.arange(n_th) + 0.5) * np.pi / n_th
    ph = (np.arange(n_ph) + 0.5) * 2 * np.pi / n_ph
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    vr = np.stack([np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH),
                   np.cos(TH)], axis=-1).reshape(-1, 3).astype(np.float32)
    dw = (np.sin(TH) * (np.pi / n_th) * (2 * np.pi / n_ph)).reshape(-1)
    for kind in (ltc.KIND_BECKMANN, ltc.KIND_GGX):
        for theta_i, alpha in ((0.3, 0.11), (0.9, 0.3), (1.2, 0.6)):
            M, amp = ltc.fetch_bilinear(
                tables, kind, np.float32(theta_i), np.float32(alpha))
            det = ltc._det3(M)
            q = ltc._matvec(ltc._inv3(M, det)[None], vr)
            p = np.asarray(q) / np.linalg.norm(
                np.asarray(q), axis=-1, keepdims=True)
            L = ltc._matvec(M[None], p)
            l3 = np.linalg.norm(np.asarray(L), axis=-1) ** 3
            jac = float(det) / np.maximum(l3, 1e-30)
            d = np.maximum(0.0, p[..., 2]) / 3.14159
            vals = float(amp) * d / jac
            total = float((vals * dw).sum())
            assert abs(total - float(amp)) < 0.02 * max(float(amp), 0.1), (
                kind, theta_i, alpha, total, float(amp))
