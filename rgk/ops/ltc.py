"""Linearly Transformed Cosines: table fetch, PDF eval, sampling.

Lane-parallel port of the reference's LTC runtime (reference
src/LTC/ltc.cpp) over the extracted 64x64 fitted tables
(rgk/data/ltc_tables.npz, see tools/extract_ltc.py):

* bilinear fetch over (theta/(pi/2), sqrt(alpha)) with the reference's
  0.999 clamping (ltc.cpp get_bilinear:20-57);
* `pdf` — the BRDF value: amplitude * D(normalize(M^-1 v)) / Jacobian
  (ltc.cpp GetPDF:59-87), including the reference's *unnormalized*
  (Vi_cast, tangent, N) frame whose xy columns carry a sin(theta)
  scale — kept for behavioral parity;
* `sample` — pushes a cosine-hemisphere vector through M, clamps
  z >= 1e-4, rotates out, with theta floored at pi/4
  (ltc.cpp GetRandom:113-143).

All in the local shading frame (+Z normal).  Everything is
differentiable w.r.t. roughness (via the table interpolation weights).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import vecmath as vm

_SIZE = 64
_HALF_PI = 0.5 * 3.14159  # the reference's value, not np.pi/2


class LTCTables(NamedTuple):
    """Flattened LTC fit tables; kind 0 = Beckmann, 1 = GGX.

    Rows are indexed linearly as kind*4096 + theta*64 + alpha and each
    row packs the 3x3 matrix + amplitude: [2*64*64, 10], so each
    lookup is a single-axis row gather.
    """
    rows: jnp.ndarray  # f32 [2*64*64, 10] = (m.flatten(9), amp)


KIND_BECKMANN = 0
KIND_GGX = 1


@lru_cache(maxsize=1)
def _load_tables_np():
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "ltc_tables.npz")
    d = np.load(os.path.abspath(path))
    m = np.stack([d["beckmann_m"], d["ggx_m"]]).astype(np.float32)
    amp = np.stack([d["beckmann_amp"], d["ggx_amp"]]).astype(np.float32)
    rows = np.concatenate([m.reshape(-1, 9), amp.reshape(-1, 1)], axis=1)
    return rows


def load_tables() -> LTCTables:
    # Cache numpy (trace-safe) and convert per call: under jit the
    # conversion becomes a hoisted constant, never a leaked tracer.
    return LTCTables(rows=jnp.asarray(_load_tables_np()))


def fetch_bilinear(tables: LTCTables, kind, theta, alpha):
    """Bilinearly interpolated (M[...,3,3], amplitude[...]).

    kind: int32[...]; theta: radians [...]; alpha: roughness [...].
    """
    t = jnp.clip(theta / _HALF_PI, 0.0, 1.0)
    a = jnp.clip(jnp.sqrt(jnp.maximum(alpha, 0.0)), 0.0, 1.0)
    t = jnp.minimum(t, 0.999)
    a = jnp.minimum(a, 0.999)
    s = _SIZE - 1
    t1 = jnp.floor(t * s).astype(jnp.int32)
    a1 = jnp.floor(a * s).astype(jnp.int32)
    dt1 = t * s - t1.astype(jnp.float32)
    dt2 = 1.0 - dt1
    da1 = a * s - a1.astype(jnp.float32)
    da2 = 1.0 - da1

    base = kind * (_SIZE * _SIZE) + t1 * _SIZE + a1

    def row(off):
        return tables.rows[base + off]

    r11 = row(0)
    r12 = row(1)
    r21 = row(_SIZE)
    r22 = row(_SIZE + 1)
    w11 = (dt2 * da2)[..., None]
    w12 = (dt2 * da1)[..., None]
    w21 = (dt1 * da2)[..., None]
    w22 = (dt1 * da1)[..., None]
    blended = r11 * w11 + r12 * w12 + r21 * w21 + r22 * w22
    M = blended[..., 0:9].reshape(*blended.shape[:-1], 3, 3)
    A = blended[..., 9]
    return M, A


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _inv3(M, det):
    """Adjugate-based batched 3x3 inverse (elementwise, fuses into the
    surrounding shading code)."""
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c10 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c20 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    c21 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1),
    ], axis=-2)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    return adj * inv_det[..., None, None]


def _matvec(M, v):
    """Batched 3x3 M @ v as exact-f32 FMAs (a dot_general would run at
    TF32 on a GPU unless told otherwise)."""
    return (M[..., 0] * v[..., 0:1] + M[..., 1] * v[..., 1:2]
            + M[..., 2] * v[..., 2:3])


def _frame_unrotate(v_frame, v):
    """Apply the inverse of the reference's scaled (Vi_cast, tangent,
    N=+Z) frame to `v` (ltc.cpp GetPDF:64-72): xy components come out
    scaled by 1/sin^2(theta) relative to a pure rotation — parity with
    the reference's unnormalized columns."""
    fx, fy = v_frame[..., 0], v_frame[..., 1]
    s2 = jnp.maximum(fx * fx + fy * fy, 1e-12)
    x = (fx * v[..., 0] + fy * v[..., 1]) / s2
    y = (-fy * v[..., 0] + fx * v[..., 1]) / s2
    return jnp.stack([x, y, v[..., 2]], axis=-1)


def _frame_rotate(v_frame, v):
    """The forward scaled frame (ltc.cpp GetRandom:117-121)."""
    fx, fy = v_frame[..., 0], v_frame[..., 1]
    x = fx * v[..., 0] - fy * v[..., 1]
    y = fy * v[..., 0] + fx * v[..., 1]
    return jnp.stack([x, y, v[..., 2]], axis=-1)


def _safe_arccos(z):
    # arccos has infinite slope at |z| = 1; clamp strictly inside so
    # gradients stay finite (forward error < 1.5e-3 rad, below the
    # 64-bin table resolution).
    return jnp.arccos(jnp.clip(z, -1.0 + 1e-6, 1.0 - 1e-6))


def pdf(tables: LTCTables, kind, v_frame, v_eval, alpha):
    """LTC BRDF value: frame around `v_frame`, evaluated at `v_eval`
    (both local, +Z normal).  NOTE call-site convention: the reference
    BxDFLTC::value builds the frame around the *outgoing* vector and
    evaluates the *incoming* one (src/bxdf/bxdf.hpp:110-114)."""
    theta = _safe_arccos(v_frame[..., 2])
    M, amp = fetch_bilinear(tables, kind, theta, alpha)
    vr3 = _frame_unrotate(v_frame, v_eval)
    det = _det3(M)
    q = _matvec(_inv3(M, det), vr3)
    p = vm.safe_normalize(q)
    L = _matvec(M, p)
    l2 = jnp.sum(L * L, axis=-1)
    l3 = l2 * jnp.sqrt(jnp.maximum(l2, 1e-30))
    jac = det / jnp.maximum(l3, 1e-30)
    D = jnp.maximum(0.0, p[..., 2]) / 3.14159
    return amp * D / jnp.where(jnp.abs(jac) > 1e-20, jac, 1e-20)


def sample(tables: LTCTables, kind, v_in, alpha, rand_hscos):
    """Sample an outgoing direction: M @ cosine-hemisphere vector,
    z clamped, rotated into the frame around `v_in`; theta floored at
    pi/4 for the table fetch (ltc.cpp GetRandom:123)."""
    theta = _safe_arccos(v_in[..., 2])
    theta = jnp.maximum(theta, jnp.pi / 4.0)
    M, _ = fetch_bilinear(tables, kind, theta, alpha)
    s = _matvec(M, rand_hscos)
    s = s.at[..., 2].set(jnp.maximum(s[..., 2], 1e-4))
    s = _frame_rotate(v_in, s)
    return vm.safe_normalize(s)
