"""Batched 3-vector math for wavefronts of rays.

All functions operate on arrays shaped ``[..., 3]`` and are written to be
traced under ``jit``/``vmap``/``grad``.  This is the wavefront
counterpart of the reference's scalar glm helpers (reference
src/glm.hpp/.cpp): instead of quaternion rotations per ray we build
orthonormal shading frames branchlessly for whole lanes at once.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-20


def take_rows(table2d, idx):
    """Gather whole rows of a 2-D table: a plain gather, exact for
    every dtype and differentiable in the table values."""
    return table2d[idx]


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), EPS))


def length2(v, keepdims: bool = False):
    return dot(v, v, keepdims=keepdims)


def normalize(v):
    return v / length(v, keepdims=True)


def safe_normalize(v, fallback=None):
    """Normalize; lanes with ~zero length get `fallback` (default +Z)."""
    l2 = dot(v, v, keepdims=True)
    ok = l2 > 1e-24
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.maximum(l2, 1e-24)), 0.0)
    out = v * inv
    if fallback is None:
        fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    return jnp.where(ok, out, fallback)


def distance2(a, b):
    d = a - b
    return dot(d, d)


def reflect_z(v):
    """Mirror reflection about the local +Z axis: (x,y,z) -> (-x,-y,z).

    Matches the reference mirror BxDF convention (reference
    src/bxdf/bxdf.cpp BxDFMirror::sample).
    """
    return v * jnp.asarray([-1.0, -1.0, 1.0], dtype=v.dtype)


def build_onb(n):
    """Branchless orthonormal basis (t, b) around unit normal `n`.

    Duff et al. 2017, "Building an Orthonormal Basis, Revisited" —
    stable for all normals without branches, ideal for SIMD lanes.
    Returns (tangent, bitangent), each ``[..., 3]``.

    Any deterministic rotation taking n -> +Z is equivalent for the
    isotropic BxDFs used here (the reference uses a quaternion pair,
    src/glm.hpp SystemTransform; azimuth convention is free).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bt


def to_local(n, t, b, v):
    """World -> local shading frame (+Z = n)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_global(n, t, b, v):
    """Local shading frame -> world."""
    return (
        v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n
    )


def rotation_from_y(dest, v):
    """Rotate `v` by the rotation that takes +Y to `dest` (unit).

    Port of the reference's quaternion shortcut (reference
    src/glm.cpp RotationFromY) in branchless matrix form: used by the
    directed hemisphere warps so light-path emission directions match
    the reference's distribution exactly.
    """
    d = dest
    c = d[..., 1:2]  # cos(theta) = dot(+Y, dest)
    # rotation axis = cross(+Y, dest) = (d.z, 0, -d.x), not normalized
    ax = d[..., 2:3]
    az = -d[..., 0:1]
    # Rodrigues with axis a (unnormalized, |a| = sin) — handle near-(-Y)
    s2 = ax * ax + az * az
    safe = s2 > 1e-12
    k = jnp.where(safe, (1.0 - c) / jnp.maximum(s2, 1e-12), 0.0)
    vx, vy, vz = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    # cross(a, v) with a = (ax, 0, az)
    cx = -az * vy
    cy = az * vx - ax * vz
    cz = ax * vy
    adotv = ax * vx + az * vz
    rx = vx * c + cx + ax * adotv * k
    ry = vy * c + cy
    rz = vz * c + cz + az * adotv * k
    rot = jnp.concatenate([rx, ry, rz], axis=-1)
    # dest ~ -Y: rotate pi around +X => (x, -y, -z)
    flip = jnp.concatenate([vx, -vy, -vz], axis=-1)
    return jnp.where(safe, rot, jnp.where(c > 0.0, v, flip))
