"""Device-side texture sampling over the flat atlas.

Lane-parallel equivalents of the reference's texture fetches:
bilinear with repeat-wrap and half-texel offset (reference
src/texture.cpp GetPixelInterpolated:35-77), bump-map finite
differences (GetSlopeRight/Bottom:79-102), and the lat-long sky lookup
(src/scene.cpp GetSkyboxRay:748-763).

Each lane can address a *different* texture: descriptors (offset,
width, height) are gathered first, then four texel gathers complete
the bilinear tap.  All fetches are differentiable w.r.t. the texel
buffer — texture optimization comes for free.
"""

from __future__ import annotations

import jax.numpy as jnp


def _wrap01(x):
    return x - jnp.floor(x)


def _fetch(texels, offset, w, h, ix, iy):
    ix = jnp.clip(ix, 0, w - 1)
    iy = jnp.clip(iy, 0, h - 1)
    return texels[offset + iy * w + ix]


def sample_bilinear(atlas, tex_id, uv):
    """Bilinear fetch; tex_id int32[...] (>=0), uv f32[...,2].

    Matches the reference's indexing: u wraps, pixel centers at
    (i+0.5)/size, edge rows clamped (texture.cpp:35-77).
    """
    desc = atlas.desc[jnp.maximum(tex_id, 0)]
    offset, w, h = desc[..., 0], desc[..., 1], desc[..., 2]
    x = _wrap01(uv[..., 0]) * w.astype(jnp.float32) - 0.5
    y = _wrap01(uv[..., 1]) * h.astype(jnp.float32) - 0.5
    ix0 = jnp.floor(x).astype(jnp.int32)
    iy0 = jnp.floor(y).astype(jnp.int32)
    fx = x - ix0.astype(jnp.float32)
    fy = y - iy0.astype(jnp.float32)
    ix1 = jnp.where(ix0 != w - 1, ix0 + 1, ix0)
    iy1 = jnp.where(iy0 != h - 1, iy0 + 1, iy0)
    ix0 = jnp.maximum(ix0, 0)
    iy0 = jnp.maximum(iy0, 0)
    c00 = _fetch(atlas.texels, offset, w, h, ix0, iy0)
    c01 = _fetch(atlas.texels, offset, w, h, ix1, iy0)
    c10 = _fetch(atlas.texels, offset, w, h, ix0, iy1)
    c11 = _fetch(atlas.texels, offset, w, h, ix1, iy1)
    fx = fx[..., None]
    fy = fy[..., None]
    c0 = c00 * (1.0 - fx) + c01 * fx
    c1 = c10 * (1.0 - fx) + c11 * fx
    return c0 * (1.0 - fy) + c1 * fy


def resolve_color(atlas, tex_id, solid_color, uv):
    """Texture when tex_id >= 0, else the solid color."""
    tex = sample_bilinear(atlas, tex_id, uv)
    return jnp.where((tex_id >= 0)[..., None], tex, solid_color)


def bump_slopes(atlas, tex_id, uv):
    """(slope_right, slope_bottom) nearest-neighbor luma differences
    (texture.cpp:79-102): a - b where b is the next texel right/down."""
    desc = atlas.desc[jnp.maximum(tex_id, 0)]
    offset, w, h = desc[..., 0], desc[..., 1], desc[..., 2]
    x = (_wrap01(uv[..., 0]) * w.astype(jnp.float32) - 0.5)
    y = (_wrap01(uv[..., 1]) * h.astype(jnp.float32) - 0.5)
    # The reference truncates toward zero (int cast), then clamps -1 -> 0
    ix = x.astype(jnp.int32)
    iy = y.astype(jnp.int32)
    ix2 = jnp.where(ix != w - 1, ix + 1, ix)
    iy2 = jnp.where(iy != h - 1, iy + 1, iy)
    ix = jnp.maximum(ix, 0)
    iy = jnp.maximum(iy, 0)

    def luma(c):
        return (c[..., 0] + c[..., 1] + c[..., 2]) / 3.0

    here = luma(_fetch(atlas.texels, offset, w, h, ix, iy))
    right = luma(_fetch(atlas.texels, offset, w, h, ix2, iy))
    down = luma(_fetch(atlas.texels, offset, w, h, ix, iy2))
    return here - right, here - down


def sky_radiance(scene, direction, has_envmap=True):
    """Sky lookup for direction[...,3].

    Constant color, or lat-long envmap with Y-axis rotation in degrees
    (scene.cpp:748-763).  NOTE the caller passes Vr = -ray_direction,
    matching the reference's convention at sky vertices
    (src/path_tracer.cpp:409-415).  has_envmap=False (static scene
    fact) drops the bilinear fetch for constant-sky scenes.
    """
    const = scene.sky_color * scene.sky_intensity
    if not has_envmap:
        return jnp.broadcast_to(const, direction.shape)
    tex_id = scene.sky_tex
    alpha = jnp.arcsin(jnp.clip(direction[..., 1], -1.0, 1.0))
    beta = -jnp.arctan2(direction[..., 0], direction[..., 2])
    beta = beta + scene.sky_rotate * 0.0174533
    x = beta / (2.0 * jnp.pi) + 0.5
    y = alpha / jnp.pi + 0.5
    uv = jnp.stack([x, y], axis=-1)
    env = sample_bilinear(scene.textures, jnp.broadcast_to(
        jnp.maximum(tex_id, 0), direction.shape[:-1]), uv)
    env = env * scene.sky_intensity
    return jnp.where(tex_id >= 0, env,
                     jnp.broadcast_to(const, env.shape))
