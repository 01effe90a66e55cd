"""Branchless BxDF dispatch: eval and sample for whole wavefronts.

The reference dispatches through a virtual BxDF hierarchy per ray
(reference src/bxdf/bxdf.cpp); on a vector machine every lane computes
all (cheap) lobes plus one LTC table fetch, then selects by the
material's `bxdf_type` — no divergence, pure VPU + gathers.

Conventions (identical to the reference, src/bxdf/bxdf.hpp):
* all vectors in the local shading frame, +Z = shading normal;
* `eval(Vi, Vr)` returns the BRDF *value* f (pi-normalized where
  applicable) used by NEE/BDPT connections;
* `sample(Vi, u2)` returns (direction, throughput, may_leak) where
  throughput is the fully importance-sampled weight (albedo), and
  may_leak marks transmission lobes allowed to cross the surface
  (transparent, dielectric refraction);
* delta lobes (mirror/transparent/dielectric) eval to their albedo
  when Vr matches the delta direction within the reference's 1e-4
  cosine tolerance, else 0 — this makes NEE a no-op on them, exactly
  like the reference.

One-level mix materials are supported: eval blends both leaves,
sample picks a leaf with DecideAndRescale (bxdf.cpp BxDFMix).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.arrays import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_LTC_BECKMANN,
    BSDF_LTC_BECKMANN_DIFFUSE,
    BSDF_LTC_GGX,
    BSDF_LTC_GGX_DIFFUSE,
    BSDF_MIRROR,
    BSDF_MIX,
    BSDF_TRANSPARENT,
)
from . import ltc as ltc_ops
from . import textures as tex_ops
from . import vecmath as vm
from . import warps

PI = 3.14159265358979


def _fresnel_dielectric(eta, cos_theta):
    """(reflectance, cos_theta_trans) — reference FresnellDielectric
    (bxdf.cpp:332-354).  eta flips when the ray comes from below."""
    flip = cos_theta < 0.0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_theta = jnp.abs(cos_theta)
    sin_t_sq = eta * eta * (1.0 - cos_theta * cos_theta)
    tir = sin_t_sq > 1.0
    # max(., 1e-12) keeps sqrt's gradient finite at grazing TIR.
    cos_trans = jnp.sqrt(jnp.maximum(1.0 - sin_t_sq, 1e-12))
    rs = (eta * cos_theta - cos_trans) / jnp.maximum(
        eta * cos_theta + cos_trans, 1e-12)
    rp = (eta * cos_trans - cos_theta) / jnp.maximum(
        eta * cos_trans + cos_theta, 1e-12)
    r = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, r), jnp.where(tir, 0.0, cos_trans)


def _resolve(scene, tex_id, solid, uv, has_textures=True):
    if not has_textures:
        # Static scene fact: no textures exist — skip the bilinear
        # gather chain entirely (it costs ~4 pool gathers per lane).
        return solid
    return tex_ops.resolve_color(scene.textures, tex_id, solid, uv)


# Column layout of the in-trace material row pack (f32 [NM, 20]).
# One 2-D row table instead of 14 separate 1-D tables: one gather per
# lane fetches every material parameter; building the pack from
# MaterialTable *inside the trace* keeps gradients flowing to the
# parameter leaves.
MAT_PACK_COLS = 20


def build_mat_pack(materials):
    m = materials
    f = lambda x: x.astype(jnp.float32)
    pack = jnp.concatenate([
        f(m.emission), f(m.diffuse), f(m.specular),
        f(m.roughness)[:, None], f(m.ior)[:, None],
        f(m.mix_amt)[:, None], f(m.bxdf_type)[:, None],
        f(m.mix_m1)[:, None], f(m.mix_m2)[:, None],
        f(m.diffuse_tex)[:, None], f(m.specular_tex)[:, None],
        f(m.bump_tex)[:, None], f(m.no_russian)[:, None],
        f(m.is_thinglass)[:, None],
    ], axis=1)
    return pack


class MatParams:
    """Per-lane gathered material parameters (one row-gather).

    Pass a prefetched `row` to reuse a gather already paid for this
    bounce."""

    def __init__(self, scene, mat_pack, mat_id, uv, row=None,
                 has_textures=True):
        if row is None:
            row = vm.take_rows(mat_pack, mat_id)
        self.emission = row[..., 0:3]
        self.bxdf_type = row[..., 12].astype(jnp.int32)
        self.diffuse = _resolve(scene, row[..., 15].astype(jnp.int32),
                                row[..., 3:6], uv, has_textures)
        self.specular = _resolve(scene, row[..., 16].astype(jnp.int32),
                                 row[..., 6:9], uv, has_textures)
        self.roughness = row[..., 9]
        self.ior = row[..., 10]
        self.mix_amt = row[..., 11]
        self.mix_m1 = row[..., 13].astype(jnp.int32)
        self.mix_m2 = row[..., 14].astype(jnp.int32)
        self.bump_tex = row[..., 17].astype(jnp.int32)
        self.no_russian = row[..., 18] > 0.5
        # LTC table kind: even enum values are Beckmann, odd GGX
        self.ltc_kind = jnp.where(
            (self.bxdf_type == BSDF_LTC_GGX)
            | (self.bxdf_type == BSDF_LTC_GGX_DIFFUSE),
            ltc_ops.KIND_GGX, ltc_ops.KIND_BECKMANN)


def _eval_base(scene, tables, p: MatParams, vi, vr, has_ltc=True):
    """All-lobes eval, selected by type.  vi/vr: local [...,3]."""
    viz = vi[..., 2]
    vrz = vr[..., 2]
    both_up = (viz > 0.0) & (vrz > 0.0)

    f_diffuse = jnp.where(both_up[..., None], p.diffuse / PI, 0.0)

    refl = vm.reflect_z(vi)
    is_mirror_dir = jnp.abs(vm.dot(refl, vr) - 1.0) < 1e-4
    f_mirror = jnp.where(is_mirror_dir[..., None], p.specular, 0.0)

    is_inverse_dir = jnp.abs(vm.dot(-vi, vr) - 1.0) < 1e-4
    f_transparent = jnp.where(is_inverse_dir[..., None],
                              jnp.ones_like(p.specular), 0.0)

    # Dielectric (bxdf.cpp BxDFDielectric::value:356-378)
    eta = jnp.where(viz < 0.0, p.ior, 1.0 / p.ior)
    r_p, cos_t = _fresnel_dielectric(eta, viz)
    same_side = viz * vrz > 0.0
    refr = jnp.stack([
        -vi[..., 0] * eta,
        -vi[..., 1] * eta,
        jnp.where(viz > 0.0, -cos_t, cos_t)], axis=-1)
    is_refr_dir = jnp.abs(vm.dot(vr, refr) - 1.0) < 1e-3
    f_dielectric = jnp.where(
        same_side[..., None],
        jnp.where(is_mirror_dir[..., None], r_p[..., None] * p.specular, 0.0),
        jnp.where(is_refr_dir[..., None],
                  (1.0 - r_p)[..., None] * p.specular, 0.0))

    # LTC: frame around outgoing vr, evaluated at vi (bxdf.hpp:110-114)
    if has_ltc:
        ltc_val = ltc_ops.pdf(tables, p.ltc_kind, vr, vi, p.roughness)
    else:
        ltc_val = jnp.zeros_like(p.roughness)
    f_ltc = jnp.where(both_up[..., None],
                      p.specular * ltc_val[..., None], 0.0)
    f_ltc_diffuse = jnp.where(
        both_up[..., None],
        p.specular * ltc_val[..., None] + p.diffuse / PI, 0.0)

    t = p.bxdf_type[..., None]
    out = jnp.where(t == BSDF_DIFFUSE, f_diffuse, 0.0)
    out = jnp.where(t == BSDF_MIRROR, f_mirror, out)
    out = jnp.where(t == BSDF_TRANSPARENT, f_transparent, out)
    out = jnp.where(t == BSDF_DIELECTRIC, f_dielectric, out)
    out = jnp.where((t == BSDF_LTC_BECKMANN) | (t == BSDF_LTC_GGX),
                    f_ltc, out)
    out = jnp.where((t == BSDF_LTC_BECKMANN_DIFFUSE)
                    | (t == BSDF_LTC_GGX_DIFFUSE), f_ltc_diffuse, out)
    return out


def eval_bxdf(scene, mat_pack, mat_id, vi, vr, uv, tables,
              has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """BRDF value f(Vi, Vr) for lanes; handles one-level mixes.

    has_mix/has_ltc/has_textures are *static* scene facts (SceneMeta)
    — scenes without those material classes drop the extra eval
    passes, LTC fetches and texture gathers at trace time.  `p0`
    reuses a prefetched MatParams.
    """
    p = p0 if p0 is not None else MatParams(scene, mat_pack, mat_id, uv,
                                            has_textures=has_textures)
    base = _eval_base(scene, tables, p, vi, vr, has_ltc)
    if not has_mix:
        return base

    is_mix = p.bxdf_type == BSDF_MIX
    amt = p.mix_amt[..., None]
    f1 = _eval_base(scene, tables,
                    MatParams(scene, mat_pack, p.mix_m1, uv,
                              has_textures=has_textures), vi, vr,
                    has_ltc)
    f2 = _eval_base(scene, tables,
                    MatParams(scene, mat_pack, p.mix_m2, uv,
                              has_textures=has_textures), vi, vr,
                    has_ltc)
    return jnp.where(is_mix[..., None], f1 * amt + f2 * (1.0 - amt), base)


def _sample_base(scene, tables, p: MatParams, vi, u2, has_ltc=True):
    """All-lobes sample, selected by type.
    Returns (dir, throughput, may_leak)."""
    viz = vi[..., 2]
    up = viz > 0.0

    cos_dir = warps.to_hemisphere_cosine_z(u2)

    # Diffuse
    d_diffuse = jnp.where(up[..., None], cos_dir,
                          jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]),
                                           cos_dir.shape))
    t_diffuse = jnp.where(up[..., None], p.diffuse, 0.0)

    # Mirror / transparent
    d_mirror = vm.reflect_z(vi)
    d_transparent = -vi

    # Dielectric (bxdf.cpp:380-408): reflect w.p. R else refract;
    # the decision consumes u2.x via DecideAndRescale.
    eta = jnp.where(viz < 0.0, p.ior, 1.0 / p.ior)
    r_p, cos_t = _fresnel_dielectric(eta, jnp.abs(viz))
    take_refl, _ = warps.decide_and_rescale(u2[..., 0], r_p)
    d_refr = jnp.stack([
        -vi[..., 0] * eta,
        -vi[..., 1] * eta,
        jnp.where(viz > 0.0, -jnp.abs(cos_t), jnp.abs(cos_t))], axis=-1)
    d_dielectric = jnp.where(take_refl[..., None], d_mirror, d_refr)
    leak_dielectric = ~take_refl

    # LTC + diffuse lobe choice by relative albedo power
    # (bxdf.hpp BxDFLTCDiffuse::sample:137-158)
    dpow = p.diffuse.sum(axis=-1)
    spow = p.specular.sum(axis=-1)
    p_diff = dpow / (dpow + spow + 1e-4)
    take_diff, sx = warps.decide_and_rescale(u2[..., 0], p_diff)
    u2_rescaled = jnp.stack([sx, u2[..., 1]], axis=-1)
    cos_dir_r = warps.to_hemisphere_cosine_z(u2_rescaled)

    # One LTC transform serves both lobes: pure-LTC lanes feed the
    # raw cosine vector, LTC+diffuse lanes the rescaled one.
    tt0 = p.bxdf_type
    is_ltcd0 = ((tt0 == BSDF_LTC_BECKMANN_DIFFUSE)
                | (tt0 == BSDF_LTC_GGX_DIFFUSE))
    if has_ltc:
        cos_sel = jnp.where(is_ltcd0[..., None], cos_dir_r, cos_dir)
        d_ltc_all = ltc_ops.sample(tables, p.ltc_kind, vi, p.roughness,
                                   cos_sel)
    else:
        d_ltc_all = cos_dir
    d_ltc = d_ltc_all
    ltc_ok = d_ltc[..., 2] > 0.0
    t_ltc = jnp.where(ltc_ok[..., None], p.specular, 0.0)
    d_ltc_r = d_ltc_all
    ltc_r_ok = d_ltc_r[..., 2] > 0.0
    d_ltcdiff = jnp.where(take_diff[..., None],
                          jnp.where(up[..., None], cos_dir_r,
                                    jnp.broadcast_to(
                                        jnp.asarray([0.0, 1.0, 0.0]),
                                        cos_dir_r.shape)),
                          d_ltc_r)
    t_ltcdiff = jnp.where(
        take_diff[..., None],
        jnp.where(up[..., None], p.diffuse, 0.0),
        jnp.where(ltc_r_ok[..., None], p.specular, 0.0))

    t = p.bxdf_type[..., None]
    tt = p.bxdf_type
    d = jnp.where(t == BSDF_DIFFUSE, d_diffuse, 0.0)
    thr = jnp.where(t == BSDF_DIFFUSE, t_diffuse, 0.0)
    d = jnp.where(t == BSDF_MIRROR, d_mirror, d)
    thr = jnp.where(t == BSDF_MIRROR, p.specular, thr)
    d = jnp.where(t == BSDF_TRANSPARENT, d_transparent, d)
    thr = jnp.where(t == BSDF_TRANSPARENT, jnp.ones_like(thr), thr)
    d = jnp.where(t == BSDF_DIELECTRIC, d_dielectric, d)
    thr = jnp.where(t == BSDF_DIELECTRIC, p.specular, thr)
    is_ltc = (tt == BSDF_LTC_BECKMANN) | (tt == BSDF_LTC_GGX)
    d = jnp.where(is_ltc[..., None], d_ltc, d)
    thr = jnp.where(is_ltc[..., None], t_ltc, thr)
    is_ltcd = (tt == BSDF_LTC_BECKMANN_DIFFUSE) | (tt == BSDF_LTC_GGX_DIFFUSE)
    d = jnp.where(is_ltcd[..., None], d_ltcdiff, d)
    thr = jnp.where(is_ltcd[..., None], t_ltcdiff, thr)

    leak = (tt == BSDF_TRANSPARENT) \
        | ((tt == BSDF_DIELECTRIC) & leak_dielectric)
    return vm.safe_normalize(d), thr, leak


def sample_bxdf(scene, mat_pack, mat_id, vi, uv, u2, tables,
                has_mix=True, has_ltc=True, has_textures=True, p0=None):
    """Sample an outgoing direction.  Returns (dir, throughput, leak);
    handles one-level mixes with the reference's sample-reuse split.
    `p0` reuses a prefetched MatParams; has_mix/has_ltc/has_textures
    are static scene facts that drop unreachable code at trace time."""
    if p0 is None:
        p0 = MatParams(scene, mat_pack, mat_id, uv,
                       has_textures=has_textures)
    if not has_mix:
        return _sample_base(scene, tables, p0, vi, u2, has_ltc)
    is_mix = p0.bxdf_type == BSDF_MIX
    take_m1, sx = warps.decide_and_rescale(u2[..., 0], p0.mix_amt)
    u2_mix = jnp.stack([sx, u2[..., 1]], axis=-1)
    # Non-mix lanes keep the original sample; mix lanes the rescaled.
    u2_eff = jnp.where(is_mix[..., None], u2_mix, u2)
    sub_id = jnp.where(is_mix,
                       jnp.where(take_m1, p0.mix_m1, p0.mix_m2),
                       mat_id)
    p = MatParams(scene, mat_pack, sub_id, uv, has_textures=has_textures)
    return _sample_base(scene, tables, p, vi, u2_eff, has_ltc)
