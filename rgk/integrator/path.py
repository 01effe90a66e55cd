"""Wavefront path tracing: the reference's recursive megakernel
re-shaped for a vector machine.

The reference traces one pixel at a time through a serial bounce loop
with early exits (reference src/path_tracer.cpp GeneratePath/TracePath).
Here a *wavefront* of lanes — one per (pixel, sample) pair — advances
through a `lax.scan` over bounce index; termination (russian roulette,
throughput cutoff, light leaks, sky escape) is a per-lane `alive` mask
update, never control flow.  All physics matches the reference:

* per-path single light sample used for NEE at every vertex
  (path_tracer.cpp:322-325);
* per-vertex radiance = NEE + emission (+ BDPT connections when
  reverse > 0), clamped, times the cumulative contribution *before*
  this vertex (path_tracer.cpp:427-496);
* russian roulette from vertex 2 with 1/p compensation entering at
  the next vertex's coefficient — including the reference's
  one-uncompensated-check quirk (see tests/test_renderer.py);
* throughput cutoff at max < 1e-3; light-leak guard terminating the
  path after shading the vertex (path_tracer.cpp:251-260);
* next-ray origin offset +-10*eps along the interpolated normal
  (path_tracer.cpp:291-295);
* sky escape adds envmap radiance evaluated at -ray_dir
  (path_tracer.cpp:409-415).

Bidirectional mode (settings.reverse > 0, path_tracer.cpp:337-349,
367-398, 463-480): a light subpath of up to `reverse` vertices is
generated per lane; every light vertex is splatted to the camera
through the inverse projection (weight-0 side-effect pixels,
src/tracer.cpp:18-26), and every eye vertex connects to every light
vertex with an f_light * f_point * G visibility term.

Differentiability: traversal outputs (hit ids, t, barycentrics) are
integer/stop-gradient; radiance is smooth in material colors,
emission, roughness, textures, light intensity, and sky.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import bxdf as bxdf_ops
from ..ops import intersect as isect
from ..ops import lights as light_ops
from ..ops import ltc as ltc_ops
from ..ops import sampler as smp
from ..ops import textures as tex_ops
from ..ops import vecmath as vm
from ..scene.camera import coords_from_direction, pixel_rays

RAY_FAR = 10000.0  # the reference Ray's default far plane (ray.hpp:26)


class TraceResult(NamedTuple):
    radiance: jnp.ndarray   # f32 [R,3] per-lane radiance estimate
    rays: jnp.ndarray       # int32 [] extension rays traced (counter
    #                         parity: visibility rays excluded,
    #                         path_tracer.cpp:126)
    splat_pix: jnp.ndarray  # int32 [R,K] target pixel (-1 = none)
    splat_val: jnp.ndarray  # f32 [R,K,3] weight-0 splat radiance


class ShadePoint(NamedTuple):
    """Geometry + material data at a hit, lane-parallel."""
    ok: jnp.ndarray       # hit & usable normal
    pos: jnp.ndarray
    face_n: jnp.ndarray   # interpolated vertex normal
    light_n: jnp.ndarray  # bump-tilted shading normal
    t_f: jnp.ndarray      # shading frame tangent
    b_f: jnp.ndarray      # shading frame bitangent
    vr: jnp.ndarray       # toward the previous vertex (unit)
    uv: jnp.ndarray
    mat_id: jnp.ndarray
    mat_row: jnp.ndarray  # prefetched material pack row [.,20]
    tri: jnp.ndarray


def _shade_point(scene, meta, settings, hit, ro, rd, mat_pack) -> ShadePoint:
    """Interpolate attributes & build the shading frame at `hit`
    (reference GeneratePath:147-235)."""
    tri = jnp.maximum(hit.tri, 0)
    meta_row = vm.take_rows(scene.tri_meta, tri)
    mat_id = meta_row[..., 3]
    mat_row = vm.take_rows(mat_pack, mat_id)
    # One de-indexed row gather brings all 3 vertices' normals, uvs
    # and tangents (tri_shade layout, scene/arrays.py).
    srow = vm.take_rows(scene.tri_shade, tri)
    ba = 1.0 - hit.bary_b - hit.bary_c
    pos = ro + rd * hit.t[..., None]
    vr = -rd

    wa = ba[..., None]
    wb = hit.bary_b[..., None]
    wc = hit.bary_c[..., None]
    na, nb, nc = srow[..., 0:3], srow[..., 3:6], srow[..., 6:9]
    face_n_raw = wa * na + wb * nb + wc * nc
    # NaN-normal fallback chain (path_tracer.cpp:157-171): a NaN
    # interpolation (imperfect meshes, merged vertices) falls back to
    # vertex A's, then B's, then C's normal; only all-NaN or an exactly
    # zero-length result kills the lane (:172-177).
    for cand in (na, nb, nc):
        is_nan = jnp.isnan(face_n_raw).any(axis=-1, keepdims=True)
        face_n_raw = jnp.where(is_nan, cand, face_n_raw)
    n_ok = vm.dot(face_n_raw, face_n_raw) > 0.0  # False for NaN too
    face_n = vm.safe_normalize(face_n_raw)
    uv = (wa * srow[..., 9:11] + wb * srow[..., 11:13]
          + wc * srow[..., 13:15])

    light_n = face_n
    if meta.has_textures:
        bump_tex = mat_row[..., 17].astype(jnp.int32)
        has_bump = bump_tex >= 0
        s_right, s_bottom = tex_ops.bump_slopes(
            scene.textures, jnp.maximum(bump_tex, 0), uv)
        tangent = (wa * srow[..., 15:18] + wb * srow[..., 18:21]
                   + wc * srow[..., 21:24])
        t_ok = vm.dot(tangent, tangent) >= 1e-3
        tangent = vm.safe_normalize(tangent)
        bitangent = vm.safe_normalize(jnp.cross(face_n, tangent))
        tangent2 = jnp.cross(bitangent, face_n)
        tilted = vm.safe_normalize(
            face_n + (tangent2 * s_right[..., None]
                      + bitangent * s_bottom[..., None])
            * float(settings.bumpmap_scale),
            fallback=face_n)
        light_n = jnp.where((has_bump & t_ok)[..., None], tilted, face_n)

    t_f, b_f = vm.build_onb(light_n)
    return ShadePoint(ok=hit.valid & n_ok, pos=pos, face_n=face_n,
                      light_n=light_n, t_f=t_f, b_f=b_f, vr=vr, uv=uv,
                      mat_id=mat_id, mat_row=mat_row, tri=tri)


def _to_local(sp: ShadePoint, v):
    return vm.to_local(sp.light_n, sp.t_f, sp.b_f, v)


class SubpathState(NamedTuple):
    """Scan carry for either path direction."""
    ro: jnp.ndarray
    rd: jnp.ndarray
    last_tri: jnp.ndarray
    contribution: jnp.ndarray
    alive: jnp.ndarray
    ray_count: jnp.ndarray


def _extend_path(scene, meta, settings, tables, mat_pack, ctx, state,
                 bounce_idx, vertex_n, russian, tag):
    """One path-extension step shared by eye and light subpaths.

    Returns (new_state, sp, hit_valid_mask, contribution_at_vertex,
    sky_mask).  `russian` < 0 disables roulette (the light subpath,
    path_tracer.cpp:349).  `tag` decorrelates eye/light sample dims.
    """
    intersect = isect.make_intersector(meta)
    hit = intersect(scene, state.ro, state.rd, 0.0, RAY_FAR,
                    exclude=state.last_tri)
    ray_count = state.ray_count + jnp.sum(state.alive.astype(jnp.int32))

    sky_mask = state.alive & ~hit.valid
    sp = _shade_point(scene, meta, settings, hit, state.ro, state.rd,
                      mat_pack)
    act = state.alive & sp.ok

    # Per-bounce sample dims: fold (tag, bounce) into the seed; the
    # scan index is traced so static dim offsets are unavailable.
    bctx = ctx._replace(
        seed=smp.hash_u32(ctx.seed, jnp.uint32(tag),
                          bounce_idx + jnp.uint32(1)),
        mode=0)
    u2 = smp.sample_2d(bctx, smp.DIM_EYE_BOUNCE)
    rr_u = smp.sample_1d(bctx, smp.DIM_EYE_BOUNCE + 2)

    vr_local = _to_local(sp, sp.vr)
    p0 = bxdf_ops.MatParams(scene, mat_pack, sp.mat_id, sp.uv,
                            row=sp.mat_row, has_textures=meta.has_textures)
    dir_local, transfer, may_leak = bxdf_ops.sample_bxdf(
        scene, mat_pack, sp.mat_id, vr_local, sp.uv, u2, tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures, p0=p0)
    inside = dir_local[..., 2] < 0.0
    dir_world = vm.to_global(sp.light_n, sp.t_f, sp.b_f, dir_local)

    same_sign = (vm.dot(dir_world, sp.face_n)
                 * vm.dot(sp.vr, sp.face_n)) > 0.0
    leak_kill = ~same_sign & ~may_leak

    no_russian = sp.mat_row[..., 18] > 0.5
    rus_coeff = jnp.where(
        (~no_russian) & (russian > 0.0) & (vertex_n > 1),
        1.0 / russian if russian > 0.0 else 1.0, 1.0)
    new_contribution = jnp.where(
        act[..., None],
        state.contribution * rus_coeff[..., None] * transfer,
        state.contribution)
    cum_low = new_contribution.max(axis=-1) < 1e-3
    rr_kill = (~no_russian) & (russian >= 0.0) & (rr_u > russian)
    alive = act & ~cum_low & ~rr_kill & ~leak_kill

    offset = (scene.epsilon * 10.0
              * jnp.where(inside, -1.0, 1.0))[..., None] * sp.face_n
    new_state = SubpathState(
        ro=jnp.where(act[..., None], sp.pos + offset, state.ro),
        rd=jnp.where(act[..., None], vm.safe_normalize(dir_world),
                     state.rd),
        last_tri=jnp.where(act, hit.tri, state.last_tri),
        contribution=new_contribution,
        alive=alive,
        ray_count=ray_count,
    )
    return new_state, sp, p0, act, state.contribution, sky_mask


def _sample_path_light(scene, ctx):
    """The path's single light sample (path_tracer.cpp:315-325)."""
    areal2 = smp.sample_2d(ctx, smp.DIM_AREAL)
    choice2 = smp.sample_2d(ctx, smp.DIM_LIGHT_CHOICE)
    light1 = smp.sample_1d(ctx, smp.DIM_LIGHT_TRI)
    light = light_ops.sample_light(scene, choice2, light1, areal2)
    return light_ops.offset_sphere_light(light, areal2)


def _vertex_radiance(scene, meta, settings, tables, mat_pack, intersect,
                     light, sp, p0, active=None):
    """NEE direct light + emission at one shaded vertex — the
    per-vertex radiance of the eye walk (path_tracer.cpp:427-460,
    485-487), exclusive of BDPT connections and the final clamp.

    `active` masks lanes whose radiance the caller will consume;
    inactive lanes' shadow rays are culled inside visibility()."""
    to_light = light.pos - sp.pos
    dist2 = jnp.maximum(vm.dot(to_light, to_light), 1e-12)
    vi_l = to_light / jnp.sqrt(dist2)[..., None]
    vis = isect.visibility(scene, intersect, light.pos, sp.pos,
                           active=active)
    f = bxdf_ops.eval_bxdf(scene, mat_pack, sp.mat_id,
                           _to_local(sp, vi_l),
                           _to_local(sp, sp.vr), sp.uv, tables,
                           has_mix=meta.has_mix,
                           has_ltc=meta.has_ltc,
                           has_textures=meta.has_textures, p0=p0)
    g = jnp.abs(vm.dot(sp.light_n, vi_l)) / dist2
    inc = (light.color * light.intensity[..., None]
           * light.directional_factor(-vi_l)[..., None])
    if meta.has_thinglass and bool(getattr(settings, "tint_thinglass",
                                           False)):
        # Extension of the reference's disabled tint (path_tracer.cpp
        # :429-451): thin-glass crossings of the shadow segment filter
        # the incident light.  Collected light->point like the
        # reference's VisibilityWithThinglass; orientation uses the
        # point->light direction Vi (path_tracer.cpp:451).
        from ..ops import thinglass as tg
        seg = sp.pos - light.pos
        dist = vm.length(seg)
        rd_seg = seg / jnp.maximum(dist, 1e-12)[..., None]
        ts, tris = tg.collect_thinglass(
            scene, light.pos, rd_seg, scene.epsilon * 20.0,
            dist - scene.epsilon * 20.0)
        inc = tg.apply_thinglass(scene, inc, ts, tris, vi_l, tint=True)
    total_here = jnp.where((vis & light.valid)[..., None],
                           inc * f * g[..., None], 0.0)
    # Emission (front side only) — from the packed row table.
    emission = sp.mat_row[..., 0:3]
    front = vm.dot(sp.face_n, sp.vr) > 0.0
    return total_here + jnp.where(front[..., None], emission, 0.0)


def trace_wavefront_queued(scene, meta, settings, cam, px, py,
                           sample0, n_samples: int, seed,
                           sampler_mode: int = 1):
    """One lane per PIXEL; each lane traces `n_samples` paths
    back-to-back (samples sample0 .. sample0+n_samples-1), starting
    the next sample's camera ray on the iteration after a path dies.

    This is the occupancy fix for the wavefront loop: with russian
    roulette the mean path length is ~3 while the per-sample loop runs
    to the *max* depth across 10^6 lanes, wasting ~70% of intersection
    sweeps on dead lanes.  In-place regeneration keeps lanes busy with
    no cross-lane compaction (no gathers/scatters); every per-sample
    value is bitwise identical to the per-sample wavefront because
    sampling is a pure function of (seed, pixel, sample, dim).

    Requires reverse == 0 (BDPT paths use trace_wavefront).  Returns
    (radiance_sum [R,3] over the lane's samples, rays traced).
    """
    assert int(settings.reverse) == 0
    tables = ltc_ops.LTCTables(rows=scene.ltc_rows)
    mat_pack = bxdf_ops.build_mat_pack(scene.materials)
    intersect = isect.make_intersector(meta)
    depth = int(settings.recursion_max)
    russian = float(settings.russian)
    clamp = float(settings.clamp)
    R = px.shape[0]

    pixel_id = (py.astype(jnp.uint32) * jnp.uint32(cam.xres)
                + px.astype(jnp.uint32))
    s_end = jnp.uint32(int(sample0) + n_samples) if isinstance(
        sample0, int) else sample0 + jnp.uint32(n_samples)

    def make_ctx(s):
        return smp.SampleCtx(seed=jnp.uint32(seed), pixel=pixel_id,
                             sample=s, mode=sampler_mode,
                             n_set=max(1, int(settings.multisample)))

    class _Q(NamedTuple):
        ro: jnp.ndarray
        rd: jnp.ndarray
        last_tri: jnp.ndarray
        contribution: jnp.ndarray
        alive: jnp.ndarray
        bounce: jnp.ndarray      # int32 [R] vertex counter within path
        s: jnp.ndarray           # uint32 [R] current sample index
        sample_rad: jnp.ndarray  # f32 [R,3] the in-flight sample's sum
        radiance: jnp.ndarray    # f32 [R,3] flushed over finished samples
        rays: jnp.ndarray        # int32 [] extension-ray counter

    # Zeros DERIVED FROM px: under shard_map (parallel/mesh.py
    # make_queued_fn) the carry must be device-varying from the
    # start or the while_loop's carry types mismatch after the first
    # iteration; outside shard_map these adds fuse away.
    vz_f = px.astype(jnp.float32) * 0.0
    vz_i = px * 0
    init = _Q(
        ro=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        rd=vz_f[:, None] + jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        last_tri=vz_i - 1,
        contribution=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        alive=px < 0,
        bounce=vz_i,
        s=vz_i.astype(jnp.uint32) + jnp.uint32(sample0)
        if isinstance(sample0, int)
        else vz_i.astype(jnp.uint32) + sample0,
        sample_rad=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        radiance=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        rays=jnp.sum(vz_i),
    )

    def cond(q):
        return jnp.any(q.alive | (q.s < s_end))

    def body(q):
        # 1) (Re)start lanes that are idle but still have samples.
        need = (~q.alive) & (q.s < s_end)
        ctx = make_ctx(q.s)
        jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
        if cam.is_simple:
            ro0, rd0 = pixel_rays(cam, px, py, jitter)
        else:
            ro0, rd0 = pixel_rays(
                cam, px, py, jitter,
                lens_sample=smp.sample_2d(ctx, smp.DIM_LENS))
        n3 = need[..., None]
        state = SubpathState(
            ro=jnp.where(n3, ro0, q.ro),
            rd=jnp.where(n3, rd0, q.rd),
            last_tri=jnp.where(need, -1, q.last_tri),
            contribution=jnp.where(n3, 1.0, q.contribution),
            alive=q.alive | need,
            ray_count=q.rays,
        )
        bounce = jnp.where(need, 0, q.bounce)

        # 2) This sample's light (same dims as the per-sample path).
        light = _sample_path_light(scene, ctx)

        # 3) One extension step; per-lane bounce index feeds the
        #    per-bounce sample dims.
        new_state, sp, p0, act, contrib, sky_mask = _extend_path(
            scene, meta, settings, tables, mat_pack, ctx, state,
            bounce.astype(jnp.uint32), bounce + 1, russian, tag=1)

        # 4) Radiance at this vertex: sky escape or NEE + emission.
        sky = tex_ops.sky_radiance(scene, -state.rd,
                                   has_envmap=meta.has_envmap)
        if meta.has_thinglass and bool(getattr(
                settings, "tint_thinglass", False)):
            # Sky radiance filtered through the escape segment's
            # thin-glass crossings (path_tracer.cpp:414).
            from ..ops import thinglass as tg
            ts_g, tr_g = tg.collect_thinglass(scene, state.ro, state.rd,
                                              0.0, RAY_FAR)
            sky = tg.apply_thinglass(scene, sky, ts_g, tr_g, state.rd,
                                     tint=True)
        sample_rad = q.sample_rad + jnp.where(sky_mask[..., None],
                                              contrib * sky, 0.0)
        total_here = _vertex_radiance(scene, meta, settings, tables,
                                      mat_pack, intersect, light, sp, p0,
                                      active=act)
        total_here = jnp.minimum(total_here, clamp)
        sample_rad = sample_rad + jnp.where(act[..., None],
                                            contrib * total_here, 0.0)

        # 5) Depth termination; finished paths flush the sample with
        #    the reference's whole-sample clamp + NaN/negative scrub
        #    (path_tracer.cpp:502-507) and advance to the next sample.
        alive_after = new_state.alive & (bounce + 1 < depth)
        ended = state.alive & ~alive_after
        flushed = jnp.minimum(sample_rad, clamp)
        flushed = jnp.where(jnp.isnan(flushed) | (flushed < 0.0), 0.0,
                            flushed)
        e3 = ended[..., None]
        return _Q(ro=new_state.ro, rd=new_state.rd,
                  last_tri=new_state.last_tri,
                  contribution=new_state.contribution,
                  alive=alive_after, bounce=bounce + 1,
                  s=jnp.where(ended, q.s + jnp.uint32(1), q.s),
                  sample_rad=jnp.where(e3, 0.0, sample_rad),
                  radiance=q.radiance + jnp.where(e3, flushed, 0.0),
                  rays=new_state.ray_count)

    final = jax.lax.while_loop(cond, body, init)
    return final.radiance, final.rays


def _trace_light_subpaths(scene, meta, settings, cam, ctx, tables,
                          mat_pack, intersect, light, lightdir2,
                          reverse: int, ray_count0):
    """Trace one K-vertex light subpath per lane and project every
    vertex to the camera (reference path_tracer.cpp:339-398).

    Returns (lrec, splat_pix [R,K], splat_val [R,K,3], ray_count):
    lrec is a dict of [K, R, ...] per-vertex arrays (valid, pos,
    light_n, t_f, b_f, vr, uv, mat_id, light_here) consumed by the
    eye walk's connection loop."""
    from ..ops import warps

    R = light.pos.shape[0]
    emission_dir = warps.to_hemisphere_cosine_directed(
        lightdir2, light.normal)
    light_at_start = (light.color * light.intensity[..., None]
                      * light.directional_factor(emission_dir)[..., None])
    # Zeros DERIVED from the (sharded) light positions: under
    # shard_map the scan carry must be device-varying from the start
    # or the carry types mismatch after the first step; outside
    # shard_map these adds fuse away.
    vz_i = (light.pos[:, 0] * 0.0).astype(jnp.int32)
    l_state = SubpathState(
        ro=light.pos + scene.epsilon * 100.0 * light.normal,
        rd=emission_dir,
        last_tri=vz_i - 1,
        contribution=(vz_i[:, None].astype(jnp.float32)
                      + jnp.ones((1, 3), jnp.float32)),
        alive=(vz_i == 0) & light.valid,
        ray_count=ray_count0,
    )

    def light_bounce(state, k):
        new_state, sp, p0, act, contrib, _sky = _extend_path(
            scene, meta, settings, tables, mat_pack, ctx, state, k,
            k + 1, -1.0, tag=2)
        light_here = contrib * light_at_start
        rec = dict(valid=act, pos=sp.pos, light_n=sp.light_n,
                   t_f=sp.t_f, b_f=sp.b_f, vr=sp.vr, uv=sp.uv,
                   mat_id=sp.mat_id, light_here=light_here)
        return new_state, rec

    l_state, lrec = jax.lax.scan(
        light_bounce, l_state, jnp.arange(reverse, dtype=jnp.uint32))

    # --- Splat every light vertex to the camera
    #     (path_tracer.cpp:367-398) ---
    lpos = lrec["pos"]          # [K,R,3]
    lvalid = lrec["valid"]      # [K,R]
    campos = jnp.broadcast_to(cam.origin, lpos.shape)
    vis_cam = isect.visibility(
        scene, intersect,
        lpos.reshape(-1, 3), campos.reshape(-1, 3)
    ).reshape(lvalid.shape)
    direction = vm.normalize(lpos - campos)  # camera -> vertex
    f_cam = bxdf_ops.eval_bxdf(
        scene, mat_pack, lrec["mat_id"].reshape(-1),
        vm.to_local(lrec["light_n"], lrec["t_f"], lrec["b_f"],
                    lrec["vr"]).reshape(-1, 3),
        vm.to_local(lrec["light_n"], lrec["t_f"], lrec["b_f"],
                    -direction).reshape(-1, 3),
        lrec["uv"].reshape(-1, 2), tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures).reshape(lpos.shape)
    g_cam = (jnp.maximum(0.0, vm.dot(lrec["light_n"], -direction))
             / jnp.maximum(vm.distance2(campos, lpos), 1e-12))
    q = lrec["light_here"] * f_cam * g_cam[..., None]
    x2, y2, in_view = coords_from_direction(cam, direction)
    splat_ok = (lvalid & vis_cam & in_view & (g_cam >= 1e-5)
                & jnp.isfinite(q).all(axis=-1))
    pix = jnp.where(splat_ok, y2 * cam.xres + x2, -1)
    splat_pix = pix.transpose(1, 0)                  # [R,K]
    splat_val = jnp.where(splat_ok[..., None], q,
                          0.0).transpose(1, 0, 2)    # [R,K,3]
    return lrec, splat_pix, splat_val, l_state.ray_count


def _connect_to_light_vertex(scene, meta, tables, mat_pack, intersect,
                             lv, sp, p0, act):
    """One BDPT eye-vertex x light-vertex connection
    (path_tracer.cpp:463-480).  `lv` holds one light vertex per lane
    (fields as in _trace_light_subpaths' lrec, [R, ...])."""
    l_valid = lv["valid"]
    l_pos = lv["pos"]
    vis_c = isect.visibility(scene, intersect, l_pos, sp.pos,
                             active=l_valid & act)
    light_to_p = vm.normalize(sp.pos - l_pos)
    p_to_light = -light_to_p
    f_light = bxdf_ops.eval_bxdf(
        scene, mat_pack, lv["mat_id"],
        vm.to_local(lv["light_n"], lv["t_f"], lv["b_f"], light_to_p),
        vm.to_local(lv["light_n"], lv["t_f"], lv["b_f"], lv["vr"]),
        lv["uv"], tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures)
    f_point = bxdf_ops.eval_bxdf(
        scene, mat_pack, sp.mat_id, _to_local(sp, sp.vr),
        _to_local(sp, p_to_light), sp.uv, tables,
        has_mix=meta.has_mix, has_ltc=meta.has_ltc,
        has_textures=meta.has_textures, p0=p0)
    g_c = (jnp.abs(vm.dot(sp.light_n, p_to_light))
           / jnp.maximum(vm.distance2(l_pos, sp.pos), 1e-12))
    term = lv["light_here"] * f_light * f_point * g_c[..., None]
    return jnp.where((l_valid & vis_c)[..., None], term, 0.0)


# lrec pack layout for the queued eye walk: one row of floats per
# (lane, sample, light vertex).
_LV_F = 19  # valid, pos3, light_n3, t_f3, b_f3, vr3, uv2, mat_id


def _pack_light_vertices(lrec, reverse, R, n_samples):
    """[K, R*S, ...] lrec dict (sample-OUTER lane layout: flat lane
    index = s*R + lane) -> [R, S, K*(19+3)] packed rows (the
    light_here color rides after the 19 geometry floats)."""
    parts = [
        lrec["valid"][..., None].astype(jnp.float32),
        lrec["pos"], lrec["light_n"], lrec["t_f"], lrec["b_f"],
        lrec["vr"], lrec["uv"],
        lrec["mat_id"][..., None].astype(jnp.float32),
        lrec["light_here"],
    ]
    flat = jnp.concatenate(parts, axis=-1)      # [K, R*S, 22]
    k = flat.shape[0]
    flat = flat.transpose(1, 0, 2)              # [R*S, K, 22]
    flat = flat.reshape(n_samples, R, k * (_LV_F + 3))
    return flat.transpose(1, 0, 2)              # [R, S, K*22]


def _unpack_light_vertex(rows, k):
    """One [R, K*22] packed row set -> light-vertex dict for slot k."""
    o = k * (_LV_F + 3)
    return dict(
        valid=rows[:, o + 0] > 0.5,
        pos=rows[:, o + 1:o + 4],
        light_n=rows[:, o + 4:o + 7],
        t_f=rows[:, o + 7:o + 10],
        b_f=rows[:, o + 10:o + 13],
        vr=rows[:, o + 13:o + 16],
        uv=rows[:, o + 16:o + 18],
        mat_id=rows[:, o + 18].astype(jnp.int32),
        light_here=rows[:, o + 19:o + 22],
    )


def trace_wavefront_queued_bdpt(scene, meta, settings, cam, px, py,
                                sample0, n_samples: int, seed,
                                sampler_mode: int = 1):
    """Queued-regeneration BDPT (reverse > 0): the production path for
    bidirectional tracing.

    Two phases inside one jit:
      1. ALL (pixel, sample) light subpaths for the round are traced
         vectorized (one K-step scan over R*n_samples lanes,
         reference path_tracer.cpp:339-398), their camera splats
         scattered ONCE into a device-local [H*W+1, 3] splat image
         (the +1 row swallows invalid pixels), and the vertex records
         packed per (lane, sample) in HBM.
      2. The eye walk runs the same in-place sample regeneration as
         trace_wavefront_queued — lanes start their next sample the
         iteration after a path dies, keeping occupancy near 100%
         where the per-sample wavefront pays max-depth sweeps on
         mostly-dead lanes — and connects every eye vertex to its
         sample's stored light vertices (path_tracer.cpp:463-480)
         via one take-along gather per iteration.

    Every per-(pixel, sample) value is bitwise identical to
    trace_wavefront because sampling is a pure function of (seed,
    pixel, sample, dim); only the splat image's scatter order differs
    (1-ulp class).  Returns (radiance [R,3], splat_img [H*W+1,3],
    rays)."""
    reverse = int(settings.reverse)
    assert reverse > 0
    tables = ltc_ops.LTCTables(rows=scene.ltc_rows)
    mat_pack = bxdf_ops.build_mat_pack(scene.materials)
    intersect = isect.make_intersector(meta)
    depth = int(settings.recursion_max)
    russian = float(settings.russian)
    clamp = float(settings.clamp)
    R = px.shape[0]
    hw = cam.xres * cam.yres

    pixel_id = (py.astype(jnp.uint32) * jnp.uint32(cam.xres)
                + px.astype(jnp.uint32))
    s0 = (jnp.uint32(sample0) if isinstance(sample0, int)
          else sample0.astype(jnp.uint32))
    s_end = s0 + jnp.uint32(n_samples)

    def make_ctx(pix, s):
        return smp.SampleCtx(seed=jnp.uint32(seed), pixel=pix,
                             sample=s, mode=sampler_mode,
                             n_set=max(1, int(settings.multisample)))

    # ---- Phase 1: all light subpaths, vectorized over samples.
    pix_f = jnp.tile(pixel_id, n_samples)
    s_f = (jnp.repeat(jnp.arange(n_samples, dtype=jnp.uint32), R)
           + s0)
    ctx_f = make_ctx(pix_f, s_f)
    light_f = _sample_path_light(scene, ctx_f)
    lightdir2 = smp.sample_2d(ctx_f, smp.DIM_LIGHTDIR)
    # Device-varying zero (see the carry note in the light tracer):
    # under shard_map a replicated scalar init would mismatch the
    # per-shard ray-count sum's type.
    lrec, splat_pix, splat_val, rays0 = _trace_light_subpaths(
        scene, meta, settings, cam, ctx_f, tables, mat_pack,
        intersect, light_f, lightdir2, reverse, jnp.sum(px * 0))
    spix = splat_pix.reshape(-1)
    sval = splat_val.reshape(-1, 3)
    good = spix >= 0
    splat_img = jnp.zeros((hw + 1, 3), jnp.float32)
    splat_img = splat_img.at[jnp.where(good, spix, hw)].add(
        jnp.where(good[..., None], sval, 0.0))
    # [R, S, K*22] per-(lane, sample) vertex rows.
    lpack = _pack_light_vertices(lrec, reverse, R, n_samples)

    # ---- Phase 2: queued eye walk (trace_wavefront_queued + BDPT
    # connections).
    class _Q(NamedTuple):
        ro: jnp.ndarray
        rd: jnp.ndarray
        last_tri: jnp.ndarray
        contribution: jnp.ndarray
        alive: jnp.ndarray
        bounce: jnp.ndarray
        s: jnp.ndarray
        sample_rad: jnp.ndarray
        radiance: jnp.ndarray
        rays: jnp.ndarray

    vz_f = px.astype(jnp.float32) * 0.0
    vz_i = px * 0
    init = _Q(
        ro=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        rd=vz_f[:, None] + jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        last_tri=vz_i - 1,
        contribution=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        alive=px < 0,
        bounce=vz_i,
        s=vz_i.astype(jnp.uint32) + s0,
        sample_rad=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        radiance=vz_f[:, None] + jnp.zeros((1, 3), jnp.float32),
        rays=jnp.sum(vz_i) + rays0,
    )

    def cond(q):
        return jnp.any(q.alive | (q.s < s_end))

    def body(q):
        need = (~q.alive) & (q.s < s_end)
        ctx = make_ctx(pixel_id, q.s)
        jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
        if cam.is_simple:
            ro0, rd0 = pixel_rays(cam, px, py, jitter)
        else:
            ro0, rd0 = pixel_rays(
                cam, px, py, jitter,
                lens_sample=smp.sample_2d(ctx, smp.DIM_LENS))
        n3 = need[..., None]
        state = SubpathState(
            ro=jnp.where(n3, ro0, q.ro),
            rd=jnp.where(n3, rd0, q.rd),
            last_tri=jnp.where(need, -1, q.last_tri),
            contribution=jnp.where(n3, 1.0, q.contribution),
            alive=q.alive | need,
            ray_count=q.rays,
        )
        bounce = jnp.where(need, 0, q.bounce)

        light = _sample_path_light(scene, ctx)

        new_state, sp, p0, act, contrib, sky_mask = _extend_path(
            scene, meta, settings, tables, mat_pack, ctx, state,
            bounce.astype(jnp.uint32), bounce + 1, russian, tag=1)

        sky = tex_ops.sky_radiance(scene, -state.rd,
                                   has_envmap=meta.has_envmap)
        sample_rad = q.sample_rad + jnp.where(sky_mask[..., None],
                                              contrib * sky, 0.0)
        total_here = _vertex_radiance(scene, meta, settings, tables,
                                      mat_pack, intersect, light, sp, p0,
                                      active=act)

        # This sample's stored light vertices: one [R, K*22] row
        # gather per iteration, then K connection visibilities.
        s_rel = jnp.clip((q.s - s0).astype(jnp.int32), 0,
                         n_samples - 1)
        rows = jnp.take_along_axis(
            lpack, s_rel[:, None, None], axis=1)[:, 0, :]

        for k in range(reverse):  # static count: unrolled
            lv = _unpack_light_vertex(rows, k)
            total_here = total_here + _connect_to_light_vertex(
                scene, meta, tables, mat_pack, intersect, lv, sp, p0,
                act)

        total_here = jnp.minimum(total_here, clamp)
        sample_rad = sample_rad + jnp.where(act[..., None],
                                            contrib * total_here, 0.0)

        alive_after = new_state.alive & (bounce + 1 < depth)
        ended = state.alive & ~alive_after
        flushed = jnp.minimum(sample_rad, clamp)
        flushed = jnp.where(jnp.isnan(flushed) | (flushed < 0.0), 0.0,
                            flushed)
        e3 = ended[..., None]
        return _Q(ro=new_state.ro, rd=new_state.rd,
                  last_tri=new_state.last_tri,
                  contribution=new_state.contribution,
                  alive=alive_after, bounce=bounce + 1,
                  s=jnp.where(ended, q.s + jnp.uint32(1), q.s),
                  sample_rad=jnp.where(e3, 0.0, sample_rad),
                  radiance=q.radiance + jnp.where(e3, flushed, 0.0),
                  rays=new_state.ray_count)

    final = jax.lax.while_loop(cond, body, init)
    return final.radiance, splat_img, final.rays


def trace_wavefront(scene, meta, settings, cam, ctx, px, py,
                    differentiable: bool = False) -> TraceResult:
    """Trace one eye path (and optional light subpath) per lane.

    differentiable=True uses a fixed-length scan for the bounce loop
    (reverse-mode AD); False uses a while_loop with all-dead early
    exit (faster for forward rendering).
    """
    # Tables ride in the scene pytree (traced args — constants hit an
    # XLA gather slow path) and material scalars are packed into one
    # row table so all per-lane material reads are single row-gathers.
    tables = ltc_ops.LTCTables(rows=scene.ltc_rows)
    mat_pack = bxdf_ops.build_mat_pack(scene.materials)
    intersect = isect.make_intersector(meta)
    depth = int(settings.recursion_max)
    reverse = int(settings.reverse)
    russian = float(settings.russian)
    clamp = float(settings.clamp)

    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    if cam.is_simple:
        ro, rd = pixel_rays(cam, px, py, jitter)
    else:
        ro, rd = pixel_rays(cam, px, py, jitter,
                            lens_sample=smp.sample_2d(ctx, smp.DIM_LENS))

    # One light per path (path_tracer.cpp:315-325).
    areal2 = smp.sample_2d(ctx, smp.DIM_AREAL)
    lightdir2 = smp.sample_2d(ctx, smp.DIM_LIGHTDIR)
    choice2 = smp.sample_2d(ctx, smp.DIM_LIGHT_CHOICE)
    light1 = smp.sample_1d(ctx, smp.DIM_LIGHT_TRI)
    light = light_ops.sample_light(scene, choice2, light1, areal2)
    light = light_ops.offset_sphere_light(light, areal2)

    R = ro.shape[0]
    ray_count0 = jnp.zeros((), jnp.int32)

    # ---------------- Light subpath (reverse > 0) ----------------
    if reverse > 0:
        lrec, splat_pix, splat_val, ray_count0 = _trace_light_subpaths(
            scene, meta, settings, cam, ctx, tables, mat_pack,
            intersect, light, lightdir2, reverse, ray_count0)
    else:
        lrec = None
        splat_pix = jnp.full((R, 0), -1, jnp.int32)
        splat_val = jnp.zeros((R, 0, 3), jnp.float32)

    # ---------------- Eye path ----------------
    e_state = SubpathState(
        ro=ro, rd=rd,
        last_tri=jnp.full((R,), -1, jnp.int32),
        contribution=jnp.ones((R, 3), jnp.float32),
        alive=jnp.ones((R,), bool),
        ray_count=ray_count0,
    )
    radiance0 = jnp.zeros((R, 3), jnp.float32)

    def eye_bounce(carry, bounce_idx):
        state, radiance = carry
        new_state, sp, p0, act, contrib, sky_mask = _extend_path(
            scene, meta, settings, tables, mat_pack, ctx, state, bounce_idx,
            bounce_idx + 1, russian, tag=1)

        # Sky escape
        sky = tex_ops.sky_radiance(scene, -state.rd,
                                   has_envmap=meta.has_envmap)
        radiance = radiance + jnp.where(sky_mask[..., None],
                                        contrib * sky, 0.0)

        # NEE direct light + emission (path_tracer.cpp:427-460, 485-487)
        total_here = _vertex_radiance(scene, meta, settings, tables,
                                      mat_pack, intersect, light, sp, p0,
                                      active=act)

        # BDPT connections to every light vertex
        # (path_tracer.cpp:463-480)
        if reverse > 0:
            def connect(k, acc):
                lv = jax.tree_util.tree_map(lambda a: a[k], lrec)
                return acc + _connect_to_light_vertex(
                    scene, meta, tables, mat_pack, intersect, lv, sp,
                    p0, act)

            total_here = jax.lax.fori_loop(0, reverse, connect, total_here)

        total_here = jnp.minimum(total_here, clamp)
        radiance = radiance + jnp.where(act[..., None],
                                        contrib * total_here, 0.0)
        return (new_state, radiance), None

    if differentiable:
        # scan supports reverse-mode AD (no early exit).
        (e_state, radiance), _ = jax.lax.scan(
            eye_bounce, (e_state, radiance0),
            jnp.arange(depth, dtype=jnp.uint32))
    else:
        # while_loop exits as soon as every lane died (russian
        # roulette kills ~1-p of lanes per bounce; the fixed-length
        # scan would pay full width for mostly-dead tail bounces).
        def w_cond(carry):
            state, _radiance, bounce = carry
            return (bounce < depth) & jnp.any(state.alive)

        def w_body(carry):
            state, radiance, bounce = carry
            (state, radiance), _ = eye_bounce(
                (state, radiance), bounce.astype(jnp.uint32))
            return state, radiance, bounce + 1

        e_state, radiance, _ = jax.lax.while_loop(
            w_cond, w_body, (e_state, radiance0, jnp.zeros((), jnp.int32)))

    # Final clamp + NaN/negative scrub (path_tracer.cpp:502-507).
    radiance = jnp.minimum(radiance, clamp)
    radiance = jnp.where(jnp.isnan(radiance) | (radiance < 0.0), 0.0,
                         radiance)
    return TraceResult(radiance=radiance, rays=e_state.ray_count,
                       splat_pix=splat_pix, splat_val=splat_val)


def render_lanes(scene, meta, settings, cam, px, py, sample_idx, seed,
                 sampler_mode: int = 1, differentiable: bool = False):
    """Render a batch of lanes: px/py int32 [R], sample_idx uint32 [R]
    (globally unique per round x multisample), seed uint32 scalar."""
    pixel_id = (py.astype(jnp.uint32) * jnp.uint32(cam.xres)
                + px.astype(jnp.uint32))
    ctx = smp.SampleCtx(seed=jnp.uint32(seed), pixel=pixel_id,
                        sample=sample_idx.astype(jnp.uint32),
                        mode=sampler_mode,
                        n_set=max(1, int(settings.multisample)))
    return trace_wavefront(scene, meta, settings, cam, ctx, px, py,
                           differentiable=differentiable)


def render_image_round(scene, meta, settings, cam, round_idx: int,
                       seed: int = 42, sampler_mode: int = 1):
    """Render one full round (all pixels x multisample) on the current
    device.  Returns (radiance_sum [H,W,3], counts [H,W], rays int).

    Intended for small/medium images; the driver chunks larger frames.
    Splats (weight-0 side effects) are scattered into the sum.
    """
    xres, yres = cam.xres, cam.yres
    ms = int(settings.multisample)
    yy, xx = jnp.meshgrid(jnp.arange(yres, dtype=jnp.int32),
                          jnp.arange(xres, dtype=jnp.int32), indexing="ij")
    px = jnp.tile(xx.reshape(-1), ms)
    py = jnp.tile(yy.reshape(-1), ms)
    s_local = jnp.repeat(jnp.arange(ms, dtype=jnp.uint32), xres * yres)
    sample_idx = s_local + jnp.uint32(round_idx * ms)

    result = render_lanes(scene, meta, settings, cam, px, py, sample_idx,
                          seed, sampler_mode)
    rad = result.radiance.reshape(ms, yres, xres, 3).sum(axis=0)
    if result.splat_pix.shape[1] > 0:
        flat = jnp.zeros((yres * xres, 3), jnp.float32)
        pix = result.splat_pix.reshape(-1)
        val = result.splat_val.reshape(-1, 3)
        good = pix >= 0
        flat = flat.at[jnp.where(good, pix, 0)].add(
            jnp.where(good[..., None], val, 0.0))
        rad = rad + flat.reshape(yres, xres, 3)
    counts = jnp.full((yres, xres), ms, jnp.float32)
    return rad, counts, result.rays
