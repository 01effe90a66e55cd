"""Per-pixel debug tracing — the reference's `-d X Y` diagnostics
(reference src/main.cpp:95-107, global_config.hpp ENABLE_DEBUG/IFDEBUG
blocks, e.g. path_tracer.cpp:114-115, 238, 270).

Where the reference sprinkles IFDEBUG prints through the megakernel,
the wavefront integrator is replayed here one bounce at a time for a
single (pixel, sample) lane, dumping the intersection, shading frame,
material decision and path-termination state at every vertex.  Runs
eagerly (no jit) so it works identically on CPU and GPU backends.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import bxdf as bxdf_ops
from ..ops import ltc as ltc_ops
from ..ops import sampler as smp
from ..scene.camera import pixel_rays
from . import path as path_mod


def trace_pixel_debug(scene, meta, settings, cam, x: int, y: int,
                      sample: int = 0, seed: int = 42,
                      sampler_mode: int = 1, printer=print) -> list:
    """Trace one sample of pixel (x, y), printing per-bounce state.

    Returns the list of per-bounce record dicts (also printed via
    `printer`), mirroring the reference's debug-pixel walkthrough.
    """
    tables = ltc_ops.LTCTables(rows=scene.ltc_rows)
    mat_pack = bxdf_ops.build_mat_pack(scene.materials)
    depth = int(settings.recursion_max)
    russian = float(settings.russian)

    px = jnp.asarray([x], jnp.int32)
    py = jnp.asarray([y], jnp.int32)
    pixel_id = jnp.asarray([y * cam.xres + x], jnp.uint32)
    ctx = smp.SampleCtx(seed=jnp.uint32(seed), pixel=pixel_id,
                        sample=jnp.asarray([sample], jnp.uint32),
                        mode=sampler_mode,
                        n_set=max(1, int(settings.multisample)))

    jitter = smp.sample_2d(ctx, smp.DIM_PIXEL_JITTER)
    if cam.is_simple:
        ro, rd = pixel_rays(cam, px, py, jitter)
    else:
        ro, rd = pixel_rays(cam, px, py, jitter,
                            lens_sample=smp.sample_2d(ctx, smp.DIM_LENS))

    printer(f"[debug {x},{y} s{sample}] camera ray o={_v(ro)} d={_v(rd)}")

    state = path_mod.SubpathState(
        ro=ro, rd=rd,
        last_tri=jnp.full((1,), -1, jnp.int32),
        contribution=jnp.ones((1, 3), jnp.float32),
        alive=jnp.ones((1,), bool),
        ray_count=jnp.zeros((), jnp.int32),
    )

    records = []
    names = meta.material_names
    for bounce in range(depth):
        new_state, sp, p0, act, contrib, sky_mask = path_mod._extend_path(
            scene, meta, settings, tables, mat_pack, ctx, state,
            jnp.uint32(bounce), bounce + 1, russian, tag=1)
        rec = {
            "bounce": bounce,
            "sky": bool(sky_mask[0]),
            "hit": bool(act[0]),
            "tri": int(sp.tri[0]),
            "pos": _a(sp.pos),
            "face_n": _a(sp.face_n),
            "light_n": _a(sp.light_n),
            "uv": _a(sp.uv),
            "mat_id": int(sp.mat_id[0]),
            "contribution_in": _a(contrib),
            "contribution_out": _a(new_state.contribution),
            "next_dir": _a(new_state.rd),
            "alive_after": bool(new_state.alive[0]),
        }
        records.append(rec)
        if rec["sky"]:
            printer(f"  b{bounce}: escaped to sky; dir={_v(state.rd)}")
            break
        if not rec["hit"]:
            printer(f"  b{bounce}: no usable hit; terminating")
            break
        mname = (names[rec["mat_id"]]
                 if rec["mat_id"] < len(names) else f"#{rec['mat_id']}")
        printer(f"  b{bounce}: tri {rec['tri']} mat '{mname}' "
                f"p={_v(sp.pos)} n={_v(sp.light_n)} uv={_v(sp.uv)}")
        printer(f"      contribution {_v(contrib)} -> "
                f"{_v(new_state.contribution)}; next d={_v(new_state.rd)}; "
                f"alive={rec['alive_after']}")
        state = new_state
        if not rec["alive_after"]:
            printer(f"      path terminated (russian roulette / cutoff / "
                    f"light leak) after vertex {bounce + 1}")
            break
    return records


def _a(arr):
    return np.asarray(arr[0]).tolist()


def _v(arr):
    vals = np.asarray(arr[0]).reshape(-1)
    return "(" + ", ".join(f"{float(v):.4g}" for v in vals) + ")"
