#!/usr/bin/env python
"""Bring-up check of the renderer on an NVIDIA GPU.

Runs these phases in order and prints one JSON line for each, naming
the card and its power limit (`nvidia-smi`):

* device  — every JAX device is a GPU; the JAX version and XLA_FLAGS.
* kernels — each GPU intersection kernel (rgk/ops/triton_intersect.py)
  against its plain-JAX oracle, compiled for the card: the flat sweep
  on the Cornell box (2^21 camera rays) and the BVH traversal on the
  1M-triangle colonnade (2^20 camera rays and 2^20 cosine-bounce
  rays).  Each runs closest-hit with and without `exclude`, any-hit,
  and a finite t window, and is timed against its oracle.
* render  — three renders through the CLI (`rgk.driver.cli`), each
  writing an EXR: the Cornell box at the reference's settings
  (1024^2, recursion 10, 2 rounds of multisample 16), the colonnade
  at 512^2 multisample 16, and the BDPT box (reverse 4) at 512^2.
  Each EXR must be finite, non-zero and of a mean inside its scene's
  band (EXR_MEAN), and each scene must pass the image parity gate
  against a CPU render (rgk/driver/parity.py).  Reports Mrays/s on the
  reference's counter (extension rays) over the CLI frame, and commit,
  compile and per-round write seconds.

With `--four`, only the four-GPU phase runs: the Cornell box and the
colonnade through `RenderDriver(mesh=MeshContext(4))` against the same
frames on one GPU (equal within MESH_RTOL/MESH_ATOL but for rare
tie flips, MESH_MAX_FLIPS), with the
throughput of steady rounds on each and the scaling efficiency.

The last line is `{"ok": true, "device": {...}}`.  The script exits
non-zero, and prints no such line, when JAX finds no GPU or any phase
fails.  Scenes and images go to `.scenes/` (git-ignored).

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".scenes")

# Kernel-phase widths and render settings (see the module docstring).
FLAT_RAYS = 1 << 21
BVH_RAYS = 1 << 20
COLONNADE_TRIS = 1_000_000
# Four-GPU results equal one-GPU results to float32 rounding
# (parallel/mesh.py; the bound of tests/test_parallel.py) on all but a
# MESH_MAX_FLIPS share of pixels.  A rounding difference can flip which
# triangle an edge-grazing ray hits, and the pixel then differs by a
# whole sample; such flips must stay rare and scattered (the image
# gate of rgk/driver/parity.py).
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_MAX_FLIPS = 1e-4
# Bounds on each render's mean radiance: the image is neither black nor
# blown out.  The BDPT box and the colonnade are darker than the
# Cornell box at their own exposure (means about 0.023 and 0.022 at
# this script's settings), so they get a lower floor.
EXR_MEAN = {"cornell": (0.05, 1.0), "colonnade": (0.01, 1.0),
            "bdpt": (0.01, 1.0)}


class Report:
    """One JSON line per phase, each naming the card."""

    def __init__(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.card_line = out.stdout.strip().splitlines()[0]
        self.card, self.power_limit = (
            x.strip() for x in self.card_line.split(",", 1))
        self.failed = []

    def emit(self, phase, ok, **fields):
        if not ok:
            self.failed.append(phase)
        print(json.dumps({"phase": phase, "ok": bool(ok), "card": self.card,
                          "power_limit": self.power_limit, **fields}),
              flush=True)


# ---------------------------------------------------------------- scenes

def _write_json(path, d):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return path


def cornell_json(res=1024, ms=16, rounds=2):
    from tools.cornell_scene import scene_dict
    return _write_json(os.path.join(WORK, "cornell", "cornell-box.json"),
                       scene_dict(res=res, ms=ms, rounds=rounds))


def colonnade_json(res=512, ms=16, rounds=1):
    """The 1M-triangle colonnade (tools/make_bigscene.py), generated
    once into WORK, at the given frame settings."""
    from tools import make_bigscene
    d = os.path.join(WORK, "colonnade")
    if not os.path.exists(os.path.join(d, "colonnade.json")):
        make_bigscene.generate(d, COLONNADE_TRIS)
    cfg = dict(make_bigscene.CONFIG, **{
        "output-width": res, "output-height": res, "multisample": ms,
        "rounds": rounds})
    return _write_json(os.path.join(d, f"colonnade-{res}.json"), cfg)


def bdpt_json(res=512, ms=16):
    from tools.bdpt_scene import scene_dict
    return _write_json(os.path.join(WORK, "bdpt", "bdpt_box.json"),
                       scene_dict(res=res, ms=ms, reverse=4))


def _load(path):
    from rgk.scene.config import build_scene, load_config
    cfg = load_config(path)
    t0 = time.time()
    arrays, meta, _ = build_scene(cfg)
    return cfg, arrays, meta, time.time() - t0


def _diameter(arrays):
    import numpy as np
    return float(np.linalg.norm(np.asarray(arrays.world_max)
                                - np.asarray(arrays.world_min)))


# --------------------------------------------------------------- kernels

def _camera_rays(cam, n, seed):
    """n jittered camera rays over a 1024^2 frame."""
    import jax.numpy as jnp
    import numpy as np

    from rgk.scene.camera import pixel_rays
    cam = dataclasses.replace(cam, xres=1024, yres=1024)
    lane = np.arange(n) % (1024 * 1024)
    jitter = np.random.default_rng(seed).random((n, 2), np.float32)
    return pixel_rays(cam, jnp.asarray(lane % 1024, jnp.int32),
                      jnp.asarray(lane // 1024, jnp.int32),
                      jnp.asarray(jitter))


def _bounce_rays(arrays, ro, rd, hit, seed):
    """Cosine-distributed rays leaving each camera hit on the side the
    camera ray came from (lanes that missed keep their camera ray);
    the triangle left is their `exclude`."""
    import jax.numpy as jnp
    import numpy as np

    from rgk.ops import warps
    valid = hit.tri >= 0
    tri = jnp.maximum(hit.tri, 0)
    n = arrays.tri_normal[tri]
    n = jnp.where((jnp.sum(n * rd, -1) > 0)[:, None], -n, n)
    u = jnp.asarray(np.random.default_rng(seed).random((ro.shape[0], 2),
                                                       np.float32))
    d = warps.to_hemisphere_cosine_directed(u, n)
    p = ro + hit.t[:, None] * rd + 10.0 * arrays.epsilon * n
    v = valid[:, None]
    return (jnp.where(v, p, ro), jnp.where(v, d, rd),
            jnp.where(valid, hit.tri, -1))


def _timed(fn, *args, reps):
    """(result, median seconds of `reps` warm calls; NaN if none)."""
    import jax
    import numpy as np
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) if ts else float("nan")


def check_kernel(report, name, kernel, oracle, arrays, label, ro, rd,
                 origin_tri=None):
    """Every mode of `kernel` against `oracle` on one ray set whose rays
    leave triangle `origin_tri` (None: camera rays); emits one line and
    returns the oracle's closest hits."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rgk.driver.parity import compare_hits
    from rgk.integrator.path import RAY_FAR

    diameter = _diameter(arrays)
    R = ro.shape[0]
    u = jnp.asarray(np.random.default_rng(R).random((2, R), np.float32))

    def run(fn, t_min, t_max, exclude, any_hit, reps=0):
        f = jax.jit(partial(fn, any_hit=any_hit))
        return _timed(f, arrays, ro, rd, t_min, t_max, exclude, reps=reps)

    plain_o, t_oracle = run(oracle, 0.0, RAY_FAR, None, False, reps=5)
    plain_k, t_kernel = run(kernel, 0.0, RAY_FAR, None, False, reps=5)
    t_first = jnp.where(plain_o.tri >= 0, plain_o.t, RAY_FAR)
    # Windows that start before or after each ray's first hit and
    # reach past it or not.
    w_min = 1.2 * u[0] * jnp.where(plain_o.tri >= 0, plain_o.t, diameter)
    modes = {  # (t_min, t_max, exclude, any_hit)
        "exclude": (0.0, RAY_FAR,
                    plain_o.tri if origin_tri is None else origin_tri,
                    False),
        "any_hit": (0.0, (0.5 + u[1]) * t_first, origin_tri, True),
        "t_window": (w_min, w_min + (0.1 + u[1]) * diameter, origin_tri,
                     False),
    }
    stats = {"closest": compare_hits(plain_k, plain_o, arrays.tri_pack,
                                     ro, rd, diameter)}
    for mode, (t_min, t_max, exclude, any_hit) in modes.items():
        want = run(oracle, t_min, t_max, exclude, any_hit)[0]
        got = run(kernel, t_min, t_max, exclude, any_hit)[0]
        stats[mode] = compare_hits(got, want, arrays.tri_pack, ro, rd,
                                   diameter, any_hit=any_hit)
    report.emit("kernels", all(s["ok"] for s in stats.values()),
                kernel=name, rays=label, lanes=int(R),
                kernel_seconds=t_kernel, oracle_seconds=t_oracle,
                kernel_mrays_per_s=R / t_kernel / 1e6,
                oracle_mrays_per_s=R / t_oracle / 1e6, modes=stats)
    return plain_o


def kernel_phase(report):
    from rgk.ops import intersect as isect
    from rgk.ops import triton_intersect as tk

    cfg, arrays, meta, _ = _load(cornell_json())
    if meta.has_bvh:
        raise RuntimeError("the Cornell box must take the flat path")
    ro, rd = _camera_rays(cfg.get_camera(), FLAT_RAYS, seed=1)
    check_kernel(report, "sweep", tk.sweep, isect.intersect_brute, arrays,
                 "camera", ro, rd)
    del arrays

    cfg, arrays, meta, _ = _load(colonnade_json())
    if not meta.has_bvh:
        raise RuntimeError("the colonnade must take the BVH path")
    ro, rd = _camera_rays(cfg.get_camera(), BVH_RAYS, seed=2)
    first = check_kernel(report, "traverse", tk.traverse,
                         isect.intersect_bvh, arrays, "camera", ro, rd)
    ro, rd, origin = _bounce_rays(arrays, ro, rd, first, seed=3)
    check_kernel(report, "traverse", tk.traverse, isect.intersect_bvh,
                 arrays, "bounce", ro, rd, origin)


# ---------------------------------------------------------------- render

def render_phase(report):
    import numpy as np

    from rgk.driver import cli
    from rgk.driver.parity import image_parity
    from rgk.io.exr import read_exr

    out_dir = os.path.join(WORK, "out")
    for name, path in (("cornell", cornell_json()),
                       ("colonnade", colonnade_json()),
                       ("bdpt", bdpt_json())):
        (driver,) = cli.run([path, "-D", out_dir, "-q"])
        s, st = driver.settings, driver.stats
        img = read_exr(os.path.join(out_dir,
                                    os.path.basename(s.output_file)))
        mean = float(img[..., :3].mean())
        lo, hi = EXR_MEAN[name]
        exr_ok = bool(np.isfinite(img).all() and img.max() > 0
                      and lo <= mean <= hi)
        parity = image_parity(driver.scene, driver.meta, s, driver.camera)
        report.emit("render", exr_ok and parity["ok"], scene=name,
                    res=s.xres, multisample=s.multisample, rounds=st.rounds,
                    recursion_max=s.recursion_max,
                    triangles=driver.meta.n_triangles,
                    mrays_per_s=st.rays / st.seconds / 1e6, rays=st.rays,
                    render_seconds=st.seconds,
                    commit_seconds=st.commit_seconds,
                    compile_seconds=st.compile_seconds,
                    write_seconds=st.write_seconds, exr_mean=mean,
                    exr_ok=exr_ok, parity=parity)


# ------------------------------------------------------------- four GPUs

def four_phase(report):
    import jax
    import numpy as np

    from rgk.driver.parity import compare_images
    from rgk.driver.render import RenderDriver
    from rgk.parallel.mesh import MeshContext

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {jax.devices()}")
    mesh = MeshContext(4)
    for name, path in (("cornell", cornell_json()),
                       ("colonnade", colonnade_json())):
        cfg, arrays, meta, _ = _load(path)
        cam = cfg.get_camera()
        res = {}
        for n_dev, m in ((1, None), (4, mesh)):
            d = RenderDriver(cfg.settings, arrays, meta, cam, mesh=m)
            compile_s = d.compile()
            d.render_round(0)
            rays0 = float(d._rays_dev)
            t0 = time.perf_counter()
            for r in (1, 2):
                d.render_round(r)
            jax.block_until_ready(d._acc_dev)
            dt = time.perf_counter() - t0
            d.fetch_accumulation()
            res[n_dev] = dict(
                img=d.acc.sum, compile_seconds=compile_s,
                mrays_per_s=(d.stats.rays - rays0) / dt / 1e6)
        a, b = res[4].pop("img"), res[1].pop("img")
        bad = (np.abs(a - b) > MESH_ATOL + MESH_RTOL * np.abs(b)).any(-1)
        image = compare_images(a, b)
        report.emit("four", bad.mean() <= MESH_MAX_FLIPS and image["ok"],
                    scene=name,
                    devices=[d.device_kind for d in mesh.devices],
                    rounds=3, pixels_beyond_tolerance=int(bad.sum()),
                    pixels=int(bad.size),
                    max_abs_diff=float(np.abs(a - b).max()),
                    rtol=MESH_RTOL, atol=MESH_ATOL,
                    max_flip_share=MESH_MAX_FLIPS, image=image,
                    one_gpu=res[1], four_gpus=res[4],
                    scaling_efficiency=res[4]["mrays_per_s"]
                    / (4 * res[1]["mrays_per_s"]))


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    args = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    args.add_argument("--four", action="store_true",
                      help="run only the four-GPU mesh phase")
    args = args.parse_args(argv)

    import jax
    devices = jax.devices()
    if not devices or any(d.platform != "gpu" for d in devices):
        print(f"chip_smoke: no GPU: {devices}", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rgk.utils.cache import enable_compile_cache

    enable_compile_cache()
    report = Report()
    report.emit("device", True, jax=jax.__version__,
                xla_flags=os.environ.get("XLA_FLAGS", ""),
                devices=[d.device_kind for d in devices])
    for phase in ((four_phase,) if args.four
                  else (kernel_phase, render_phase)):
        try:
            phase(report)
        except Exception:
            traceback.print_exc()
            report.failed.append(phase.__name__)
    if report.failed:
        print(f"chip_smoke: failed: {report.failed}", file=sys.stderr)
        return 1
    print(report.card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
