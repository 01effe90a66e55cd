#!/usr/bin/env python
"""End-to-end A/B of the intersection route on a GPU: the Pallas-Triton
kernels against XLA's plain version.

Renders two scenes through `RenderDriver` and times steady-state
rounds (extension rays, the reference's counter):

* cornell   — tools/cornell_scene.py at 1024^2, multisample 16,
  recursion 10 (flat sweep);
* colonnade — tools/make_bigscene.py, 1M triangles, 512^2,
  multisample 16 (BVH traversal).

Variants, compared in the order A B B A within one process:

* kernel — as shipped: the Pallas-Triton kernels of
  ops/triton_intersect.py;
* plain  — the plain-JAX intersectors (`intersect_brute`,
  `intersect_bvh`) compiled by XLA for the GPU.

With `--trace DIR`, one more kernel-variant round per scene runs under
`jax.profiler`, and the per-operation device time of its trace is
printed (top operations, device busy share of the traced window).

Prints one JSON line per measurement, each naming the card and its
power limit.  Needs a GPU.

Usage: python tools/prof_dispatch.py [--rounds N] [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
WORK = os.path.join(HERE, ".scenes")


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, limit = (x.strip() for x in out.stdout.splitlines()[0].split(","))
    return {"card": name, "power_limit": limit}


@contextlib.contextmanager
def variant(name: str):
    """Patch the process for one variant; traced code picks it up."""
    from rgk.ops import intersect as isect
    from rgk.ops import triton_intersect as tk

    saved = (tk.sweep, tk.traverse)
    if name == "plain":
        tk.sweep, tk.traverse = isect.intersect_brute, isect.intersect_bvh
    elif name != "kernel":
        raise ValueError(name)
    try:
        yield
    finally:
        tk.sweep, tk.traverse = saved


def scenes():
    from rgk.scene.config import load_config
    from tools import make_bigscene
    from tools.cornell_scene import scene_dict

    os.makedirs(os.path.join(WORK, "cornell"), exist_ok=True)
    cb = os.path.join(WORK, "cornell", "cornell-ab.json")
    with open(cb, "w") as f:
        json.dump(scene_dict(res=1024, ms=16), f)
    col_dir = os.path.join(WORK, "colonnade")
    if not os.path.exists(os.path.join(col_dir, "colonnade.json")):
        make_bigscene.generate(col_dir, 1_000_000)
    col = os.path.join(col_dir, "colonnade-ab.json")
    with open(col, "w") as f:
        json.dump(dict(make_bigscene.CONFIG, **{
            "output-width": 512, "output-height": 512,
            "multisample": 16}), f)
    return {"cornell": load_config(cb), "colonnade": load_config(col)}


def measure(cfg, arrays, meta, rounds: int, trace_dir=None) -> dict:
    import jax

    from rgk.driver.render import RenderDriver

    d = RenderDriver(cfg.settings, arrays, meta, cfg.get_camera())
    compile_s = d.compile()
    d.render_round(0)
    jax.block_until_ready(d._acc_dev)
    rays0 = float(d._rays_dev)
    t0 = time.perf_counter()
    ctx = (jax.profiler.trace(trace_dir) if trace_dir
           else contextlib.nullcontext())
    with ctx:
        for r in range(1, 1 + rounds):
            d.render_round(r)
        jax.block_until_ready(d._acc_dev)
    dt = time.perf_counter() - t0
    rays = float(d._rays_dev) - rays0
    return dict(mrays_per_s=rays / dt / 1e6, round_seconds=dt / rounds,
                rays_per_round=rays / rounds, compile_seconds=compile_s)


def device_time(trace_dir: str, top: int = 15) -> dict:
    """Per-operation device time of a profiler trace: the events of
    the GPU planes' stream lines, grouped by name, and the busy share
    (union of event intervals over the traced window)."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                     "*.xplane.pb"))[-1:]
    per_op, spans, lines = {}, [], set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    total = sum(per_op.values())
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return dict(lines=sorted(lines), window_ms=window / 1e6,
                busy_ms=busy / 1e6,
                idle_share=1.0 - busy / window if window else None,
                top_ops=[{"op": k[:120], "ms": v / 1e6,
                          "share": v / total} for k, v in ops])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--trace", metavar="DIR")
    args = p.parse_args()

    import jax
    if any(d.platform != "gpu" for d in jax.devices()):
        print(f"prof_dispatch: no GPU: {jax.devices()}", file=sys.stderr)
        return 1
    from rgk.scene.config import build_scene
    from rgk.utils.cache import enable_compile_cache

    enable_compile_cache()
    card = _card()
    for scene, cfg in scenes().items():
        t0 = time.perf_counter()
        arrays, meta, _ = build_scene(cfg)
        commit_s = time.perf_counter() - t0
        for run, name in enumerate(("kernel", "plain", "plain", "kernel")):
            with variant(name):
                res = measure(cfg, arrays, meta, args.rounds)
            print(json.dumps(dict(card, scene=scene, variant=name, run=run,
                                  commit_seconds=commit_s, **res)),
                  flush=True)
        if args.trace:
            tdir = os.path.join(args.trace, scene)
            res = measure(cfg, arrays, meta, 1, trace_dir=tdir)
            print(json.dumps(dict(card, scene=scene, variant="kernel",
                                  traced=True, **res,
                                  **device_time(tdir))), flush=True)
        del arrays
    print(json.dumps(dict(card, peak_bytes_in_use=jax.devices()[0]
                          .memory_stats()["peak_bytes_in_use"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
