#!/usr/bin/env python
"""Measure the REFERENCE renderer's CPU throughput (the baseline).

Runs the locally-built RGKrt binary (tools/refbuild/build.sh) on
reduced-size variants of the benchmark scenes and records its OWN
self-reported throughput ("Average rays per second",
reference src/render_driver.cpp:136-137 — path-extension rays only,
path_tracer.cpp:126) into tools/baseline_measured.json, which
bench.py consumes.

Scenes:
  cornell-box  — the flagship analytic config (scenes/cornell-box.json)
                 at 256^2 / ms=32;
  colonnade    — the procedural 1M-triangle sponza stand-in
                 (tools/make_bigscene.py) at 192^2 / ms=8.

Throughput is per-frame (render loop only; kd-tree build excluded by
the reference's own timer), so it is directly comparable to our
per-round Mrays/s.  rays/s is resolution-independent to first order;
the reduced sizes keep the measurement minutes-long on small hosts.

Usage: python tools/measure_baseline.py [--skip-colonnade]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import platform
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RGKRT = os.path.join(HERE, "refbuild", "build", "RGKrt")
WORK = os.path.join(HERE, "goldens_work")
OUT_JSON = os.path.join(HERE, "baseline_measured.json")

sys.path.insert(0, HERE)
from make_goldens import load_commented_json, prepare_workdir  # noqa: E402


def run_rgkrt(cfg: dict, name: str, cwd: str) -> dict:
    cfg_path = os.path.join(cwd, f"{name}_bench.json")
    cfg["output-file"] = f"{name}_bench.exr"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    t0 = time.time()
    # -v raises verbosity to 3 so "Average rays per second" prints
    # (reference render_driver.cpp:137, out.cpp verbosity gate).
    p = subprocess.run([RGKRT, cfg_path, "-v"], cwd=cwd,
                       capture_output=True, text=True, check=True)
    wall = time.time() - t0
    text = p.stdout + p.stderr

    def grab(pat):
        m = re.search(pat, text)
        if not m:
            print(text[-2000:], file=sys.stderr)
            raise RuntimeError(f"missing {pat!r} in RGKrt output")
        return int(m.group(1).replace("'", ""))

    rays = grab(r"Total rays: ([0-9']+)")
    rays_per_s = grab(r"Average rays per second: ([0-9']+)")
    px_per_s = grab(r"Average pixels per second: ([0-9']+)")
    return {
        "total_rays": rays,
        "rays_per_s": rays_per_s,
        "mrays_per_s": round(rays_per_s / 1e6, 4),
        "pixels_per_s": px_per_s,
        "wall_s_incl_build": round(wall, 1),
        "config": {k: cfg[k] for k in
                   ("output-width", "output-height", "multisample")},
    }


def bench_cornell() -> dict:
    cfg = load_commented_json(
        "/root/reference/scenes/cornell-box.json")
    cfg["output-width"] = cfg["output-height"] = 256
    cfg["multisample"] = 32
    cfg["rounds"] = 1
    return run_rgkrt(cfg, "cornell-box", WORK)


def bench_colonnade(tris: int) -> dict:
    scene_dir = "/tmp/bigscene_baseline"
    subprocess.run([sys.executable, os.path.join(HERE, "make_bigscene.py"),
                    "--dir", scene_dir, "--tris", str(tris)], check=True)
    cfg = load_commented_json(os.path.join(scene_dir, "colonnade.json"))
    cfg["output-width"] = cfg["output-height"] = 192
    cfg["multisample"] = 8
    cfg["rounds"] = 1
    r = run_rgkrt(cfg, "colonnade", scene_dir)
    r["tris"] = tris
    return r


def bench_bdpt() -> dict:
    """Bidirectional regime: the shared box2-class scene
    (tools/bdpt_scene.py) with reverse=4 — identical JSON goes to
    RGKrt here and to the queued-BDPT tracer in bench.py."""
    from bdpt_scene import scene_dict

    d = "/tmp/bdpt_baseline"
    os.makedirs(d, exist_ok=True)
    return run_rgkrt(scene_dict(res=192, ms=8), "bdpt_box", d)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-colonnade", action="store_true")
    ap.add_argument("--tris", type=int, default=1_000_000)
    args = ap.parse_args()

    if not os.path.exists(RGKRT):
        print("Build the reference first: tools/refbuild/build.sh",
              file=sys.stderr)
        return 1
    prepare_workdir()

    result = {
        "host": {
            "nproc": multiprocessing.cpu_count(),
            "platform": platform.platform(),
            "note": ("RGKrt uses hardware_concurrency-1 worker threads "
                     "(reference render_driver.cpp:205-206)"),
        },
    }
    print("[cornell-box] rendering through RGKrt ...", flush=True)
    result["cornell_box"] = bench_cornell()
    print(json.dumps(result["cornell_box"], indent=1), flush=True)
    if not args.skip_colonnade:
        print("[colonnade] rendering through RGKrt ...", flush=True)
        result["colonnade"] = bench_colonnade(args.tris)
        print(json.dumps(result["colonnade"], indent=1), flush=True)
    print("[bdpt_box] rendering through RGKrt ...", flush=True)
    result["bdpt_box"] = bench_bdpt()
    print(json.dumps(result["bdpt_box"], indent=1), flush=True)

    with open(OUT_JSON, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT_JSON}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
