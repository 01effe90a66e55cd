#!/usr/bin/env python
"""Benchmark: wavefront path-tracing throughput on the attached device.

Three regimes:

* cornell-box (tools/cornell_scene.py, the reference's cornell-box
  configuration: analytic geometry, areal light, RR) — the flat-sweep
  wavefront regime;
* bdpt_box (tools/bdpt_scene.py, reverse=4) — the bidirectional
  regime (reference box2-class), through the queued BDPT tracer;
* colonnade (tools/make_bigscene.py, ~1M triangles) — the BVH
  regime standing in for the reference's sponza flagship
  (BASELINE.json configs[3]; the sponza OBJ is not in the repo).

Throughput counts extension rays only, matching the reference's own
counter semantics (reference src/path_tracer.cpp:126,
render_driver.cpp:136-137).

Baselines are the reference renderer's MEASURED CPU throughput:
RGKrt compiled from the reference's sources (tools/refbuild) and
timed by tools/measure_baseline.py on a 2-vCPU host; the numbers are
recorded in tools/baseline_measured.json.

Needs a GPU: exits non-zero, printing nothing, when JAX finds none.
Generated scenes go to `.scenes/` (git-ignored).

Prints ONE JSON line; the headline metric/vs_baseline is the
large-scene (colonnade) regime, with the cornell numbers as extra
keys:
    {"metric": "colonnade_1m_mrays_per_s", "value": N,
     "unit": "Mrays/s", "vs_baseline": N,
     "cornell_mrays_per_s": N, "cornell_vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".scenes")

# Measured by tools/measure_baseline.py (RGKrt self-reported rays/s;
# see tools/baseline_measured.json for the full record).  Fallback
# constants are that file's values from the 2-vCPU build host.
_FALLBACK_BASELINES = {"cornell_box": 0.5391, "colonnade": 0.0951,
                       "bdpt_box": 0.4487}


def _baselines() -> dict:
    path = os.path.join(HERE, "tools", "baseline_measured.json")
    try:
        with open(path) as f:
            d = json.load(f)
        return {k: d[k]["mrays_per_s"]
                for k in ("cornell_box", "colonnade", "bdpt_box")}
    except Exception:
        return dict(_FALLBACK_BASELINES)


def _measure(driver, n_rounds: int) -> float:
    """Steady-state extension-ray throughput in Mrays/s."""
    import jax

    driver.render_round(0)  # warmup: compiles
    jax.block_until_ready(driver._rays_dev)
    rays0 = float(driver._rays_dev)
    t0 = time.time()
    for r in range(1, 1 + n_rounds):
        driver.render_round(r)
    jax.block_until_ready(driver._rays_dev)
    dt = time.time() - t0
    return (float(driver._rays_dev) - rays0) / dt / 1e6


def _write_json(sub: str, name: str, d: dict) -> str:
    os.makedirs(os.path.join(WORK, sub), exist_ok=True)
    p = os.path.join(WORK, sub, name)
    with open(p, "w") as f:
        json.dump(d, f)
    return p


def bench_cornell() -> float:
    from rgk.driver.render import RenderDriver
    from rgk.scene.config import build_scene, load_config

    from tools.cornell_scene import scene_dict

    cfg = load_config(_write_json("cornell", "cornell-box.json",
                                  scene_dict()))
    s = cfg.settings
    s.xres = s.yres = 512
    # The reference's flagship config renders this scene at
    # multisample=400; 64 samples per round keeps each timed round
    # ~0.5 s while exercising the same queued-wavefront regime.
    s.multisample = 64
    s.recursion_max = 10
    arrays, meta, _ = build_scene(cfg, build_bvh=True)
    driver = RenderDriver(s, arrays, meta, cfg.get_camera(),
                          chunk_lanes=1 << 21)
    return _measure(driver, 2)


def bench_colonnade() -> tuple[float, float, float]:
    from rgk.driver.parity import image_parity
    from rgk.driver.render import RenderDriver
    from rgk.scene.config import build_scene, load_config

    scene_dir = os.path.join(WORK, "colonnade")
    cfg_path = os.path.join(scene_dir, "colonnade.json")
    if not os.path.exists(cfg_path):
        subprocess.run(
            [sys.executable, os.path.join(HERE, "tools", "make_bigscene.py"),
             "--dir", scene_dir, "--tris", "1000000"],
            check=True, stdout=subprocess.DEVNULL)
    cfg = load_config(cfg_path)
    s = cfg.settings
    s.xres = s.yres = 512
    s.multisample = 16
    t0 = time.time()
    arrays, meta, _ = build_scene(cfg, build_bvh=True)
    commit_s = time.time() - t0  # native binned-SAH build + upload
    parity = image_parity(arrays, meta, s, cfg.get_camera())
    if not parity["ok"]:
        raise RuntimeError(f"colonnade image parity FAILED: {parity}")
    driver = RenderDriver(s, arrays, meta, cfg.get_camera(),
                          chunk_lanes=1 << 20)
    return _measure(driver, 2), commit_s, parity["corr_trimmed"]


def bench_bdpt() -> float:
    """Bidirectional regime (reverse=4): the shared box2-class scene
    (tools/bdpt_scene.py — the identical JSON RGKrt renders for the
    baseline in tools/measure_baseline.py), driven through the queued
    BDPT tracer.  Throughput keeps the reference's extension-ray
    counter semantics (light + eye subpath extensions)."""
    from rgk.driver.render import RenderDriver
    from rgk.scene.config import build_scene, load_config

    from tools.bdpt_scene import scene_dict

    cfg = load_config(_write_json("bdpt", "bdpt_box.json",
                                  scene_dict(res=512, ms=16)))
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    driver = RenderDriver(cfg.settings, arrays, meta, cfg.get_camera(),
                          chunk_lanes=1 << 21)
    return _measure(driver, 2)


def main() -> int:
    import jax

    devices = jax.devices()
    if not devices or any(d.platform != "gpu" for d in devices):
        print(f"bench: no GPU: {devices}", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rgk.utils.cache import enable_compile_cache

    enable_compile_cache()

    base = _baselines()
    cornell = bench_cornell()
    bdpt = bench_bdpt()
    colonnade, commit_s, parity = bench_colonnade()

    print(json.dumps({
        "metric": "colonnade_1m_mrays_per_s",
        "value": round(colonnade, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(colonnade / base["colonnade"], 3),
        "cornell_mrays_per_s": round(cornell, 3),
        "cornell_vs_baseline": round(cornell / base["cornell_box"], 3),
        "bdpt_mrays_per_s": round(bdpt, 3),
        "bdpt_vs_baseline": round(bdpt / base["bdpt_box"], 3),
        "colonnade_commit_s": round(commit_s, 2),
        # GPU vs host-CPU image correlation (trimmed) at identical
        # (seed, pixel, sample) — the pixel gate behind the throughput
        # number (rgk/driver/parity.py image_parity; the bench aborts
        # unless it passes).
        "colonnade_gpu_cpu_parity": round(parity, 4),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
