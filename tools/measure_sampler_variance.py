#!/usr/bin/env python
"""Sampler quality at equal spp: ours vs the reference's stratified.

Round-4 review item 7: the repo's counter-based samplers
(ops/sampler.py) replace the reference's stateful mt19937 +
shuffled-table family (reference src/sampler.cpp:77-116 stratified
default, external/halton_sampler.h Faure permutations).  Equal-seed
goldens pin the *distribution*, but sampler QUALITY is variance at
equal sample budget, which had never been measured.

Method: render cornell-box at RES^2 with spp in {16, 64}; per-pixel
MSE against the same renderer's own 1024-spp converged frame (so each
side is measured against its own bias — this isolates variance).
Ours runs each of sampler modes {stratified, halton, independent} on
whatever backend is active; the reference (tools/refbuild RGKrt,
single thread) runs its default StratifiedSampler.  Lower MSE at
equal spp = better stratification.

Usage: python tools/measure_sampler_variance.py [--res 128]
       [--skip-reference]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

RGKRT = os.path.join(HERE, "refbuild", "build", "RGKrt")


def render_ours(cfg, spp, mode_name, res, seed=7):
    import jax.numpy as jnp

    from rgk.driver.render import RenderDriver
    from rgk.ops.sampler import MODE_NAMES
    from rgk.scene.config import build_scene

    s = cfg.settings
    s.xres = s.yres = res
    s.multisample = spp
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    d = RenderDriver(s, arrays, meta, cfg.get_camera(), seed=seed,
                     sampler_mode=MODE_NAMES[mode_name])
    d.render_round(0)
    d.fetch_accumulation()
    return d.acc.resolve()


def render_ref(workdir, cfg_dict, spp, res):
    cfg = dict(cfg_dict)
    cfg["output-width"] = cfg["output-height"] = res
    cfg["multisample"] = spp
    cfg["output-file"] = f"var_{spp}.exr"
    p = os.path.join(workdir, f"var_{spp}.json")
    with open(p, "w") as f:
        json.dump(cfg, f, indent=1)
    subprocess.run([RGKRT, p], cwd=workdir, capture_output=True,
                   text=True, check=True)
    # the reference writes PIZ-compressed EXRs; decode with its own
    # codec (refbuild exr2npy), as make_goldens does
    exr = os.path.join(workdir, cfg["output-file"])
    npy = exr + ".npy"
    subprocess.run([os.path.join(HERE, "refbuild", "build", "exr2npy"),
                    exr, npy], check=True)
    return np.load(npy)


def mse(a, b):
    """Scale-free relative MSE on RGB only.  The reference writes
    auto-exposed RGBA EXRs (render_driver normalize; alpha == 1)
    while ours are raw-radiance RGB: raw MSE units differ by the
    exposure scale squared, and a constant alpha channel would
    dominate the normalization (it silently turned an early version
    of this ratio into a 100x artifact)."""
    a = np.asarray(a, np.float64)[..., :3]
    b = np.asarray(b, np.float64)[..., :3]
    return float(np.mean((a - b) ** 2) / np.mean(b ** 2))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--truth-spp", type=int, default=1024)
    ap.add_argument("--skip-reference", action="store_true")
    args = ap.parse_args()

    from rgk.scene.config import load_config
    cfg = load_config("/root/reference/scenes/cornell-box.json")

    results = {}
    for mode in ("stratified", "halton", "independent"):
        truth = render_ours(cfg, args.truth_spp, mode, args.res)
        for spp in (16, 64):
            m = mse(render_ours(cfg, spp, mode, args.res), truth)
            results[f"ours_{mode}_{spp}spp"] = m
            print(f"ours {mode:12s} {spp:3d} spp: MSE {m:.3e}",
                  flush=True)

    if not args.skip_reference and os.path.exists(RGKRT):
        import make_goldens
        make_goldens.prepare_workdir()
        work = make_goldens.WORK
        cfg_dict = make_goldens.load_commented_json(
            "/root/reference/scenes/cornell-box.json")
        truth = render_ref(work, cfg_dict, args.truth_spp, args.res)
        for spp in (16, 64):
            m = mse(render_ref(work, cfg_dict, spp, args.res), truth)
            results[f"ref_stratified_{spp}spp"] = m
            print(f"ref  stratified   {spp:3d} spp: MSE {m:.3e}",
                  flush=True)
        for spp in (16, 64):
            ours = results[f"ours_stratified_{spp}spp"]
            ref = results[f"ref_stratified_{spp}spp"]
            print(f"{spp:3d} spp MSE ratio ours/ref: {ours/ref:.3f} "
                  f"(<1 = ours lower variance)", flush=True)

    out = os.path.join(HERE, "sampler_variance.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
