#!/usr/bin/env python
"""Generate LTC parity goldens from the REFERENCE renderer's own LTC
runtime (reference src/LTC/ltc.cpp).

Compiles tools/refbuild/ltc_dump.cpp against the reference LTC objects
(tools/refbuild/build.sh must have run), evaluates GetPDF / GetRandom
on a deterministic grid of (kind, Vi, Vr, alpha, rand_hscos) rows, and
stores both the inputs and the reference outputs under tests/goldens/:

    tests/goldens/ltc_inputs.npy   f32 [N, 11]
    tests/goldens/ltc_ref.npy      f32 [N, 4] = (pdf, sample.xyz)

tests/test_ltc_parity.py asserts rgk/ops/ltc.py matches.

Usage: python tools/make_ltc_goldens.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "refbuild", "build")
GOLDENS = os.path.join(HERE, "..", "tests", "goldens")


def make_inputs() -> np.ndarray:
    """Deterministic evaluation grid, away from degenerate poles.

    theta_i stays in (0, pi/2); the reference's frame construction
    (ltc.cpp GetPDF:64-69) divides by sin(theta_i) via unnormalized
    cross products, so grazing Vi==N is excluded by both renderers.
    """
    rng = np.random.default_rng(20260820)
    rows = []
    for kind in (0.0, 1.0):
        for theta_i in (0.08, 0.3, 0.6, 0.9, 1.2, 1.45):
            for phi_i in (0.3, 2.1, 4.4):
                vi = np.array([np.sin(theta_i) * np.cos(phi_i),
                               np.sin(theta_i) * np.sin(phi_i),
                               np.cos(theta_i)])
                for alpha in (0.01, 0.05, 0.11, 0.3, 0.6, 0.95):
                    # 4 eval dirs (upper hemisphere, cosine-weighted)
                    # + 4 cosine-hemisphere rand vectors per cell.
                    u = rng.random((4, 2))
                    r = np.sqrt(u[:, 0])
                    ph = 2 * np.pi * u[:, 1]
                    vr = np.stack([r * np.cos(ph), r * np.sin(ph),
                                   np.sqrt(1 - u[:, 0])], axis=1)
                    u2 = rng.random((4, 2))
                    r2 = np.sqrt(u2[:, 0])
                    ph2 = 2 * np.pi * u2[:, 1]
                    rnd = np.stack([r2 * np.cos(ph2), r2 * np.sin(ph2),
                                    np.sqrt(1 - u2[:, 0])], axis=1)
                    for k in range(4):
                        rows.append([kind, *vi, *vr[k], alpha, *rnd[k]])
    return np.asarray(rows, dtype=np.float32)


def main() -> int:
    binary = os.path.join(BUILD, "ltc_dump")
    objs = [os.path.join(BUILD, f"_root_reference_src_LTC_{n}.o")
            for n in ("ltc_cpp", "ltc_beckmann_cpp", "ltc_ggx_cpp")]
    objs += [os.path.join(BUILD, "_root_reference_src_global_config_cpp.o"),
             os.path.join(BUILD, "_root_reference_src_utils_cpp.o"),
             os.path.join(BUILD, "_root_reference_src_out_cpp.o")]
    for o in objs:
        if not os.path.exists(o):
            print(f"missing {o}; run tools/refbuild/build.sh first",
                  file=sys.stderr)
            return 1
    subprocess.run(
        ["g++", "-std=gnu++11", "-O2", "-w",
         "-I", os.path.join(HERE, "refbuild", "include"),
         os.path.join(HERE, "refbuild", "ltc_dump.cpp"), *objs,
         "-o", binary],
        check=True)

    inputs = make_inputs()
    os.makedirs(GOLDENS, exist_ok=True)
    in_path = os.path.join(GOLDENS, "ltc_inputs.npy")
    out_path = os.path.join(GOLDENS, "ltc_ref.npy")
    np.save(in_path, inputs)
    subprocess.run([binary, in_path, out_path], check=True)
    ref = np.load(out_path)
    print(f"wrote {in_path} {inputs.shape} and {out_path} {ref.shape}; "
          f"pdf range [{ref[:, 0].min():.4g}, {ref[:, 0].max():.4g}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
