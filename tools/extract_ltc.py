#!/usr/bin/env python
"""Extract the LTC fitted-matrix tables from the reference's generated
data files into an .npz asset.

The reference ships 64x64 linearly-transformed-cosine fits for GGX and
Beckmann as generated C++ arrays (reference src/LTC/ltc_ggx.cpp,
ltc_beckmann.cpp: `tabM[4096]` of column-major 3x3 doubles and
`tabAmplitude[4096]` floats, indexed [alpha + theta*64]).  These are
*data*, not code — the same role as the scene meshes — and are packed
here into rgk/data/ltc_tables.npz with shape [64, 64, 3, 3]
(theta, alpha) in standard row-major math convention (M @ v == the
reference's glm M * v).

Usage: python tools/extract_ltc.py [reference_dir] [out_npz]
"""

import os
import re
import sys

import numpy as np


def parse_tables(path: str):
    with open(path, "r") as f:
        text = f.read()

    size_m = re.search(r"const\s+int\s+size\s*=\s*(\d+)", text)
    size = int(size_m.group(1))
    n = size * size

    def grab_array(name):
        m = re.search(rf"{name}\s*\[[^\]]*\]\s*=\s*\{{", text)
        if not m:
            raise ValueError(f"array {name} not found in {path}")
        start = m.end() - 1
        depth = 0
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    return text[start + 1:i]
        raise ValueError(f"unterminated array {name}")

    num_re = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")

    mat_body = grab_array("tabM")
    mats = num_re.findall(mat_body)
    if len(mats) != n * 9:
        raise ValueError(f"expected {n*9} matrix entries, got {len(mats)}")
    # Column-major glm entries m[3j+i] -> M_np[i, j].
    m = np.asarray(mats, np.float64).reshape(size, size, 3, 3)
    m = np.swapaxes(m, -1, -2)  # -> row-major math convention

    amp_body = grab_array("tabAmplitude")
    amps = num_re.findall(amp_body)
    if len(amps) != n:
        raise ValueError(f"expected {n} amplitudes, got {len(amps)}")
    a = np.asarray(amps, np.float64).reshape(size, size)

    return m.astype(np.float32), a.astype(np.float32)


def main():
    ref = sys.argv[1] if len(sys.argv) > 1 else "/root/reference"
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(__file__), "..", "rgk", "data", "ltc_tables.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)

    ggx_m, ggx_a = parse_tables(os.path.join(ref, "src/LTC/ltc_ggx.cpp"))
    bec_m, bec_a = parse_tables(os.path.join(ref, "src/LTC/ltc_beckmann.cpp"))
    np.savez_compressed(out, ggx_m=ggx_m, ggx_amp=ggx_a,
                        beckmann_m=bec_m, beckmann_amp=bec_a)
    print(f"wrote {out}: ggx {ggx_m.shape}, beckmann {bec_m.shape}")


if __name__ == "__main__":
    main()
