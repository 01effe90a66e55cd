#!/usr/bin/env python
"""Generate the "colonnade" benchmark scene: a deterministic, procedural
multi-million-triangle stand-in for the reference's sponza flagship
(BASELINE.json configs[3] — the sponza/sibenik OBJ meshes are not
checked into the reference, scenes/sponza-fixed/ has textures only).

Layout mirrors sponza.json's character (reference scenes/sponza.json:
point "sun" intensity 2e4, constant sky, recursion 2, ms 40): an
atrium with two rows of fluted columns on a rippled stone floor,
three LTC-GGX spheres down the aisle, lit by a point sun + sky.

Emits reference-compatible assets so the SAME scene runs through both
renderers (the reference's measured CPU baseline and this one):
  <dir>/ground.obj, columns.obj, spheres.obj   (v//vn, fan faces)
  <dir>/colonnade.json                         (forced per-file material)

Usage: python tools/make_bigscene.py [--dir .scenes/bigscene] [--tris 1000000]
Prints the JSON config path; deterministic for a given --tris.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _write_obj(path: str, verts: np.ndarray, normals: np.ndarray,
               faces: np.ndarray, uvs: np.ndarray = None) -> None:
    """v//vn (or v/vt/vn) OBJ, vectorized formatting (1M faces ~2 s)."""
    with open(path, "w") as f:
        f.write(f"# generated by make_bigscene.py: {len(faces)} tris\n")
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        if uvs is not None:
            np.savetxt(f, uvs, fmt="vt %.6f %.6f")
        np.savetxt(f, normals, fmt="vn %.5f %.5f %.5f")
        ff = faces + 1  # OBJ is 1-based; vt/vn index == v index here
        if uvs is not None:
            np.savetxt(f, np.repeat(ff, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
        else:
            np.savetxt(f, np.repeat(ff, 2, axis=1),
                       fmt="f %d//%d %d//%d %d//%d")


def make_stone_texture(path: str, n: int = 512) -> None:
    """Deterministic procedural stone-tile diffuse texture (PNG):
    value-noise octaves + mortar grid lines, so the textured
    colonnade stresses texture gathers at 1M-tri scale (the
    reference's sponza regime, scenes/sponza.json)."""
    rng = np.random.default_rng(7)
    img = np.zeros((n, n))
    for octave in range(4):
        k = 8 << octave
        coarse = rng.standard_normal((k, k))
        up = np.kron(coarse, np.ones((n // k, n // k)))
        img += up / (1.6 ** octave)
    img = (img - img.min()) / (img.max() - img.min())
    # Mortar lines every 64 px.
    xx = np.arange(n)
    line = ((xx % 64) < 3).astype(float)
    mortar = np.maximum(line[None, :], line[:, None])
    base = 0.45 + 0.35 * img
    rgb = np.stack([base * 1.02, base * 0.98, base * 0.92], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    from PIL import Image
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path)


def make_panels():
    """Emissive quads hung between column pairs: areal lights with
    real area at scene scale, so areal NEE runs in the flagship
    benchmark (the reference's sponza regime has large lights)."""
    quads = []
    for z in (-12.0, 0.0, 12.0):
        for x, nx in ((-3.15, 1.0), (3.15, -1.0)):
            y0, y1 = 4.2, 5.2
            z0, z1 = z - 0.8, z + 0.8
            v = np.array([[x, y0, z0], [x, y0, z1],
                          [x, y1, z1], [x, y1, z0]], np.float32)
            nrm = np.tile(np.array([[nx, 0.0, 0.0]], np.float32),
                          (4, 1))
            f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
            quads.append((v, nrm, f))
    return _merge(quads)


def _grid_faces(nu: int, nv: int, wrap_u: bool = False) -> np.ndarray:
    """Triangulate a (nu x nv) vertex grid into 2*(nu-1|nu)*(nv-1) tris."""
    iu = np.arange(nu if wrap_u else nu - 1)
    iv = np.arange(nv - 1)
    U, V = np.meshgrid(iu, iv, indexing="ij")
    a = V * nu + U
    b = V * nu + (U + 1) % nu if wrap_u else V * nu + U + 1
    c = a + nu
    d = b + nu
    t1 = np.stack([a, b, d], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, d, c], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2]).astype(np.int64)


def make_ground(n: int):
    """Rippled stone floor over [-8, 8] x [-20, 20]."""
    x = np.linspace(-8, 8, n)
    z = np.linspace(-20, 20, int(n * 2.5))
    X, Z = np.meshgrid(x, z, indexing="ij")
    Y = (0.05 * np.sin(1.7 * X) * np.cos(1.3 * Z)
         + 0.02 * np.sin(7.1 * X + 2.0) * np.sin(5.3 * Z + 1.0))
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    # Analytic normals from the height function's gradient.
    dYdX = (0.05 * 1.7 * np.cos(1.7 * X) * np.cos(1.3 * Z)
            + 0.02 * 7.1 * np.cos(7.1 * X + 2.0) * np.sin(5.3 * Z + 1.0))
    dYdZ = (-0.05 * 1.3 * np.sin(1.7 * X) * np.sin(1.3 * Z)
            + 0.02 * 5.3 * np.sin(7.1 * X + 2.0) * np.cos(5.3 * Z + 1.0))
    nrm = np.stack([-dYdX, np.ones_like(Y), -dYdZ], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = _grid_faces(z.size, x.size)  # grid is [x-major rows of z]
    # verts reshaped x-major: index = ix * nz + iz -> grid (nz, nx)
    uvs = np.stack([(X + 8.0) / 4.0, (Z + 20.0) / 4.0],
                   axis=-1).reshape(-1, 2)  # repeat-wrapped tiles
    return (verts.astype(np.float32), nrm.astype(np.float32), faces,
            uvs.astype(np.float32))


def make_column(ntheta: int, nh: int, cx: float, cz: float):
    """One fluted, tapered column (closed side surface only)."""
    th = np.linspace(0, 2 * np.pi, ntheta, endpoint=False)
    y = np.linspace(0.0, 6.0, nh)
    T, Y = np.meshgrid(th, y, indexing="xy")          # [nh, ntheta]
    taper = 1.0 - 0.12 * (Y / 6.0)
    r = 0.55 * taper * (1.0 + 0.06 * np.sin(16 * T) + 0.015 * np.sin(3 * Y))
    X = cx + r * np.cos(T)
    Z = cz + r * np.sin(T)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    # Normals: numerical-free radial approximation with fluting slope.
    drdT = 0.55 * taper * (0.06 * 16 * np.cos(16 * T))
    nx = np.cos(T) + (drdT / np.maximum(r, 1e-6)) * np.sin(T)
    nz = np.sin(T) - (drdT / np.maximum(r, 1e-6)) * np.cos(T)
    ny = 0.12 / 6.0 * 0.55 * np.ones_like(nx)  # taper tilt
    nrm = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = _grid_faces(ntheta, nh, wrap_u=True)
    return verts.astype(np.float32), nrm.astype(np.float32), faces


def make_sphere(n_tris: int, cx: float, cy: float, cz: float, rad: float):
    nv = max(3, int(np.sqrt(n_tris / 4)))
    nu = max(3, n_tris // (2 * nv))
    th = np.linspace(0, np.pi, nv + 1)
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(T) * np.cos(P), np.cos(T),
                  np.sin(T) * np.sin(P)], axis=-1).reshape(-1, 3)
    verts = (np.array([cx, cy, cz]) + rad * n).astype(np.float32)
    faces = _grid_faces(nu, nv + 1, wrap_u=True)
    return verts, n.astype(np.float32), faces


def _merge(parts):
    verts, nrms, faces = [], [], []
    off = 0
    for v, n, f in parts:
        verts.append(v)
        nrms.append(n)
        faces.append(f + off)
        off += len(v)
    return (np.concatenate(verts), np.concatenate(nrms),
            np.concatenate(faces))


CONFIG = {
    "output-file": "colonnade.exr",
    "output-width": 960, "output-height": 540,
    "multisample": 40, "rounds": 1,
    "recursion-max": 2, "russian": 0.74, "clamp": 20.0,
    "camera": {"position": [0.0, 2.2, 16.0], "lookat": [0.0, 1.8, 0.0],
               "fov": 55},
    "sky": {"color255": [160, 190, 255], "intensity": 0.35},
    "lights": [
        {"position": [30.0, 40.0, 25.0], "color255": [255, 244, 210],
         "intensity": 20000.0, "size": 1.0}
    ],
    "materials": [
        {"name": "Stone", "diffuse-texture": "stone.png",
         "brdf": "diffuse"},
        {"name": "Marble", "specular": [0.7, 0.68, 0.62],
         "diffuse": [0.25, 0.24, 0.22], "roughness": 0.2,
         "brdf": "ltc_ggx_diffuse"},
        {"name": "Orb", "specular": [0.825, 0.61, 0.63],
         "roughness": 0.11, "brdf": "ltc_ggx"},
        {"name": "Panel", "brdf": "diffuse",
         "diffuse": [0.2, 0.2, 0.2], "emission": [900, 850, 700]}
    ],
    "scene": [
        {"file": "ground.obj", "material": "Stone"},
        {"file": "columns.obj", "material": "Marble"},
        {"file": "spheres.obj", "material": "Orb"},
        {"file": "panels.obj", "material": "Panel"},
    ],
}


def generate(outdir: str, n_tris: int = 1_100_000) -> str:
    os.makedirs(outdir, exist_ok=True)
    # Triangle budget: ~30% ground, ~55% columns (12), ~15% spheres (3).
    gn = max(64, int(np.sqrt(0.30 * n_tris / 2 / 2.5)))
    ground = make_ground(gn)

    per_col = int(0.55 * n_tris / 12)
    nh = max(8, int(np.sqrt(per_col / 2 / 2.6)))
    ntheta = max(12, per_col // (2 * max(nh - 1, 1)))
    cols = []
    for i in range(6):
        z = -15.0 + 6.0 * i
        for x in (-3.2, 3.2):
            cols.append(make_column(ntheta, nh, x, z))
    columns = _merge(cols)

    per_s = int(0.15 * n_tris / 3)
    spheres = _merge([
        make_sphere(per_s, 0.0, 1.2, -9.0, 1.2),
        make_sphere(per_s, -1.5, 0.9, -1.0, 0.9),
        make_sphere(per_s, 1.6, 1.0, 7.0, 1.0),
    ])

    total = 0
    gv, gn_, gf, guv = ground
    _write_obj(os.path.join(outdir, "ground.obj"), gv, gn_, gf, uvs=guv)
    total += len(gf)
    for name, (v, n, f) in (("columns.obj", columns),
                            ("spheres.obj", spheres),
                            ("panels.obj", make_panels())):
        _write_obj(os.path.join(outdir, name), v, n, f)
        total += len(f)
    make_stone_texture(os.path.join(outdir, "stone.png"))

    cfg_path = os.path.join(outdir, "colonnade.json")
    with open(cfg_path, "w") as f:
        json.dump(CONFIG, f, indent=1)
    print(f"colonnade: {total} triangles -> {cfg_path}")
    return cfg_path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".scenes", "bigscene"))
    ap.add_argument("--tris", type=int, default=1_100_000)
    args = ap.parse_args()
    generate(args.dir, args.tris)
    return 0


if __name__ == "__main__":
    main()
