"""The in-repo Cornell box: the reference's cornell-box configuration.

One JSON dict at the reference's own render settings for its
cornell-box scene (SURVEY §2.9: 1024², multisample 400, recursion-max
10, russian 0.74, clamp 20; camera at (0, 1, 6.8) with a 19.5 degree
field of view): five analytic walls, two boxes and a two-triangle area
light at y = 1.98 under the ceiling — 36 triangles and 4 materials, so
the scene takes the flat (no-BVH) intersection path.

Usage:
    python tools/cornell_scene.py OUT.json [--res N] [--ms N] [--rounds N]
"""

from __future__ import annotations

import argparse
import json
import os


def scene_dict(res: int = 1024, ms: int = 400, rounds: int = 1,
               recursion: int = 10) -> dict:
    return {
        "output-file": "cornell-box.exr",
        "output-width": res, "output-height": res,
        "multisample": ms,
        "recursion-max": recursion,
        "russian": 0.74,
        "clamp": 20,
        "rounds": rounds,
        "camera": {"position": [0.0, 1.0, 6.8],
                   "lookat": [0.0, 1.0, 0.0], "fov": 19.5},
        "materials": [
            {"name": "white", "brdf": "diffuse",
             "diffuse": [0.73, 0.73, 0.73]},
            {"name": "red", "brdf": "diffuse",
             "diffuse": [0.63, 0.065, 0.05]},
            {"name": "green", "brdf": "diffuse",
             "diffuse": [0.14, 0.45, 0.091]},
            {"name": "light", "brdf": "diffuse",
             "diffuse": [0.78, 0.78, 0.78],
             "emission": [120.0, 90.0, 45.0]},
        ],
        "scene": [
            # Floor, ceiling, back wall (the box is 2 x 2 x 2).
            {"primitive": "plane", "axis": "Y", "scale": [1, 1, 1],
             "material": "white"},
            {"primitive": "plane", "axis": "Y", "scale": [1, 1, 1],
             "rotate": [0, 0, 180], "translate": [0, 2, 0],
             "material": "white"},
            {"primitive": "plane", "axis": "Y", "scale": [1, 1, 1],
             "rotate": [-90, 0, 0], "translate": [0, 1, -1],
             "material": "white"},
            # Left (red) and right (green) walls, facing inward.
            {"primitive": "plane", "axis": "Y", "scale": [1, 1, 1],
             "rotate": [0, 0, 90], "translate": [-1, 1, 0],
             "material": "red"},
            {"primitive": "plane", "axis": "Y", "scale": [1, 1, 1],
             "rotate": [0, 0, -90], "translate": [1, 1, 0],
             "material": "green"},
            # Tall box at the back left, short box at the front right.
            {"primitive": "cube", "scale": [0.6, 1.2, 0.6],
             "rotate": [0, 17, 0], "translate": [-0.33, 0.6, -0.3],
             "material": "white"},
            {"primitive": "cube", "scale": [0.6, 0.6, 0.6],
             "rotate": [0, -17, 0], "translate": [0.33, 0.3, 0.35],
             "material": "white"},
            # Down-facing area light just under the ceiling.
            {"primitive": "plane", "axis": "Y", "scale": [0.25, 1, 0.2],
             "rotate": [0, 0, 180], "translate": [0, 1.98, 0],
             "material": "light"},
        ],
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--ms", type=int, default=400)
    p.add_argument("--rounds", type=int, default=1)
    a = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(scene_dict(a.res, a.ms, a.rounds), f, indent=1)


if __name__ == "__main__":
    main()
