"""The shared bidirectional benchmark scene (reference box2-class).

One JSON dict consumed by BOTH sides of the comparison: bench.py
renders it through the queued-BDPT tracer, and
tools/measure_baseline.py feeds the identical dict to the locally
compiled reference renderer (RGKrt) for the baseline number.

Analytic primitives only (no asset dependencies): an open box of
diffuse walls lit by a small DOWN-facing emissive quad near the
ceiling, plus a mirror panel — the classic indirect-heavy layout
bidirectional tracing exists for (reference scenes/box2.json:
reverse=4 over an emissive-quad box)."""


def scene_dict(res: int = 192, ms: int = 8, reverse: int = 4) -> dict:
    return {
        "output-file": "bdpt_box.exr",
        "output-width": res, "output-height": res,
        "multisample": ms,
        "recursion-max": 4,
        "reverse": reverse,
        "russian": -1.0,
        "rounds": 1,
        "camera": {"position": [0.0, 1.6, 4.2],
                   "lookat": [0.0, 1.0, 0.0], "fov": 55},
        "materials": [
            {"name": "white", "brdf": "diffuse",
             "diffuse": [0.70, 0.70, 0.70]},
            {"name": "red", "brdf": "diffuse",
             "diffuse": [0.65, 0.12, 0.10]},
            {"name": "green", "brdf": "diffuse",
             "diffuse": [0.12, 0.55, 0.14]},
            {"name": "mirror", "brdf": "mirror"},
            {"name": "glow", "brdf": "diffuse",
             "diffuse": [0.0, 0.0, 0.0], "emission": [42, 40, 34]},
        ],
        "scene": [
            # Floor / ceiling
            {"primitive": "plane", "axis": "Y", "scale": [2.2, 1, 2.2],
             "material": "white"},
            {"primitive": "plane", "axis": "Y", "scale": [2.2, 1, 2.2],
             "rotate": [0, 0, 180], "translate": [0, 2.6, 0],
             "material": "white"},
            # Back / side walls
            {"primitive": "plane", "axis": "Y", "scale": [2.2, 1, 1.3],
             "rotate": [90, 0, 0], "translate": [0, 1.3, -2.2],
             "material": "white"},
            {"primitive": "plane", "axis": "Y", "scale": [1.3, 1, 2.2],
             "rotate": [0, 0, -90], "translate": [-2.2, 1.3, 0],
             "material": "red"},
            {"primitive": "plane", "axis": "Y", "scale": [1.3, 1, 2.2],
             "rotate": [0, 0, 90], "translate": [2.2, 1.3, 0],
             "material": "green"},
            # Mirror panel leaning on the back wall
            {"primitive": "plane", "axis": "Y", "scale": [0.8, 1, 0.9],
             "rotate": [75, 0, 0], "translate": [-1.0, 0.9, -1.9],
             "material": "mirror"},
            # Occluder box in the middle
            {"primitive": "cube", "scale": [0.45, 0.8, 0.45],
             "rotate": [0, 25, 0], "translate": [0.5, 0.8, -0.4],
             "material": "white"},
            # Small down-facing emitter near the ceiling
            {"primitive": "plane", "axis": "Y", "scale": [0.35, 1, 0.35],
             "rotate": [0, 0, 180], "translate": [0, 2.55, 0],
             "material": "glow"},
        ],
    }
