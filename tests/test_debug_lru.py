"""Debug-pixel tracer (reference -d X Y) and the LRU utility."""
import numpy as np

from rgk.integrator.debug import trace_pixel_debug
from rgk.scene.config import build_scene, load_config
from rgk.utils.lru import LRU


def test_debug_pixel_trace(cornell_json):
    cfg = load_config(cornell_json)
    s = cfg.settings
    s.xres = s.yres = 64
    s.recursion_max = 6
    arrays, meta, _ = build_scene(cfg, build_bvh=False)
    cam = cfg.get_camera()
    lines = []
    recs = trace_pixel_debug(arrays, meta, s, cam, 32, 32,
                             printer=lines.append)
    assert recs, "no bounce records"
    assert recs[0]["hit"], "center pixel of the cornell box must hit"
    assert 0 <= recs[0]["mat_id"] < meta.n_materials
    assert any("camera ray" in ln for ln in lines)
    # contribution is monotonically non-increasing per channel before
    # russian-roulette compensation at the default settings
    c0 = np.asarray(recs[0]["contribution_in"])
    assert np.all(c0 == 1.0)
    # determinism
    recs2 = trace_pixel_debug(arrays, meta, s, cam, 32, 32,
                              printer=lambda *_: None)
    assert recs[0]["pos"] == recs2[0]["pos"]


def test_lru():
    c = LRU(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1       # refresh a
    c.put("c", 3)                # evicts b (LRU)
    assert "b" not in c
    assert c.get("a") == 1 and c.get("c") == 3
    assert len(c) == 2
    assert c.get("missing", 42) == 42
