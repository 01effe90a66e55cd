"""The reference's scenes/ corpus as a parse/build regression suite
(SURVEY §2.9): every config must either build, fail because its mesh
or texture assets are not checked into the reference repo, or fail
with the same config error the reference itself raises on that file.
"""
import glob
import os

import pytest

from rgk.scene.config import ConfigError, build_scene, load_config

from conftest import REFERENCE_SCENES

SCENES = (sorted(glob.glob(os.path.join(REFERENCE_SCENES, "*.json")))
          if REFERENCE_SCENES else [])

# Scene files that are broken in the reference repo itself; the
# reference's own loader throws on them too:
#  - dragon-sponza.json: material lacks the required "brdf" key
#    (Material::LoadFromJson, bxdf.cpp:64 getRequiredString)
#  - teapot.json: material "teapot3" misspells roughness as
#    "rougnhess" (BxDFLTCBase::LoadFromJson, bxdf.cpp:280-288 throws)
KNOWN_BROKEN = {"dragon-sponza.json", "teapot.json"}


@pytest.mark.skipif(not SCENES, reason="reference corpus not mounted")
@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_corpus_scene(path):
    name = os.path.basename(path)
    cfg = load_config(path)          # every config must parse
    cam = cfg.get_camera()           # and yield a camera
    assert cam.xres > 0 and cam.yres > 0
    try:
        arrays, meta, _ = build_scene(cfg, build_bvh=False)
    except FileNotFoundError:
        return  # assets absent from the reference repo (sponza etc.)
    except ConfigError as e:
        if "Unable to find model file" in str(e):
            return  # missing mesh assets
        assert name in KNOWN_BROKEN, f"{name}: unexpected error: {e}"
        return
    assert name not in KNOWN_BROKEN
    assert meta.n_triangles > 0
    cfg.post_check()


def test_corpus_coverage(reference_scenes):
    # A meaningful slice of the corpus must fully build (guards
    # against silently skipping everything via the except paths).
    # Skips, through the fixture, when the corpus is absent.
    built = 0
    for path in sorted(glob.glob(os.path.join(reference_scenes,
                                              "*.json"))):
        try:
            cfg = load_config(path)
            cfg.get_camera()
            build_scene(cfg, build_bvh=False)
            built += 1
        except Exception:
            pass
    # 19 of 39 configs have all assets checked into the reference
    # repo (the rest reference sponza/sibenik/teapot meshes, envmap
    # HDRs, or author-machine absolute texture paths that were never
    # committed — SURVEY §2.9 caveat).
    assert built >= 19, f"only {built} corpus scenes built"


def test_make_bigscene_builds_and_commits(tmp_path):
    """The procedural big-scene generator (tools/make_bigscene.py, the
    sponza stand-in for the flagship benchmark) must keep producing a
    scene that parses and commits through the BVH path — the bench's
    ground-truth pipeline must not rot silently."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = str(tmp_path / "bigscene")
    subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "make_bigscene.py"),
         "--dir", d, "--tris", "4000"],
        check=True, cwd=repo, stdout=subprocess.DEVNULL)
    cfg = load_config(os.path.join(d, "colonnade.json"))
    arrays, meta, _ = build_scene(cfg, build_bvh=True)
    assert meta.n_triangles > 3000
    assert meta.has_bvh
