"""Native OBJ tokenizer vs the pure-python oracle, and multihost
single-process degenerate behavior."""
import numpy as np
import pytest

from rgk.io.obj import load_obj

OBJ = """
mtllib t.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 1 0
usemtl red
f 1/1/1 2/2/1 3/3/1 4/1/1
usemtl blue
f -5/-3/-2 2/2/2 5//2
f 1 2 5
"""

MTL = """
newmtl red
Kd 1 0 0
newmtl blue
Kd 0 0 1
"""


@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "t.obj").write_text(OBJ)
    (tmp_path / "t.mtl").write_text(MTL)
    return str(tmp_path / "t.obj")


def _canon(meshes):
    out = {}
    for m in meshes:
        ca = np.sort(m.positions[m.faces].mean(axis=1), axis=0)
        out[m.material] = (m.faces.shape[0], np.round(ca, 5).tolist())
    return out


def test_native_matches_python(obj_path):
    m_native, mat_n = load_obj(obj_path, use_native=True)
    m_python, mat_p = load_obj(obj_path, use_native=False)
    assert set(mat_n) == set(mat_p) == {"red", "blue"}
    assert _canon(m_native) == _canon(m_python)
    # quad fans into 2 tris; the two blue faces fan into 2
    by_mat = {m.material: m for m in m_native}
    assert by_mat["red"].faces.shape[0] == 2
    assert by_mat["blue"].faces.shape[0] == 2
    # negative indices resolved: -5 == vertex 1
    assert np.allclose(np.sort(by_mat["blue"].positions[:, 2]),
                       np.sort(by_mat["blue"].positions[:, 2]))


def test_native_negative_and_missing_indices(obj_path):
    meshes, _ = load_obj(obj_path, use_native=True)
    blue = [m for m in meshes if m.material == "blue"][0]
    # corner "5//2" has no vt: uv must be (0, 0)
    zero_uv = np.all(blue.uvs == 0.0, axis=1)
    assert zero_uv.any()


def test_multihost_single_process():
    from rgk.parallel import multihost as mh
    mh.initialize()  # no-op
    assert mh.process_count() == 1
    assert mh.process_index() == 0
    lo, hi = mh.host_lane_range(1024)
    assert (lo, hi) == (0, 1024)
    img = np.arange(12.0).reshape(2, 2, 3)
    np.testing.assert_array_equal(mh.allreduce_image(img), img)
    assert mh.broadcast_scalar(3.5) == 3.5


def test_native_unnamed_group(tmp_path):
    """Faces before any usemtl form an implicit unnamed group; the
    native tokenizer must keep a name slot for it (regression: the
    blob join dropped solitary empty names, losing every mesh)."""
    p = tmp_path / "noname.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                 "f 1 2 3\nusemtl M\nf 2 4 3\n")
    for native in (False, True):
        meshes, _ = load_obj(str(p), use_native=native)
        mats = sorted(m.material for m in meshes)
        assert mats == ["", "M"], (native, mats)
