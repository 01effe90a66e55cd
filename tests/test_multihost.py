"""Multi-host smoke test: 2 CPU processes via jax.distributed.

The driver partitions pixel blocks across processes (contiguous block
slices, parallel/multihost.host_lane_range), every process calls the
collective fetch_accumulation before writes, and process 0 writes the
EXR — replacing the reference's shared-FS `--no-overwrite` frame
claiming (reference src/main.cpp:242-245) with a real collective
runtime (SURVEY §5 "Distributed communication backend").

Determinism contract: sample values are pure functions of
(seed, pixel, sample) and hosts own disjoint pixel blocks, so the
2-process render must be BITWISE identical to the 1-process render.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.cornell_scene import scene_dict  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mini_scene(tmp_path, name: str) -> str:
    """A tiny-budget cornell box: 48x48, ms=2, 2 rounds, depth 3."""
    cfg = scene_dict()
    cfg["output-file"] = name + ".exr"
    cfg["output-width"] = 48
    cfg["output-height"] = 48
    cfg["multisample"] = 2
    cfg["rounds"] = 2
    cfg["recursion-max"] = 3
    path = os.path.join(tmp_path, name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _run_cli(scene, outdir, extra, timeout=600, devices_per_proc=1):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # subprocesses: 1 CPU device each
    if devices_per_proc > 1:
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{devices_per_proc}")
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for argv in extra:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rgk.driver.cli", scene,
             "--cpu", "-D", outdir, "-q"] + argv,
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out.decode())
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"CLI failed:\n{o[-3000:]}"
    return outs


@pytest.mark.timeout(900)
def test_two_process_render_matches_single(tmp_path):
    tmp = str(tmp_path)
    scene = _mini_scene(tmp, "mh-box")

    single_dir = os.path.join(tmp, "single")
    multi_dir = os.path.join(tmp, "multi")
    os.makedirs(single_dir)
    os.makedirs(multi_dir)

    # --chunk-lanes 512 forces n_blocks >= 2 per host (48x48 = 2304 px
    # -> 5 blocks split 3/2) so the disjoint block partition is
    # actually exercised, not just the collectives.
    _run_cli(scene, single_dir, [["--chunk-lanes", "512"]])

    port = _free_port()
    coord = f"localhost:{port}"
    _run_cli(scene, multi_dir, [
        ["--chunk-lanes", "512", "--coordinator", coord,
         "--num-processes", "2", "--process-id", "0"],
        ["--chunk-lanes", "512", "--coordinator", coord,
         "--num-processes", "2", "--process-id", "1"],
    ])

    from rgk.io.exr import read_exr
    a = read_exr(os.path.join(single_dir, "mh-box.exr"))
    b = read_exr(os.path.join(multi_dir, "mh-box.exr"))
    # Bitwise process-count invariance (half precision in the file is
    # shared by both paths, so even the encode rounds identically).
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # The checkpoints agree too (sum/count/round written by proc 0).
    ca = np.load(os.path.join(single_dir, "mh-box.exr.ckpt.npz"))
    cb = np.load(os.path.join(multi_dir, "mh-box.exr.ckpt.npz"))
    np.testing.assert_array_equal(ca["sum"], cb["sum"])
    assert int(ca["next_round"]) == int(cb["next_round"]) == 2


@pytest.mark.timeout(900)
def test_two_process_multichip_matches_single(tmp_path):
    """Multi-host x multi-device composition — the 2-host topology of
    the BASELINE target: 2 processes x 4 virtual CPU
    devices each, a MeshContext over each process's LOCAL devices
    (lanes sharded within a block), pixel blocks split across
    processes.  Each block runs the identical 4-device SPMD program in
    both runs and hosts own disjoint pixels, so the 2-process render
    is BITWISE identical to the 1-process 4-device render."""
    tmp = str(tmp_path)
    scene = _mini_scene(tmp, "mh-mesh")

    single_dir = os.path.join(tmp, "single")
    multi_dir = os.path.join(tmp, "multi")
    os.makedirs(single_dir)
    os.makedirs(multi_dir)

    _run_cli(scene, single_dir,
             [["--chunk-lanes", "512", "--devices", "4"]],
             devices_per_proc=4)

    port = _free_port()
    coord = f"localhost:{port}"
    _run_cli(scene, multi_dir, [
        ["--chunk-lanes", "512", "--devices", "4",
         "--coordinator", coord, "--num-processes", "2",
         "--process-id", "0"],
        ["--chunk-lanes", "512", "--devices", "4",
         "--coordinator", coord, "--num-processes", "2",
         "--process-id", "1"],
    ], devices_per_proc=4)

    from rgk.io.exr import read_exr
    a = read_exr(os.path.join(single_dir, "mh-mesh.exr"))
    b = read_exr(os.path.join(multi_dir, "mh-mesh.exr"))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
