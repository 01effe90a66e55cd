"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without GPUs via
xla_force_host_platform_device_count (the standard JAX idiom).  Must
run before jax is imported anywhere.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; on a GPU
host run them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rgk.utils.cache import enable_compile_cache  # noqa: E402

# Golden/renderer tests re-jit identical programs across runs; first
# run pays, reruns are cheap.
enable_compile_cache()

import signal  # noqa: E402

import pytest  # noqa: E402

# The reference renderer's scene corpus is not part of this repo; the
# golden and corpus tests read it from $RGK_REFERENCE_DIR/scenes when
# that is set, and skip otherwise.
REFERENCE_SCENES = (os.path.join(os.environ["RGK_REFERENCE_DIR"], "scenes")
                    if os.environ.get("RGK_REFERENCE_DIR") else "")

# Per-test timeout: a traversal bug must FAIL fast, not wedge the
# suite (kernel parity tests run interpret-mode Python loops, which
# SIGALRM interrupts fine).  Override per test with
# @pytest.mark.timeout(seconds).
DEFAULT_TEST_TIMEOUT = 300


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test wall-clock limit")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs an NVIDIA GPU (run on the card with "
                    "JAX_PLATFORMS=cuda,cpu)")


@pytest.fixture(scope="session")
def cornell_json(tmp_path_factory):
    """The in-repo Cornell box (tools/cornell_scene.py) at the
    reference's settings, as a config file path."""
    import json

    from tools.cornell_scene import scene_dict
    path = tmp_path_factory.mktemp("cornell") / "cornell-box.json"
    path.write_text(json.dumps(scene_dict()))
    return str(path)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    seconds = int(marker.args[0]) if marker else DEFAULT_TEST_TIMEOUT

    def _on_alarm(signum, frame):
        raise TimeoutError(
            f"test exceeded {seconds}s timeout (tests/conftest.py)")

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def reference_scenes():
    if not REFERENCE_SCENES or not os.path.isdir(REFERENCE_SCENES):
        pytest.skip("reference scene corpus not available")
    return REFERENCE_SCENES
