"""Entry points: the compile-cache helper and the GPU-only scripts."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(kw)
    return env


_CACHE_PROBE = (
    "import jax; from rgk.utils.cache import enable_compile_cache; "
    "p = enable_compile_cache(); "
    "print(p); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_defaults_to_checkout():
    r = _run(_CACHE_PROBE, _env())
    assert r.returncode == 0, r.stderr
    path, configured = r.stdout.split()
    assert path == configured == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_environment(tmp_path):
    want = str(tmp_path / "cache")
    r = _run(_CACHE_PROBE, _env(JAX_COMPILATION_CACHE_DIR=want))
    assert r.returncode == 0, r.stderr
    # JAX reads the variable itself; the helper sets nothing.
    assert r.stdout.split() == [want, want]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "tools/prof_dispatch.py"])
def test_gpu_scripts_refuse_the_cpu(script):
    """No GPU: exit non-zero and print no result line."""
    r = subprocess.run([sys.executable, script], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
