"""Where the compile cache lands, the device check of chip_smoke.py, and
optional dependencies off the main path. The cache cases run in a
subprocess so this worker's JAX configuration is untouched."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CACHE_PROBE = """
import json, os
import jax, jax.numpy as jnp
from pslam.utils.backend import enable_compile_cache
path = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({"path": path,
                  "config": jax.config.jax_compilation_cache_dir}))
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", CACHE_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("use_env", [True, False])
def test_compile_cache_location(tmp_path, use_env):
    if use_env:
        got = _probe(tmp_path / "cache")
        assert got["path"] == got["config"] == str(tmp_path / "cache")
        assert os.listdir(tmp_path / "cache")  # the compiled entry landed
    else:
        got = _probe(None)
        want = os.path.join(REPO, ".jax_cache")
        assert got["path"] == got["config"] == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_optional_dependency_names_its_package(monkeypatch):
    from pslam.utils import require

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="Pillow"):
        require("PIL.Image", "Pillow")
