"""Compile-cache placement (utils/platform.py)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("from enarf_gan_tpu.utils.platform import setup_jax, "
          "compile_cache_dir; setup_jax(report=False); import jax; "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(compile_cache_dir())")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        want = str(tmp_path / "cache")
    else:
        want = os.path.join(REPO, ".jax_cache")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [want, want]
