"""Where importing the package points JAX's persistent compile cache.

Each case imports the package in a fresh interpreter, because the cache
directory is chosen at import time from the environment.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = (
    "import jax, patolette_tpu; "
    "print(repr(jax.config.jax_compilation_cache_dir))"
)


def _cache_dir_after_import(env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_overrides)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True,
    )
    return eval(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("platforms", [None, "cuda", "cpu"])
def test_env_directory_is_left_to_jax(tmp_path, platforms):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    assert _cache_dir_after_import(env) == str(tmp_path)


@pytest.mark.parametrize("platforms", [None, "cuda"])
def test_fixed_in_checkout_directory_otherwise(platforms):
    env = {"JAX_PLATFORMS": platforms} if platforms else {}
    assert _cache_dir_after_import(env) == os.path.join(ROOT, ".jax_cache")


def test_forced_cpu_run_is_cacheless():
    assert not _cache_dir_after_import({"JAX_PLATFORMS": "cpu"})
