"""Test configuration.

Every test runs on the CPU backend with 8 virtual devices, so the
sharding/collective logic is exercised without accelerator hardware
(SURVEY.md section 4.3), and with x64 enabled so the math is validated at
f64 against numpy oracles. The GPU is exercised by ``python chip_smoke.py``
(``--four`` for the mesh path), run on a machine with the card.

Run: ``python -m pytest tests/ -q -m 'not slow' -n 6 --dist loadfile``.
The platform is forced through ``jax.config`` as well as the environment,
in case jax was imported before this file. XLA_FLAGS is read lazily at
backend init, so the host-device-count flag takes effect from here. A
forced-CPU run keeps no persistent compile cache (see
``patolette_tpu/__init__.py``).
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax as _jax

_jax.config.update("jax_platforms", "cpu")
_jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_state_between_modules():
    """Free compiled executables after each test module.

    The suite compiles ~200 XLA:CPU programs; with all of them held live,
    late sharded (8-device) compiles segfault inside XLA
    (backend_compile_and_load / the cache writer — r4, flaky, full-suite
    runs only, never in isolation). Dropping executables between modules
    keeps the compiler's accumulated state small. Cross-module program
    reuse is minor, so the runtime cost is a few recompiles.
    """
    yield
    # our own caches hold references to jitted objects / device grids —
    # drop them so clear_caches can actually free the executables
    try:
        from patolette_tpu.ops import lut as _lut
        from patolette_tpu.parallel import mesh as _mesh

        _lut.clear_grid_cache()
        for _fn in (_mesh.quantize_palette_sharded, _mesh.saliency_sharded,
                    _mesh.dither_sharded, _mesh._ones_program):
            _fn.cache_clear()
    except Exception:
        pass
    _jax.clear_caches()
    gc.collect()
