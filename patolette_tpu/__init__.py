"""patolette-tpu: a JAX color quantization + dithering engine.

Brand-new JAX/XLA implementation with the full capability set of the
CPU reference library *patolette* (weighted Wu PCA quantization with
non-axis-aligned principal-axis splits, CIEL*u*v* / ICtCp / sRGB working
spaces, minimum-barrier-distance saliency weighting, weighted KMeans palette
refinement, Riemersma Hilbert-curve error-diffusion dithering), re-designed
for an accelerator: pixels are device-resident (optionally sharded) arrays,
every cluster/bucket statistic is a weighted moment matmul,
nearest-neighbour search is a distance-matrix argmin instead of kd-trees,
and multi-device scaling rides ``jax.sharding`` collectives.

Public API mirrors the reference package facade
(/root/reference/src/patolette/__init__.py, __init__.pyi):

    from patolette_tpu import quantize, ColorSpace_sRGB, ColorSpace_CIELuv, ColorSpace_ICtCp
"""

import os as _os

import jax as _jax

# Persistent compilation cache: the LQ/dither programs take tens of seconds
# to compile per new shape, so later processes reuse them from disk. When
# JAX_COMPILATION_CACHE_DIR is set JAX reads it itself; otherwise the cache
# lives at one fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs). A run forced to the CPU
# (the tests) stays cacheless: XLA:CPU entries are machine code for the
# compiling host's CPU features and can SIGILL when loaded on another host.
# Only the CONFIGURED platform is read — default_backend() would initialize
# the backend at import time, breaking init_distributed-after-import.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
_platform = (
    _jax.config.jax_platforms or _os.environ.get("JAX_PLATFORMS") or ""
).split(",")[0]
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and _platform != "cpu":
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

from patolette_tpu.utils.config import (  # noqa: F401
    ColorSpace,
    ColorSpace_CIELuv,
    ColorSpace_ICtCp,
    ColorSpace_sRGB,
    QuantizeOptions,
    default_options,
)
from patolette_tpu.utils.errors import ExitCode, exit_code_message  # noqa: F401
from patolette_tpu.models.pipeline import quantize, quantize_options  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "quantize",
    "quantize_options",
    "ColorSpace",
    "ColorSpace_sRGB",
    "ColorSpace_CIELuv",
    "ColorSpace_ICtCp",
    "QuantizeOptions",
    "default_options",
    "ExitCode",
    "exit_code_message",
]
