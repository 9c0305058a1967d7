"""Configuration surface for patolette-tpu.

Mirrors the reference option struct ``patolette__QuantizationOptions``
(/root/reference/lib/include/patolette.h:13-20, defaults at
/root/reference/lib/src/patolette.c:107-119) plus the Python-level
``tile_size`` saliency knob (/root/reference/src/patolette/patolette.pyx:332-343),
extended with fields of its own (mesh/sharding, sampling caps, dither
tiling).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ColorSpace(enum.IntEnum):
    """Working color space for palette generation.

    Values match the reference enum ordering
    (/root/reference/src/patolette/patolette.pyx:15-18).
    """

    sRGB = 0
    CIELuv = 1
    ICtCp = 2


# Reference-parity aliases (reference exports these names from its package
# facade, /root/reference/src/patolette/__init__.py:3-10).
ColorSpace_sRGB = ColorSpace.sRGB
ColorSpace_CIELuv = ColorSpace.CIELuv
ColorSpace_ICtCp = ColorSpace.ICtCp


# Numerical tolerance used throughout, mirroring patolette__DELTA
# (reference uses 1e-16 for f64; we keep the same constant for host-side f64
# control code and a larger one for on-device f32 comparisons).
DELTA_F64 = 1e-16
DELTA_F32 = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantizeOptions:
    """Options for :func:`patolette_tpu.quantize`.

    Reference-parity fields
    -----------------------
    dither:
        Error-diffusion dithering of the palette map (Riemersma / Hilbert).
    palette_only:
        Only generate the palette; skip palette-map generation.
    color_space:
        Working space for palette generation. Dithering always runs in linear
        Rec2020; plain NN mapping in ICtCp (reference patolette.c:135-141).
    kmeans_niter:
        Weighted-KMeans refinement iterations (<=0 disables refinement).
    kmeans_max_samples:
        Max samples for KMeans refinement; hard floor of 256**2 applied as
        ``max_points_per_centroid = max(kmeans_max_samples, 256**2) / k``
        (reference refine.c:77-90).
    tile_size:
        Saliency weighting control; 0 disables saliency. Weight formula is
        ``1 + sal**2 * (rows*cols) / tile_size**2`` (reference pyx:313).
    verbose:
        Structured stage logging.

    Extension fields
    ----------------
    lq_max_samples:
        Deterministic-subsample cap for the GQ/LQ split-decision phase. The
        palette-search stages run on at most this many pixels (weights folded
        in); NN mapping / dithering always use the full image. 0 = no cap.
        The reference runs GQ/LQ on all pixels but refines with KMeans on at
        most ``max(kmeans_max_samples, 256**2)`` samples, so a generous cap
        here is quality-neutral. Divergence documented in README.
    lq_batch_splits:
        Clusters split per LQ round (top-B by benefit). 1 reproduces the
        reference's strictly sequential greedy; the default 8 splits the
        top-8 per round (divergence S6). LQ runs ~8x fewer rounds, each a
        few full passes over the samples, with quality validated neutral
        (tests/test_lq_batch.py); the gain is not measured on the H100.
    dither_segment:
        Hilbert-curve segment length for the parallel dither scan. The error
        queue resets at segment seams (per-shard dither). 0 = fully serial
        (bit-faithful to a single scan chain).
    seed:
        PRNG seed for KMeans subsampling / empty-cluster handling.
    """

    dither: bool = True
    palette_only: bool = False
    color_space: ColorSpace = ColorSpace.ICtCp
    kmeans_niter: int = 32
    kmeans_max_samples: int = 512**2
    tile_size: float = 512.0
    verbose: bool = False

    lq_max_samples: int = 1 << 18
    lq_batch_splits: int = 8
    dither_segment: int = 4096
    seed: int = 1234

    def __post_init__(self):
        if self.tile_size < 0:
            raise ValueError(
                "tile_size parameter expected to be in the range [0, inf]"
            )


def default_options() -> QuantizeOptions:
    """Default options, matching patolette_create_default_options
    (reference patolette.c:107-119)."""
    return QuantizeOptions()
