"""Vectorized Hilbert-curve indexing.

The reference walks the curve with a serial recursive traversal
(reference riemersma.c:176-257). Here we instead
compute each pixel's position along the curve with the standard
iterative bit-manipulation transform (Lam & Shapiro style, the classic
``xy -> d`` rotation loop), fully vectorized over all pixels, then argsort —
turning the serial walk into one gather by a precomputed permutation.

The resulting visit order is a Hilbert curve with a different corner
orientation than the reference's UP-start traversal; dither quality is
orientation-invariant (SURVEY.md H1: quality parity, not bit parity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def curve_order(width: int, height: int) -> int:
    """Smallest order with 2^order >= max(width, height)
    (reference riemersma.c:124-144)."""
    m = max(int(width), int(height))
    level = 0
    while (1 << level) < m:
        level += 1
    return max(level, 1)


def xy_to_d(x, y, order: int):
    """Distance along the Hilbert curve of order ``order`` for integer
    coordinate arrays ``x``, ``y`` (vectorized, O(order) vector ops).

    uint32 is exact through order 16: the curve has 4^order cells, so
    d <= 4^16 - 1 = 2^32 - 1, and every accumulation term s*s*t <= 3*2^30
    fits too. Order 16 (sides up to 65536) covers the reference's full
    40000x40000 validation cap (patolette.c:92, riemersma.c:124-144).
    Beyond 16 the x64 mode sorts a uint64 d exactly.
    """
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    ddtype = jnp.uint32 if order <= 16 else jnp.uint64
    d = jnp.zeros_like(x, dtype=ddtype)
    s = 1 << (order - 1)  # Python int: loop bound is static under jit
    while s > 0:
        su = jnp.uint32(s)
        rx = ((x & su) > 0).astype(jnp.uint32)
        ry = ((y & su) > 0).astype(jnp.uint32)
        d = d + ddtype(s * s) * ((3 * rx) ^ ry).astype(ddtype)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        sm1 = jnp.uint32(s - 1)
        x_f = jnp.where(flip, sm1 - x, x)
        y_f = jnp.where(flip, sm1 - y, y)
        x, y = jnp.where(swap, y_f, x_f), jnp.where(swap, x_f, y_f)
        s >>= 1
    return d


def pixel_visit_order(width: int, height: int):
    """Permutation of pixel indices (row-major) in Hilbert-curve order.

    ``perm[i]`` is the row-major index of the i-th pixel visited.
    """
    order = curve_order(width, height)
    if order > 16 and not jax.config.jax_enable_x64:
        # unreachable through the public API: the 40000px validation cap
        # (utils/errors.py, patolette.c:92) bounds order at 16
        raise NotImplementedError(
            "Hilbert order > 16 requires jax_enable_x64 for exact curve "
            "sorting"
        )
    idx = jnp.arange(width * height, dtype=jnp.uint32)
    x = idx % jnp.uint32(width)
    y = idx // jnp.uint32(width)
    d = xy_to_d(x, y, order)
    return jnp.argsort(d).astype(jnp.int32)
