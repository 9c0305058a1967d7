"""Host<->device transfers and the channel-planar image format.

The reference marshals images as Fortran-order (column-major) ``(N, 3)``
doubles across its FFI boundary (/root/reference/src/patolette/
patolette.pyx:383-426, patolette.c:126-129). Here the analogue of that
boundary is the host<->device link, and images cross it as three compact
``(N,)`` channel vectors — the same column-major layout the reference
uses. Device programs then read each channel with unit stride (coalesced)
and never hold an interleaved ``(N, 3)`` copy of a full image; only small
palettes and subsamples are interleaved.

uint8 images cross the link as raw bytes (1/4 the f32 bytes) and are
normalized to [0, 1] f32 on device, where the cast is free.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("step",))
def _slice_1d(x, start, step: int):
    return jax.lax.dynamic_slice_in_dim(x, start, step)


@jax.jit
def _normalize_u8(a, b, c):
    s = jnp.float32(1.0 / 255.0)
    return (a.astype(jnp.float32) * s, b.astype(jnp.float32) * s,
            c.astype(jnp.float32) * s)


def put_planar_image(colors):
    """(N, 3) host image -> 3 x (N,) f32 sRGB channels in [0, 1] on device.

    Accepts uint8 in [0, 255] (transferred as raw bytes) or float in [0, 1]
    (transferred as f32). The host-side per-channel copy is the same
    column-major marshalling the reference performs (pyx:388-394)."""
    colors = np.asarray(colors)
    if colors.dtype == np.uint8:
        chans = [jnp.asarray(colors[:, k]) for k in range(3)]
        return _normalize_u8(*chans)
    colors = colors.astype(np.float32, copy=False)
    return tuple(jnp.asarray(colors[:, k]) for k in range(3))


def put_planar_raw(colors_u8):
    """(N, 3) uint8 -> 3 x (N,) RAW uint8 channels on device.

    No normalization: for consumers that repack the bytes (e.g. the
    packed single-gather dither feed)."""
    colors_u8 = np.asarray(colors_u8)
    return tuple(jnp.asarray(colors_u8[:, k]) for k in range(3))


def put_vector(w):
    """(N,) host float vector -> (N,) f32 on device."""
    return jnp.asarray(np.asarray(w, dtype=np.float32))


@jax.jit
def _to_u8(x):
    return x.astype(jnp.uint8)


@jax.jit
def _to_u16(x):
    return x.astype(jnp.uint16)


def narrow_map(pmap_dev, palette_size: int):
    """Narrow a device int32 palette map to its minimal wire dtype NOW.

    Callers that keep several maps resident (the strip-streamed path)
    dispatch this inside their loop so each waiting strip holds 1-2 B/px
    instead of 4 (ADVICE r4: unbounded int32 residency near the 1.6 Gpx
    cap). ``get_palette_map`` accepts the already-narrow array."""
    if palette_size <= 256:
        return _to_u8(pmap_dev)
    if palette_size <= 65536:
        return _to_u16(pmap_dev)
    return pmap_dev


def get_palette_map(pmap_dev, palette_size: int):
    """Device->host palette-map pull at minimal wire width.

    Public dtype is int32 (reference pyx:441-466); the wire uses
    uint8/uint16 when the palette fits, widened on the host for free.
    Accepts either the raw int32 map or one pre-narrowed by
    :func:`narrow_map`."""
    if pmap_dev.dtype == jnp.int32:
        pmap_dev = narrow_map(pmap_dev, palette_size)
    if pmap_dev.dtype == jnp.int32:  # palette too wide to narrow
        return np.asarray(pmap_dev).astype(np.int32, copy=False)
    return np.asarray(pmap_dev).astype(np.int32)
