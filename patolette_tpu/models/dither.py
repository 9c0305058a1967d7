"""Riemersma (Hilbert-curve) error-diffusion dithering.

Reference: /root/reference/lib/src/dither/riemersma.c. Semantics kept:

  * dithering runs in linear Rec2020 (riemersma.c:3-7; conversion handled by
    the caller / pipeline, patolette.c:268-298)
  * 16-deep error queue with exponentially decaying weights, ratio 16
    (riemersma.c:62-66, 360-373)
  * error-corrected colors are NOT clamped (riemersma.c:303-312)
  * nearest-palette search in luminance-weighted space with channel scale
    factors sqrt(Rec2020 Y coefficients) (riemersma.c:37-42)

Accelerator reformulation (SURVEY.md section 7, stage 8):
  * the serial recursive curve walk becomes a precomputed Hilbert
    permutation + gather (:mod:`patolette_tpu.ops.hilbert`)
  * the pixel chain becomes ``lax.scan`` with the error queue as carry; the
    FLANN query per pixel becomes a (K,3) distance argmin inside the scan
  * for parallel throughput the curve is tiled into fixed-length segments
    scanned in lock-step lanes (vmap); the error queue resets at segment
    seams (per-shard dither, BASELINE config 5). ``segment=0`` gives the
    fully serial chain.

Measured quality-vs-segment curve (r4, CIELuv-MSE ratio vs the exact
serial native oracle, 4-case battery mean): 0.993 at segment 4096, 0.992
at 2048, 0.992 at 1024, 0.994 at 512, 0.990 at 256, 0.991 at 128 — the
dither is seam-insensitive across the whole range, so the 4096 default
stands (its wall time against the segment length is not measured on the
H100).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from patolette_tpu.ops import colorspace as cs
from patolette_tpu.ops import hilbert

# sqrt of Rec2020 luma coefficients (riemersma.c:38-42)
R_WEIGHT = 0.51254268114958
G_WEIGHT = 0.8234075540095561
B_WEIGHT = 0.2435159132377184

QUEUE = 16   # error queue depth (riemersma.c:66)
QRATIO = 16  # first/last weight ratio (riemersma.c:63)


def _queue_weights(dtype):
    """w_i = m^i / QR, m = exp(ln(QR)/(Q-1)); oldest entry first
    (riemersma.c:360-373)."""
    m = jnp.exp(jnp.log(jnp.asarray(QRATIO, dtype)) / (QUEUE - 1))
    return jnp.power(m, jnp.arange(QUEUE, dtype=dtype)) / QRATIO


@functools.partial(jax.jit, static_argnames=("width", "height", "segment"))
def _dither_stream(colors2020, palette2020, valid, width, height, segment):
    """Interleaved (N, 3) entry point: builds the step-major (seg, 3,
    lanes) stream and delegates to the SAME scan core as the planar and
    packed feeds (one copy of the validated step math — the r5 one-hot/
    outer-product A/B applies everywhere)."""
    n = width * height

    perm = hilbert.pixel_visit_order(width, height)

    seg = int(segment) if segment else n
    seg = max(1, min(seg, n))
    lanes = -(-n // seg)
    # step-major gather (see _step_major_perm: feeding a transposed view
    # through lax.scan reads strided columns every step)
    perm2 = _step_major_perm(perm, seg, lanes, n)
    xs = jnp.take(colors2020, perm2, axis=0).reshape(
        seg, lanes, 3
    ).transpose(0, 2, 1)  # (seg, 3, lanes)
    return _dither_scan_core(xs, palette2020, valid, perm2, n, lanes)


def riemersma_dither(colors_working, palette_working, valid, width, height,
                     color_space, segment=4096):
    """Dither the image against the palette; returns the palette map (N,).

    Converts colors and palette from the working space to linear Rec2020
    (patolette.c:274-287) and runs the segmented scan.
    """
    c2020 = cs.working_to_linear_rec2020(colors_working, color_space)
    p2020 = cs.working_to_linear_rec2020(palette_working, color_space)
    return _dither_stream(
        c2020, p2020, valid, int(width), int(height), int(segment)
    )


def _step_major_perm(perm, seg: int, lanes: int, n: int):
    """Compose the curve permutation with the lane-major -> step-major
    transpose, so scan inputs/outputs are CONTIGUOUS (lanes,) slices.

    Feeding ``stream.reshape(lanes, seg).T`` to ``lax.scan`` is a
    performance trap: XLA does not materialize the transpose, so every
    step reads a strided column of the big stream. Transposing the
    int32 index array once (33 MB) and gathering pixels directly
    into step-major order removes that entirely; the (step, lane) ->
    pixel mapping is unchanged, so results stay bit-identical.

    Pad slots point past the end (index n): gathers clip to the last
    element (harmless garbage lanes), and the inverse scatter drops them
    via ``mode="drop"``.
    """
    pad = lanes * seg - n
    if pad:
        perm = jnp.concatenate(
            [perm.astype(jnp.int32), jnp.full((pad,), n, jnp.int32)]
        )
    return perm.reshape(lanes, seg).T.reshape(-1)  # (seg * lanes,)


@functools.partial(jax.jit, static_argnames=("width", "height", "segment"))
def _dither_stream_planar(ch2020, palette2020, valid, width, height,
                          segment):
    """Channel-planar segmented dither scan.

    Same math as :func:`_dither_stream`, but pixels stay as three (N,)
    channel vectors: streams are (seg, lanes) per channel (step-major via
    :func:`_step_major_perm`), the error queue is (QUEUE, lanes) per
    channel, and the per-step distance matrix is built from rank-1
    channel broadcasts. No interleaved (N, 3) intermediates.
    """
    n = width * height

    perm = hilbert.pixel_visit_order(width, height)

    seg = int(segment) if segment else n
    seg = max(1, min(seg, n))
    lanes = -(-n // seg)
    perm2 = _step_major_perm(perm, seg, lanes, n)

    xs = jnp.stack(
        [jnp.take(ch, perm2).reshape(seg, lanes) for ch in ch2020], axis=1
    )  # (seg, 3, lanes)
    return _dither_scan_core(xs, palette2020, valid, perm2, n, lanes)


def _dither_scan_core(xs, palette2020, valid, perm2, n, lanes):
    """Step-major dither scan shared by the planar and packed feeds.

    ``xs``: (seg, 3, lanes) linear-Rec2020 stream. One stacked op per
    stage rather than a 3-channel-tuple body.

    Step-body formulation:

      * distance as rank-1 outer products instead of a K=3-contraction
        matmul — exact f32, same math as ``precision="highest"``. A
        reduced-precision product is INADMISSIBLE: bf16 products flip a
        large share of the argmins (how many TF32 would flip on the H100
        is not measured).
      * palette selection as a one-hot (K, lanes) matmul instead of a
        per-step gather. ``precision="highest"`` keeps the selected colors
        (and so the diffused error) exact — one-hot rows are exactly
        representable, so the full-f32 product reconstructs f32 values.
      * the error-queue sum is pinned to ``precision="highest"`` too: it
        carries the diffused error into every step.

      Which formulation is fastest on the H100 is not measured.
    """
    dtype = xs.dtype
    chan_wv = jnp.asarray([R_WEIGHT, G_WEIGHT, B_WEIGHT], dtype)
    qwv = _queue_weights(dtype)
    pal_scaled = palette2020 * chan_wv[None, :]           # (K, 3)
    ps2 = jnp.sum(pal_scaled * pal_scaled, axis=1)        # (K,)
    ps2 = jnp.where(valid, ps2, jnp.inf)
    pal_t = palette2020.T                                  # (3, K)
    pa, pb, pc = pal_scaled[:, 0], pal_scaled[:, 1], pal_scaled[:, 2]
    iota_k = jnp.arange(palette2020.shape[0], dtype=jnp.int32)

    def step(queues, px):
        # queues: (3, QUEUE, lanes); px: (3, lanes)
        corrected = px + jnp.einsum(
            "q,cql->cl", qwv, queues, precision="highest"
        )
        q = corrected * chan_wv[:, None]
        d = ps2[:, None] - 2.0 * (
            pa[:, None] * q[0][None, :]
            + pb[:, None] * q[1][None, :]
            + pc[:, None] * q[2][None, :]
        )  # (K, lanes)
        idx = jnp.argmin(d, axis=0).astype(jnp.int32)
        oh = (iota_k[:, None] == idx[None, :]).astype(dtype)
        chosen = jnp.dot(pal_t, oh, precision="highest")   # (3, lanes)
        err = px - chosen
        queues = jnp.concatenate([queues[:, 1:], err[:, None, :]], axis=1)
        return queues, idx

    queues0 = jnp.zeros((3, QUEUE, lanes), dtype)
    # unroll=8: amortize per-step scan overhead (not measured on the H100)
    _, idx_stream = jax.lax.scan(
        step, queues0, xs, unroll=8
    )  # (seg, lanes)

    return jnp.zeros((n,), jnp.int32).at[perm2].set(
        idx_stream.reshape(-1), mode="drop"
    )


def riemersma_dither_planar(channels_working, palette_working, valid,
                            width, height, color_space, segment=4096):
    """Planar-channel variant of :func:`riemersma_dither`."""
    ch2020 = cs.working_to_linear_rec2020(
        tuple(channels_working), color_space
    )
    p2020 = cs.working_to_linear_rec2020(palette_working, color_space)
    return _dither_stream_planar(
        tuple(ch2020), p2020, valid, int(width), int(height), int(segment)
    )


@functools.partial(jax.jit, static_argnames=("width", "height", "segment",
                                             "color_space"))
def riemersma_dither_packed_u8(channels_u8, palette_working, valid,
                               width, height, color_space, segment=4096):
    """uint8-source dither with a SINGLE packed gather.

    The three (N,) f32 channel gathers into Hilbert order are a large
    share of the scan's non-step cost (see _step_major_perm). For uint8
    sources the channels pack losslessly
    into one (N,) uint32, so ONE gather reorders the image and the
    sRGB -> linear Rec2020 conversion runs on the already-permuted
    step-major arrays.

    Divergence note (documented with S3): pixels convert sRGB -> Rec2020
    DIRECTLY instead of through the working space (the reference converts
    its working-space copy, patolette.c:268-298). The transforms agree
    mathematically; only f32 rounding paths differ, below the dither
    quality gates.
    """
    n = width * height
    r, g, b = channels_u8
    codes = (
        (r.astype(jnp.uint32) << 16)
        | (g.astype(jnp.uint32) << 8)
        | b.astype(jnp.uint32)
    )

    seg = int(segment) if segment else n
    seg = max(1, min(seg, n))
    lanes = -(-n // seg)
    perm = hilbert.pixel_visit_order(width, height)
    perm2 = _step_major_perm(perm, seg, lanes, n)

    gathered = jnp.take(codes, perm2)
    s = jnp.float32(1.0 / 255.0)
    ch = tuple(
        ((gathered >> k) & jnp.uint32(0xFF)).astype(jnp.float32) * s
        for k in (16, 8, 0)
    )
    ch2020 = cs.srgb_to_linear_rec2020(ch)
    xs = jnp.stack(
        [c.reshape(seg, lanes) for c in ch2020], axis=1
    )  # (seg, 3, lanes)

    p2020 = cs.working_to_linear_rec2020(palette_working, color_space)
    return _dither_scan_core(xs, p2020, valid, perm2, n, lanes)
