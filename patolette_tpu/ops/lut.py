"""24-bit palette-map LUT: device build + host-side fused gather.

For uint8 images the palette map is a pure function of the pixel *value*:
the reference's exact NN mapping (/root/reference/lib/src/palette/
nearest.c:150-209, ICtCp per /root/reference/lib/src/patolette.c:140) sends
two equal pixels to the same palette entry, and a uint8 sRGB pixel has only
2^24 possible values. So instead of shipping N pixels to the device and N
indices back (4 bytes/pixel — 400 MB at 100 MP),
the device enumerates all 16.7M codes with an on-device iota (nothing is
uploaded), maps each to its nearest palette entry, and ships ONE table
back; the host then resolves every pixel with a fused 24-bit pack + gather
(native C++ in ``patolette_tpu/native``, numpy fallback).

Two further transfer/compute optimizations:

  * **Grid cache** — the ICtCp coordinates of all 2^24 uint8 sRGB codes
    are palette-independent, so they are computed once per working space
    and kept resident on device (201 MB; one space at a time). Warm
    calls only pay the (2^24, P) distance argmin.
  * **RLE pull** — the LUT is a Voronoi partition of the 256^3 grid, so
    along the minor (b) axis it is long constant runs. For uint8 tables
    the device run-length-encodes it (boundary mask -> nonzero -> packed
    ``pos << 8 | value`` int32 words) and the host pulls ~4 bytes/run
    (a few MB) instead of 16.7 MB. Falls back to the full pull when the
    table has more than ``MAX_RUNS`` runs or a non-u8 dtype. Whether the
    encode pays for itself over PCIe is not measured on the H100.

The table uses the same distance formula and lowest-index tie-breaking as
:mod:`patolette_tpu.ops.assign`, so it equals mapping each pixel directly
except at near-ties: the grid's f32 ICtCp coordinates come from a
different compiled program than the direct map's and may differ in the
last bits (chip_smoke.py checks that every disagreement is such a tie).
The transfer cost becomes independent of the image size.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from patolette_tpu.ops import colorspace as cs
from patolette_tpu.ops import wire

LUT_SIZE = 1 << 24
_CHUNK = 1 << 17  # 128 scan steps; (chunk, 256) f32 transient = 134 MB

# RLE wire format v1: uint32[0] = run count, uint32[1:] = (pos << 8 | value).
# MAX_RUNS bounds the device buffer (8 MB); a 256-entry palette LUT measures
# ~300-700k runs on natural/synthetic images, so the bound is generous.
MAX_RUNS = (1 << 21) - 1
# First pull window: 2 MB covers ~520k runs (a 256-color LUT on a 100 MP
# synthetic image has ~520-540k) in ONE round trip; extra windows only
# happen for unusually fragmented tables.
_RLE_STEP = 1 << 19

# RLE v2 (delta-u16) parameters — see _rle_encode_u8_v2:
# forced boundary every FORCE_STEP positions bounds deltas to <= FORCE_STEP
# (fits the 8-bit delta field), and caps per-block boundary counts so the
# two-stage compaction can truncate each block at V2_COLS candidates.
_V2_FORCE = 128
_V2_COLS = 32          # block overflow threshold (measured max 11 at 256p)
_V2_ROWS = LUT_SIZE // _V2_FORCE
# First pull window: 1.5 MB of u16 words = 786k runs. Typical 256-color
# tables carry 520-700k real runs + ~110k net forced boundaries, so one
# window almost always suffices; fragmented tables pay one extra round
# trip.
_V2_STEP = 3 << 18


def lut_dtype(palette_size: int):
    """Narrowest wire dtype that can hold a palette index."""
    if palette_size <= 256:
        return jnp.uint8
    if palette_size <= 65536:
        return jnp.uint16
    return jnp.int32


# --------------------------------------------------------------------------
# Palette-independent grid cache
# --------------------------------------------------------------------------

_GRID_CACHE: dict = {}  # color_space -> 3x (n_chunks, _CHUNK) f32 on device


def _codes_to_ictcp(codes, color_space: int):
    """uint8-sRGB code chunk -> ICtCp channel tuple, staged exactly like
    the direct mapping path (sRGB -> working -> ICtCp, so CIELuv
    round-trip rounding matches :func:`pipeline._nn_map_stage_planar` bit
    for bit). The ONE copy of this staging — the single-device and
    sharded grid builders both call it, which is what makes the mesh LUT
    route byte-identical to the single-device table."""
    inv = jnp.float32(1.0 / 255.0)
    r = ((codes >> 16) & 0xFF).astype(jnp.float32) * inv
    g = ((codes >> 8) & 0xFF).astype(jnp.float32) * inv
    b = (codes & 0xFF).astype(jnp.float32) * inv
    xw = cs.srgb_to_working((r, g, b), color_space)
    return cs.working_to_ictcp(xw, color_space)


@functools.partial(jax.jit, static_argnames=("color_space",))
def _grid_build(color_space: int):
    """ICtCp coordinates of every uint8 sRGB code."""

    def body(_, start):
        codes = start + jax.lax.iota(jnp.int32, _CHUNK)
        return None, _codes_to_ictcp(codes, color_space)

    starts = jnp.arange(0, LUT_SIZE, _CHUNK, dtype=jnp.int32)
    _, grid = jax.lax.scan(body, None, starts)
    return grid


def grid_ictcp(color_space: int):
    """Cached ICtCp grid for ``color_space`` (one grid resident at a time
    ACROSS both the single-device and mesh caches — each is 201 MB of
    HBM, so building either evicts both)."""
    g = _GRID_CACHE.get(color_space)
    if g is None:
        clear_grid_cache()
        g = _grid_build(color_space)
        _GRID_CACHE[color_space] = g
    return g


def clear_grid_cache():
    _GRID_CACHE.clear()
    _GRID_MESH_CACHE.clear()


# --------------------------------------------------------------------------
# LUT build (distance argmin over the cached grid)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("color_space",))
def _palette_ictcp(palette_working, valid, color_space: int):
    pi = cs.working_to_ictcp(palette_working, color_space)
    c2 = jnp.sum(pi * pi, axis=-1)
    c2 = jnp.where(valid, c2, jnp.inf)
    return pi, c2


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def _argmin_lut(grid, pi, c2, out_dtype):
    # (P, chunk) orientation: the argmin reduces over the leading palette
    # axis and the chunk axis stays contiguous (bit-identical to the
    # (chunk, P) form: same products, same add order, same first-index
    # tie-break; which is faster on the H100 is not measured).
    pa, pb, pc = pi[:, 0], pi[:, 1], pi[:, 2]

    def body(_, xs):
        xa, xb, xc = xs
        d = c2[:, None] - 2.0 * (
            pa[:, None] * xa[None, :]
            + pb[:, None] * xb[None, :]
            + pc[:, None] * xc[None, :]
        )
        return None, jnp.argmin(d, axis=0).astype(out_dtype)

    _, lut = jax.lax.scan(body, None, grid)
    return lut.reshape(-1)


def build_lut_device(palette_working, valid, color_space: int,
                     out_dtype=jnp.uint8):
    """(2^24,) nearest-palette-index table over all uint8 sRGB colors.

    ``palette_working``: (P, 3) palette in the working color space;
    ``valid``: (P,) bool live-slot mask (invalid slots never win). Mapping
    happens in ICtCp regardless of working space (quirk Q4 semantics,
    patolette.c:140), exactly like :func:`pipeline._nn_map_stage_planar`.

    The grid half of the distance is served from the per-space device
    cache; only the (2^24, P) argmin runs per call.
    """
    grid = grid_ictcp(int(color_space))
    pi, c2 = _palette_ictcp(palette_working, valid, int(color_space))
    return _argmin_lut(grid, pi, c2, out_dtype)


# --------------------------------------------------------------------------
# Device -> host pull (RLE wire format for uint8 tables)
# --------------------------------------------------------------------------

@jax.jit
def _rle_encode_u8(lut):
    # Compaction via an unstable sort of (boundary ? position : 0xFFFFFFFF)
    # instead of jnp.nonzero's cumsum+scatter lowering (sort vs nonzero
    # not measured on the H100).
    x = lut.astype(jnp.uint32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), x[1:] != x[:-1]]
    )
    count = jnp.sum(boundary.astype(jnp.uint32))
    iota = jax.lax.iota(jnp.uint32, LUT_SIZE)
    key = jnp.where(boundary, iota, jnp.uint32(0xFFFFFFFF))
    pos = jax.lax.sort(key, is_stable=False)[:MAX_RUNS]
    # pos < 2^24 for real runs, so << 8 fills 32 bits exactly; the sentinel
    # tail past `count` is garbage the host never reads.
    packed = (pos << 8) | x[jnp.minimum(pos, jnp.uint32(LUT_SIZE - 1))]
    return jnp.concatenate([count[None], packed])


@jax.jit
def _rle_encode_u8_v2(lut):
    """Delta-u16 RLE: half the wire bytes of v1 and ~4x less encode time.

    Works on any table length divisible by ``_V2_FORCE`` — the sharded
    mesh build encodes per-shard LUT slices with the same program
    (positions are slice-relative; the host decoder rebases).

    Wire format (u16 words): [count_lo, count_hi, overflow, w_0..w_{n-1}]
    with w_i = (delta_i << 8) | value_i and pos_i = pos_{i-1} + delta_i
    (pos_0 = 0). A boundary is FORCED at every _V2_FORCE-th position, so
    every delta fits 8 bits and every _V2_FORCE-block starts a run (forced
    splits decode identically — the value just repeats).

    Encode avoids v1's global 2^24-key sort with a
    two-stage compaction: (1) pack (col << 8 | value) u16 keys per
    _V2_FORCE-block and sort each block row (short bitonic passes);
    (2) globally sort only the surviving (rows, _V2_COLS) candidate keys
    re-based to (pos << 8 | value) u32 — position rides the high bits, so
    ascending key order IS ascending run order and the value needs no
    gather. Blocks with more than _V2_COLS boundaries (never observed —
    measured max 11 on a 256-color LUT) set the overflow flag and the
    caller falls back to v1/raw.
    """
    rows = lut.shape[0] // _V2_FORCE
    x = lut.astype(jnp.uint16)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), lut[1:] != lut[:-1]]
    )
    colv = jax.lax.broadcasted_iota(jnp.uint16, (rows, _V2_FORCE), 1)
    bcols = boundary.reshape(rows, _V2_FORCE)
    bcols = bcols | (colv == 0)  # forced block-start boundaries
    count = jnp.sum(bcols, dtype=jnp.uint32)
    c_row = jnp.sum(bcols, axis=1, dtype=jnp.int32)
    overflow = jnp.any(c_row > _V2_COLS) | (count > jnp.uint32(MAX_RUNS))
    rowkeys = jnp.where(
        bcols, (colv << 8) | x.reshape(rows, _V2_FORCE),
        jnp.uint16(0xFFFF),
    )
    rowkeys = jax.lax.sort(rowkeys, dimension=1, is_stable=False)
    rowkeys = rowkeys[:, :_V2_COLS]

    col = (rowkeys >> 8).astype(jnp.uint32)
    base = (jax.lax.iota(jnp.uint32, rows) * _V2_FORCE)[:, None]
    keys = jnp.where(
        col < _V2_FORCE,
        ((base + col) << 8) | (rowkeys & jnp.uint16(0xFF)).astype(jnp.uint32),
        jnp.uint32(0xFFFFFFFF),
    ).reshape(-1)
    keys = jax.lax.sort(keys, is_stable=False)

    pos = keys >> 8
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), pos[:-1]])
    words = (((pos - prev) << 8) | (keys & jnp.uint32(0xFF))).astype(
        jnp.uint16
    )  # garbage past `count` (sentinel tail) is never read by the host
    header = jnp.stack([
        (count & jnp.uint32(0xFFFF)).astype(jnp.uint16),
        (count >> 16).astype(jnp.uint16),
        overflow.astype(jnp.uint16),
    ])
    return jnp.concatenate([header, words])


@jax.jit
def _rle_encode_u16_v2(lut):
    """RLE v2 for uint16 tables (256 < palette <= 65536): u32 words
    ``(delta << 16) | value`` with the same forced-boundary / two-stage
    compaction scheme as :func:`_rle_encode_u8_v2`. The global stage
    sorts a u32 position key with the u16 value riding as a payload
    operand (``lax.sort`` num_keys=1) — no u64 keys, so it runs without
    x64. Header: u32 [count, overflow]. ~4 B/run vs the 33.5 MB raw
    table pull (VERDICT r4 next #6 — the large-palette regime paid the
    raw wire).
    """
    rows = lut.shape[0] // _V2_FORCE
    x32 = lut.astype(jnp.uint32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), lut[1:] != lut[:-1]]
    )
    colv = jax.lax.broadcasted_iota(jnp.uint32, (rows, _V2_FORCE), 1)
    bcols = boundary.reshape(rows, _V2_FORCE) | (colv == 0)
    count = jnp.sum(bcols, dtype=jnp.uint32)
    c_row = jnp.sum(bcols, axis=1, dtype=jnp.int32)
    overflow = jnp.any(c_row > _V2_COLS) | (count > jnp.uint32(MAX_RUNS))

    rowkeys = jnp.where(
        bcols, (colv << 16) | x32.reshape(rows, _V2_FORCE),
        jnp.uint32(0xFFFFFFFF),
    )
    rowkeys = jax.lax.sort(rowkeys, dimension=1, is_stable=False)
    rowkeys = rowkeys[:, :_V2_COLS]

    col = rowkeys >> 16
    base = (jax.lax.iota(jnp.uint32, rows) * _V2_FORCE)[:, None]
    pos = jnp.where(
        col < _V2_FORCE, base + col, jnp.uint32(0xFFFFFFFF)
    ).reshape(-1)
    vals = (rowkeys & jnp.uint32(0xFFFF)).reshape(-1)
    pos, vals = jax.lax.sort((pos, vals), dimension=0, num_keys=1)

    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), pos[:-1]])
    words = ((pos - prev) << 16) | vals
    header = jnp.stack([count, overflow.astype(jnp.uint32)])
    return jnp.concatenate([header, words])


def pull_words_u16_v2(enc) -> np.ndarray | None:
    """Pull the u32 run words of a `_rle_encode_u16_v2` buffer; None on
    overflow."""
    step = min(_V2_STEP, enc.shape[0])
    first = np.asarray(wire._slice_1d(enc, 0, step))
    count = int(first[0])
    if first[1] or count > MAX_RUNS:
        return None
    return _pull_windowed(enc, 0, 2, count, step, first)


def _rle_decode_u16_v2(words: np.ndarray,
                       table_size: int = LUT_SIZE) -> np.ndarray:
    """u32 v2 words -> (table_size,) u16 table."""
    from patolette_tpu import native

    dec = native.rle_decode_u16_v2(words, table_size)
    if dec is not None:
        return dec[:table_size]
    pos = np.cumsum((words >> 16).astype(np.int64))
    pos -= pos[0]
    vals = (words & 0xFFFF).astype(np.uint16)
    lengths = np.diff(np.append(pos, table_size))
    return np.repeat(vals, lengths)


def _rle_decode_v2(words: np.ndarray,
                   table_size: int = LUT_SIZE) -> np.ndarray:
    """v2 words -> (table_size,) u8 table (native memset or numpy repeat)."""
    from patolette_tpu import native

    dec = native.rle_decode_u8_v2(words, table_size)
    if dec is not None:
        return dec[:table_size]
    pos = np.cumsum((words >> 8).astype(np.int64))
    pos -= pos[0]  # delta_0 is 0 by construction; keep exact anyway
    vals = (words & 0xFF).astype(np.uint8)
    lengths = np.diff(np.append(pos, table_size))
    return np.repeat(vals, lengths)


def pull_words_v2(enc, base: int = 0) -> np.ndarray | None:
    """Pull the run words of a `_rle_encode_u8_v2` buffer located at word
    offset ``base`` inside ``enc`` (0 for a single-device buffer; shard
    offsets for the stacked sharded build). None on overflow."""
    total = enc.shape[0]
    step = min(_V2_STEP, total)
    first = np.asarray(wire._slice_1d(enc, min(base, total - step), step))
    off = base - min(base, total - step)
    count = int(first[off]) | (int(first[off + 1]) << 16)
    if first[off + 2] or count > MAX_RUNS:
        return None
    return _pull_windowed(enc, base, 3, count, step, first)


def pull_encoded_v2(enc) -> np.ndarray | None:
    """Pull + decode a `_rle_encode_u8_v2` buffer; None on overflow (caller
    falls back to the v1 encode or a raw table pull)."""
    words = pull_words_v2(enc)
    if words is None:
        return None
    return _rle_decode_v2(words)


def _rle_decode(packed: np.ndarray) -> np.ndarray:
    """Packed runs -> (2^24,) table. Native memset-per-run when available
    (returns a view into a tail-padded buffer, which lut_map_host detects
    to skip its defensive pad copy); numpy repeat otherwise."""
    from patolette_tpu import native

    dec = native.rle_decode_u8(packed)
    if dec is not None:
        return dec[:LUT_SIZE]
    pos = (packed >> 8).astype(np.int64)
    vals = (packed & 0xFF).astype(np.uint8)
    lengths = np.diff(np.append(pos, LUT_SIZE))
    return np.repeat(vals, lengths)


def pull_lut(lut_dev, try_v2: bool = True) -> np.ndarray:
    """Device LUT -> host numpy array, via the RLE wire format when the
    table is uint8 (palette <= 256) and compresses under the caps.

    Tries the v2 delta-u16 encode first (half the bytes, ~4x cheaper
    encode), then the v1 u32 encode (no per-block cap), then the raw
    16.7 MB pull. uint16 tables (256 < palette <= 65536) ride the u32
    v2 format with a raw 33.5 MB fallback. ``try_v2=False`` skips the v2
    attempt — callers that already pulled an overflowed v2 header would
    otherwise re-dispatch the identical encode just to hit the same
    flag."""
    if lut_dev.dtype == jnp.uint16:
        if try_v2:
            words = pull_words_u16_v2(_rle_encode_u16_v2(lut_dev))
            if words is not None:
                return _rle_decode_u16_v2(words)
        return np.asarray(lut_dev)
    if lut_dev.dtype != jnp.uint8:
        return np.asarray(lut_dev)
    if try_v2:
        out = pull_encoded_v2(_rle_encode_u8_v2(lut_dev))
        if out is not None:
            return out
    out = pull_encoded(_rle_encode_u8(lut_dev))
    if out is None:  # > MAX_RUNS: fall back to the raw 16.7 MB pull
        return np.asarray(lut_dev)
    return out


def _pull_windowed(enc, base: int, hdr: int, count: int, step: int,
                   first: np.ndarray) -> np.ndarray:
    """Collect ``count`` run words starting at word ``base + hdr`` of the
    device buffer ``enc``, given the already-pulled first window ``first``
    (fetched at ``min(base, total - step)``). Full-step windows clamped to
    the buffer end, with the overlap trimmed off the front so chunks stay
    contiguous — the ONE copy of the off-by-one-prone arithmetic all three
    RLE wire formats share."""
    total = enc.shape[0]
    off = base - min(base, total - step)
    head = first[off + hdr:]
    if count <= len(head):
        return head[:count]
    parts = [head]
    got = len(head)
    while got < count:
        w_start = min(base + hdr + got, total - step)
        win = np.asarray(wire._slice_1d(enc, w_start, step))
        w_off = base + hdr + got - w_start
        take = min(step - w_off, count - got)
        parts.append(win[w_off:w_off + take])
        got += take
    return np.concatenate(parts)


def pull_encoded(enc) -> np.ndarray | None:
    """Pull + decode a device ``_rle_encode_u8`` buffer; None when the run
    count overflowed MAX_RUNS (caller falls back to a raw table pull)."""
    step = min(_RLE_STEP, enc.shape[0])
    first = np.asarray(wire._slice_1d(enc, 0, step))
    count = int(first[0])
    if count > MAX_RUNS:
        return None
    return _rle_decode(_pull_windowed(enc, 0, 1, count, step, first))


# --------------------------------------------------------------------------
# Sharded LUT build (mesh path): argmin + RLE per grid slice
# --------------------------------------------------------------------------

_GRID_MESH_CACHE: dict = {}  # (color_space, mesh) -> sharded grid tuple


def grid_ictcp_sharded(color_space: int, mesh):
    """Sharded ICtCp grid: each shard holds its contiguous slice of the
    2^24 uint8 sRGB codes (same per-space single-entry caching as
    :func:`grid_ictcp`; 201 MB total split over the mesh)."""
    from jax.sharding import PartitionSpec as P
    from patolette_tpu.parallel.mesh import AXIS

    key = (int(color_space), mesh)
    g = _GRID_MESH_CACHE.get(key)
    if g is not None:
        return g
    n_shards = mesh.devices.size
    per = LUT_SIZE // n_shards
    chunk = min(_CHUNK, per)

    def body():
        shard = jax.lax.axis_index(AXIS).astype(jnp.int32)

        def b(_, start):
            codes = start + jax.lax.iota(jnp.int32, chunk)
            return None, _codes_to_ictcp(codes, int(color_space))

        starts = shard * per + jnp.arange(0, per, chunk, dtype=jnp.int32)
        _, grid = jax.lax.scan(b, None, starts)
        return grid

    mapped = jax.shard_map(
        body, mesh=mesh, in_specs=(), out_specs=(P(AXIS),) * 3,
        check_vma=False,
    )
    clear_grid_cache()  # one ~201 MB grid resident at a time, either kind
    g = jax.jit(mapped)()
    _GRID_MESH_CACHE[key] = g
    return g


def build_lut_enc_sharded(mesh, palette_working, valid, color_space: int):
    """Sharded 24-bit LUT build: per-shard distance argmin over the grid
    slice + per-shard RLE v2 encode (VERDICT r4 next #4 — the mesh path
    previously shipped the full sharded palette map over the wire; this
    pulls ~2 B/run instead).

    Returns ``(enc, lut)``: ``enc`` a (n_shards * buf,) u16 array, shard
    s's v2 buffer at word offset s*buf with slice-relative positions;
    ``lut`` the (2^24,) u8 table row-sharded (only pulled on overflow).
    """
    from jax.sharding import PartitionSpec as P
    from patolette_tpu.parallel.mesh import AXIS

    grid = grid_ictcp_sharded(color_space, mesh)

    def body(ga, gb, gc, pw, v):
        pi, c2 = _palette_ictcp(pw, v, int(color_space))
        lut_slice = _argmin_lut((ga, gb, gc), pi, c2, jnp.uint8)
        return _rle_encode_u8_v2(lut_slice), lut_slice

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(mapped)(*grid, palette_working, valid)


def pull_lut_sharded(enc, lut_sharded, n_shards: int) -> np.ndarray:
    """Assemble the full padded host table from per-shard v2 buffers.

    Per-shard overflow (pathological fragmentation) falls back to a raw
    pull of just that shard's table slice. Returns a
    (2^24 + LUT_PAD,) u8 array directly usable by :func:`lut_map_host`.
    """
    from patolette_tpu import native

    per = LUT_SIZE // n_shards
    buf = enc.shape[0] // n_shards
    table = np.zeros(LUT_SIZE + native.LUT_PAD, np.uint8)
    for s in range(n_shards):
        words = pull_words_v2(enc, base=s * buf)
        if words is None:  # overflow: raw slice pull
            table[s * per:(s + 1) * per] = np.asarray(
                wire._slice_1d(lut_sharded, s * per, per)
            )
        else:
            table[s * per:(s + 1) * per] = _rle_decode_v2(words, per)
    return table


class CodesPrefetch:
    """Background 24-bit pack of the image while the device builds the LUT.

    The host map splits into pack (image-only) + gather (needs the table);
    the pack half runs here on a daemon thread concurrent with the device
    palette+LUT work and the RLE wire pull (both of which idle the host in
    GIL-released RPC waits), so only the gather stays on the critical path
    (VERDICT r4 next #1: the serial pack sat on the 100 MP critical path).

    No-op (``take() -> None``) when the native library is missing, the
    image is small enough that the split costs more than it saves, or the
    codes array would be unreasonably large (> 1 GB host RAM).
    """

    MIN_PIXELS = 1 << 22
    MAX_PIXELS = 1 << 28  # 4 B/px of codes; 1 GB cap

    def __init__(self, colors_u8: np.ndarray):
        from patolette_tpu import native

        self._thread = None
        self._codes = None
        n = len(colors_u8)
        if (
            colors_u8.dtype == np.uint8
            and self.MIN_PIXELS <= n <= self.MAX_PIXELS
            and native.available()
        ):
            import threading

            def work():
                self._codes = native.pack_codes(colors_u8)

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def take(self) -> np.ndarray | None:
        """Wait for and return the packed codes (None when not running)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self._codes


def lut_map_host(colors_u8: np.ndarray, lut: np.ndarray,
                 codes: np.ndarray | None = None) -> np.ndarray:
    """Resolve (N, 3) uint8 pixels through the 24-bit LUT on the host.

    Uses the threaded native pack+gather when available; otherwise numpy.
    Returns int32 on BOTH paths (the public palette-map dtype; the native
    path fuses the widen into the gather, the numpy path widens explicitly).
    ``codes``: optional precomputed 24-bit codes (from
    :class:`CodesPrefetch`) — skips the pack half.
    """
    from patolette_tpu import native

    base = getattr(lut, "base", None)
    if (
        base is not None
        and lut.shape[0] == LUT_SIZE
        and base.shape == (LUT_SIZE + native.LUT_PAD,)
        and base.dtype == lut.dtype
        and lut.ctypes.data == base.ctypes.data
    ):
        lut = base  # already tail-padded by the native RLE decode
    if codes is not None:
        out = native.lut_map_codes(codes, lut)
        if out is None:  # native vanished since the pack: numpy gather
            out = lut[:LUT_SIZE][codes].astype(np.int32, copy=False)
        return out
    out = native.lut_map_u8(colors_u8, lut)
    if out is not None:
        return out
    codes = (
        (colors_u8[:, 0].astype(np.int32) << 16)
        | (colors_u8[:, 1].astype(np.int32) << 8)
        | colors_u8[:, 2].astype(np.int32)
    )
    return lut[codes].astype(np.int32, copy=False)
