"""Device-mesh scale-out for the quantization pipeline.

The reference is a single-process CPU library (SURVEY.md section 2.3); its
only parallelism is OpenMP loops inside vendored faiss. Here the pixel axis
``N`` — the structural "long axis" of this workload — is sharded over a 1-D
``pixels`` mesh (the cards of a host, and hosts), and:

  * all weighted moment tuples (11 floats per bucket/cluster) ride ``psum``
  * the 512-bucket GQ dynamic program and the greedy LQ/KMeans control run
    replicated on the all-reduced moments — only moments cross the wire
  * dithering runs per-shard on each shard's contiguous row strip with an
    error-queue reset at strip seams (BASELINE config 5: per-shard dither)

Everything is expressed with ``shard_map`` so the collective schedule is
explicit and testable on a virtual CPU mesh
(``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from patolette_tpu.models import pipeline as PIPE
from patolette_tpu.models import dither as DITH
from patolette_tpu.ops import colorspace as cs

AXIS = "pixels"


def make_mesh(devices=None):
    """1-D pixel mesh over the given (or all) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (AXIS,))


def shard_pixels(x, mesh):
    """Place a (N, ...) array row-sharded over the pixel axis."""
    return jax.device_put(x, NamedSharding(mesh, P(AXIS)))


def wire_channel(col: np.ndarray) -> np.ndarray:
    """Per-channel wire coercion: u8 stays raw bytes, everything else
    becomes contiguous f32. The ONE copy of the channel dtype policy —
    the single-process sharded path and the multi-host local feed both
    use it (r5 review: two hand-synchronized copies)."""
    if col.dtype != np.uint8:
        return np.ascontiguousarray(col, np.float32)
    return np.ascontiguousarray(col)


def put_planar_sharded(colors, mesh):
    """(N, 3) host image -> 3 x (N,) channel vectors sharded over ``AXIS``.

    The sharded analogue of :func:`ops.wire.put_planar_image`: uint8 images
    cross the wire as raw bytes per channel (~3N bytes total vs 12N for an
    interleaved f32 upload — VERDICT r2 weak #4) and stay u8 until the
    device normalizes them; the per-shard transfer granularity (N/shards
    bytes per RPC) replaces single-chip 16 MB chunking. Floats go as f32."""
    colors = np.asarray(colors)
    sh = NamedSharding(mesh, P(AXIS))
    return tuple(
        jax.device_put(wire_channel(colors[:, k]), sh) for k in range(3)
    )


def put_vector_sharded(w, mesh):
    """(N,) host float vector -> (N,) f32 sharded over ``AXIS``."""
    return jax.device_put(
        np.ascontiguousarray(np.asarray(w, np.float32)),
        NamedSharding(mesh, P(AXIS)),
    )


@functools.lru_cache(maxsize=8)
def _ones_program(n: int, mesh):
    return jax.jit(
        lambda: jnp.ones((n,), jnp.float32),
        out_shardings=NamedSharding(mesh, P(AXIS)),
    )


def ones_sharded(n: int, mesh):
    """(n,) f32 ones created directly on the mesh — no wire transfer."""
    return _ones_program(n, mesh)()


def _normalize_channels(r, g, b):
    if r.dtype == jnp.uint8:
        s = jnp.float32(1.0 / 255.0)
        return (r.astype(jnp.float32) * s, g.astype(jnp.float32) * s,
                b.astype(jnp.float32) * s)
    return r, g, b


def pad_to_shards(n: int, n_shards: int) -> int:
    return -(-n // n_shards) * n_shards


@functools.lru_cache(maxsize=8)
def quantize_palette_sharded(mesh, palette_size: int, color_space: int = 2,
                             kmeans_niter: int = 0,
                             kmeans_max_samples: int = 512**2,
                             seed: int = 1234, *, lq_max_samples: int = 0,
                             planar: bool = False, with_map: bool = True):
    """Build the jitted sharded palette pipeline for a mesh.

    Cached on the full (mesh, params) key: a fresh ``jax.jit`` object per
    call would defeat jit's function-identity cache and re-trace on every
    ``quantize(mesh=...)`` invocation (r5 review).

    Returns ``fn(colors, weights) -> (palette_working, valid, palette_map)``
    where ``colors`` is (N, 3) row-sharded (N divisible by the mesh size)
    and ``weights`` is (N,) row-sharded (use ones for unweighted — a None
    static branch would double the compile cache).

    ``planar=True``: ``colors`` is instead a 3-tuple of (N,) row-sharded
    channel vectors (raw uint8 or f32 — see :func:`put_planar_sharded`);
    no interleaved (N, 3) array ever exists on device.
    ``lq_max_samples``: global GQ/LQ sample cap, split over shards with
    shard-distinct draws. ``with_map=False`` skips the NN mapping (the
    caller dithers instead) and returns only ``(palette_working, valid)``.
    """

    def body(colors, weights):
        return PIPE.palette_pipeline_device(
            colors, weights, palette_size, color_space,
            kmeans_niter, kmeans_max_samples, seed, axis_name=AXIS,
            lq_max_samples=lq_max_samples, with_map=with_map,
        )

    colors_spec = (P(AXIS),) * 3 if planar else P(AXIS)
    out_specs = (P(), P(), P(AXIS)) if with_map else (P(), P())
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(colors_spec, P(AXIS)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=8)
def saliency_sharded(mesh, width: int, strip_h: int, tile_size: float,
                     total_pixels: int):
    """Per-shard MBD saliency over contiguous row strips (SURVEY 2.3 row 4).
    Cached on (mesh, params) — see quantize_palette_sharded.

    Each shard runs the full saliency pipeline (MBD wavefront scans +
    border/center priors) on its own ``strip_h x width`` strip — the
    sharded analogue of the reference's serial scans
    (/root/reference/src/patolette/patolette.pyx:54-156). Seam semantics
    (documented divergence): strip edges act as image borders — MBD seeds
    d=0 there and the border/center priors are strip-local. The final
    weight formula uses the FULL image area (``total_pixels``) so weights
    keep the reference's ``1 + sal^2 * (rows*cols)/tile^2`` scale
    (pyx:313).

    Returns ``fn(channels) -> (N,) f32 weights`` row-sharded; ``channels``
    is a 3-tuple of (N,) sRGB vectors (raw uint8 or f32).
    """
    from patolette_tpu.models import saliency as SAL

    assert strip_h > 3, "strip too thin for the MBD stencil"

    def body(channels):
        r, g, b = _normalize_channels(*channels)
        w = SAL.get_weights_planar(
            (r, g, b), strip_h, width, tile_size, total_pixels=total_pixels
        )
        return w.astype(jnp.float32)

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=((P(AXIS),) * 3,),
        out_specs=P(AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=8)
def dither_sharded(mesh, width: int, height: int, color_space: int,
                   segment: int = 4096, *, planar: bool = False):
    """Per-shard Riemersma dither over contiguous row strips.
    Cached on (mesh, params) — see quantize_palette_sharded.

    The image is split into ``n_shards`` horizontal strips (height must be
    divisible); each shard runs the full Hilbert dither on its strip with a
    fresh error queue — the documented per-shard dither semantics.

    ``planar=False``: ``fn(colors_working, palette_working, valid)`` with
    colors a row-sharded (N, 3) WORKING-space array. ``planar=True``:
    ``fn(channels, palette_working, valid)`` with channels a 3-tuple of
    row-sharded (N,) *sRGB* vectors (raw uint8 or f32) — the conversion to
    linear Rec2020 (riemersma.c:3-7) is fused into the per-strip program
    and the scan runs channel-planar (no (N, 3) intermediates).
    """
    n_shards = mesh.devices.size
    assert height % n_shards == 0, "height must divide over the mesh"
    strip_h = height // n_shards

    if planar:
        def body(channels, palette_working, valid):
            ch = _normalize_channels(*channels)
            c2020 = cs.srgb_to_linear_rec2020(ch)
            p2020 = cs.working_to_linear_rec2020(
                palette_working, color_space
            )
            return DITH._dither_stream_planar(
                tuple(c2020), p2020, valid, width, strip_h, segment
            )

        in_specs = ((P(AXIS),) * 3, P(), P())
    else:
        def body(colors_working, palette_working, valid):
            c2020 = cs.working_to_linear_rec2020(
                colors_working, color_space
            )
            p2020 = cs.working_to_linear_rec2020(
                palette_working, color_space
            )
            return DITH._dither_stream(
                c2020, p2020, valid, width, strip_h, segment
            )

        in_specs = (P(AXIS), P(), P())

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)
