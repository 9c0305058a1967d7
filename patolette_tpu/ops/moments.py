"""Weighted moment accumulation, axis projection and bucket sorting.

This module is the accelerator reformulation of the reference's statistics
machinery:

  * ``SORT_axis_sort`` (/root/reference/lib/src/quantize/sort.c:12-93) —
    projection becomes a ``(N,3) @ (3,)`` matmul, binning a fused clip/floor.
  * ``CELLS_preprocess`` (/root/reference/lib/src/quantize/cells.c:53-139) —
    per-bucket moment accumulation becomes a one-hot segment matmul:
    ``onehot(buckets).T @ features`` with features
    ``[w, w*x, w*|x|^2, w*x x^T]``.
  * ``PCA_perform_PCA`` inputs (/root/reference/lib/src/math/pca.c:62-101) —
    weighted covariance from the same moment tuple.

Numerics: all bulk accumulation is f32, but colors are SHIFTED by a provided
center before squaring. Distortions and covariances are translation
invariant, so shifting by the (global or per-cluster) mean removes the
catastrophic cancellation in ``w2 - |w1|^2/w0`` that the f64 reference never
has to worry about (SURVEY.md H3).

Moment vector layout (length 11):
  [0]    w0   = sum w
  [1:4]  w1   = sum w * x
  [4]    w2   = sum w * |x|^2
  [5:11] wrs  = sum w * (xx, xy, xz, yy, yz, zz)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NUM_MOMENTS = 11
IDX_W0 = 0
IDX_W1 = slice(1, 4)
IDX_W2 = 4
IDX_WRS = slice(5, 11)

_DEFAULT_CHUNK = 32768

# The segment sums are plain XLA (one-hot matmul under a scan). A
# hand-written segment kernel lost to this formulation on the accelerator
# this was first built for and was removed (see git history); whether one
# pays on the H100 is not measured.


def moment_features(colors, weights=None, shift=None):
    """Per-pixel moment features ``(N, 11)``.

    ``colors``: (N, 3). ``weights``: (N,) or None (=> 1, matching the
    reference's NULL-weights convention). ``shift``: (3,) subtracted from
    colors before accumulation (translation-invariant statistics only).
    """
    x = colors
    if shift is not None:
        x = x - shift
    n = x.shape[0]
    one = jnp.ones((n,), dtype=x.dtype) if weights is None else weights
    w = one[:, None]
    wx = w * x
    w2 = jnp.sum(wx * x, axis=-1, keepdims=True)
    xx = wx[:, 0:1] * x[:, 0:3]          # (w*x0*x0, w*x0*x1, w*x0*x2)
    yy = wx[:, 1:2] * x[:, 1:3]          # (w*x1*x1, w*x1*x2)
    zz = wx[:, 2:3] * x[:, 2:3]          # (w*x2*x2,)
    return jnp.concatenate([one[:, None], wx, w2, xx, yy, zz], axis=-1)


def total_moments(colors, weights=None, shift=None, axis_name=None):
    """Single global moment tuple ``(11,)`` — one reduction pass.

    ``axis_name``: inside ``shard_map`` over a pixel-sharded mesh axis, the
    per-shard partial sum is ``psum``-reduced over that axis (SURVEY.md
    section 2.3: collective moment reduction).
    """
    s = jnp.sum(moment_features(colors, weights, shift), axis=0)
    if axis_name is not None:
        s = jax.lax.psum(s, axis_name)
    return s


def segment_moments(
    colors,
    segment_ids,
    num_segments,
    weights=None,
    shift=None,
    chunk=_DEFAULT_CHUNK,
    axis_name=None,
    fast=False,
):
    """Per-segment moment tuple ``(num_segments, 11)``.

    Implemented as a chunked one-hot matmul rather than scatter-add (a
    deterministic summation order; scatter-add vs matmul not measured on
    the H100). Each chunk contributes
    ``onehot(ids).T @ feats``; chunks are scanned with an f32 accumulator so
    the transient one-hot never exceeds ``chunk * num_segments`` elements.
    """
    feats = moment_features(colors, weights, shift)
    return segment_matmul(
        feats, segment_ids, num_segments, chunk=chunk, axis_name=axis_name,
        fast=fast,
    )


def segment_matmul(feats, segment_ids, num_segments, chunk=_DEFAULT_CHUNK,
                   axis_name=None, fast=False):
    """``(N, F)`` features summed into ``(num_segments, F)`` by id.

    Zero-pads to a chunk multiple (padding rows carry zero features, so the
    segment they land in is irrelevant). With ``axis_name`` (inside
    shard_map) the per-shard (S, F) partials ride a ``psum``.

    ``fast=True`` runs the one-hot matmul in bf16 with f32 accumulation
    (bf16 operands by design, so the result does not depend on the
    device's default f32 matmul precision). One-hot
    entries are exact in bf16; the ~0.4% relative feature rounding is fine
    for mean-shifted statistics that only drive split decisions (the LQ hot
    loop) but NOT for the GQ moment cache, which keeps full precision.
    """
    if axis_name is not None:
        local = segment_matmul(feats, segment_ids, num_segments, chunk=chunk,
                               fast=fast)
        return jax.lax.psum(local, axis_name)

    n, f = feats.shape
    out_dtype = feats.dtype
    mm_dtype = jnp.bfloat16 if fast else feats.dtype
    mm_precision = "default" if fast else "highest"

    if n <= chunk:
        onehot = jax.nn.one_hot(segment_ids, num_segments, dtype=mm_dtype)
        return jnp.einsum(
            "ns,nf->sf",
            onehot,
            feats.astype(mm_dtype),
            preferred_element_type=jnp.float32,
            precision=mm_precision,
        ).astype(out_dtype)

    pad = (-n) % chunk
    if pad:
        feats = jnp.concatenate(
            [feats, jnp.zeros((pad, f), dtype=feats.dtype)], axis=0
        )
        segment_ids = jnp.concatenate(
            [segment_ids, jnp.zeros((pad,), dtype=segment_ids.dtype)], axis=0
        )
    c = feats.shape[0] // chunk
    feats = feats.reshape(c, chunk, f)
    segment_ids = segment_ids.reshape(c, chunk)

    def body(acc, xs):
        fch, ich = xs
        onehot = jax.nn.one_hot(ich, num_segments, dtype=mm_dtype)
        contrib = jnp.einsum(
            "ns,nf->sf",
            onehot,
            fch.astype(mm_dtype),
            preferred_element_type=jnp.float32,
            precision=mm_precision,
        )
        return acc + contrib, None

    acc0 = jnp.zeros((num_segments, f), dtype=jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, (feats, segment_ids))
    return acc.astype(out_dtype)


# --------------------------------------------------------------------------
# Moment tuple queries
# --------------------------------------------------------------------------

def moments_center(m, delta=1e-30):
    """Weighted center from a moment tuple (shape (..., 11)) -> (..., 3).

    Centers are relative to whatever ``shift`` the moments were built with.
    """
    w0 = m[..., IDX_W0:IDX_W0 + 1]
    safe = w0 > delta
    return jnp.where(safe, m[..., IDX_W1] / jnp.where(safe, w0, 1.0), 0.0)


def moments_distortion(m, delta=1e-30):
    """Weighted SSE around the weighted mean: ``w2 - |w1|^2 / w0``.

    Matches ``ColorCluster_get_distortion`` (reference cluster.c:111-152) and
    ``CELLS_get_cell_distortion`` (cells.c:141-182). Shift-invariant.
    """
    w0 = m[..., IDX_W0]
    safe = w0 > delta
    w1sq = jnp.sum(m[..., IDX_W1] ** 2, axis=-1)
    d = m[..., IDX_W2] - w1sq / jnp.where(safe, w0, 1.0)
    return jnp.where(safe, jnp.maximum(d, 0.0), 0.0)


def moments_cov(m, delta=1e-30):
    """Weighted covariance matrix from a moment tuple -> (..., 3, 3).

    ``wrs/w0 - mu mu^T`` (reference cells.c:184-223, pca.c:62-101).
    Shift-invariant. Returns zeros for empty segments.
    """
    w0 = m[..., IDX_W0]
    safe = w0 > delta
    w0s = jnp.where(safe, w0, 1.0)
    mu = m[..., IDX_W1] / w0s[..., None]
    wrs = m[..., IDX_WRS] / w0s[..., None]
    xx, xy, xz, yy, yz, zz = (wrs[..., i] for i in range(6))
    second = jnp.stack(
        [
            jnp.stack([xx, xy, xz], axis=-1),
            jnp.stack([xy, yy, yz], axis=-1),
            jnp.stack([xz, yz, zz], axis=-1),
        ],
        axis=-2,
    )
    cov = second - mu[..., :, None] * mu[..., None, :]
    return jnp.where(safe[..., None, None], cov, 0.0)


# --------------------------------------------------------------------------
# Axis projection + bucket sort
# --------------------------------------------------------------------------

def project(colors, axis):
    """Project colors onto an axis: ``(N,3) @ (3,) -> (N,)``
    (reference sort.c:43-56 uses cblas_dgemv). Full f32 precision — bucket
    boundaries are sensitive to projection error."""
    return jnp.dot(colors, axis, precision="highest")


def bucketize_linear(proj, n_buckets, pmin, pmax):
    """Pure linear binning, no degenerate fallback (see :func:`bucketize`).

    Used in the LQ hot loop: a degenerate cluster (flat projection) bins
    everything into bucket 0, which yields a zero split benefit, so the
    greedy splitter never selects it — the reference's round-robin fallback
    (sort.c:61-79) is only reachable through paths where it cannot change
    the result. Avoids an O(N) prefix scan per candidate.
    """
    span = pmax - pmin
    scale = jnp.where(span > 0.0, 1.0 / jnp.where(span > 0.0, span, 1.0), 0.0)
    ratio = (proj - pmin) * scale
    return jnp.clip((ratio * n_buckets).astype(jnp.int32), 0, n_buckets - 1)


def bucketize(proj, n_buckets, pmin, pmax, delta=1e-12, mask=None,
              axis_name=None):
    """Linear binning of projections into ``n_buckets``
    (reference sort.c:58-92).

    Degenerate case (flat projection range): the reference round-robins
    buckets ``i % n_buckets`` over the input order (sort.c:61-79); we
    reproduce that so downstream splits behave identically.

    ``mask`` (optional bool (N,)): round-robin position counts only masked
    entries, matching the reference where the cluster's colors are a compact
    array. With ``axis_name`` (inside shard_map), round-robin positions are
    made globally consistent by offsetting each shard's local prefix count
    with the masked totals of the shards before it.

    Returns int32 bucket ids.
    """
    span = pmax - pmin
    degenerate = span < delta
    scale = jnp.where(degenerate, 0.0, 1.0 / jnp.where(degenerate, 1.0, span))
    ratio = (proj - pmin) * scale
    n = proj.shape[0]
    b = jnp.clip(
        (ratio * n_buckets).astype(jnp.int32), 0, n_buckets - 1
    )
    if mask is None:
        pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
        if axis_name is not None:
            pos = pos + jax.lax.axis_index(axis_name) * n
    else:
        pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
        if axis_name is not None:
            local_total = jnp.sum(mask.astype(jnp.int32))
            me = jax.lax.axis_index(axis_name)
            size = jax.lax.axis_size(axis_name)
            per_shard = jax.lax.psum(
                jax.nn.one_hot(me, size, dtype=jnp.int32) * local_total,
                axis_name,
            )
            offset = jnp.sum(jnp.where(jnp.arange(size) < me, per_shard, 0))
            pos = pos + offset
    rr = jnp.mod(pos, n_buckets)
    return jnp.where(degenerate, rr, b)
