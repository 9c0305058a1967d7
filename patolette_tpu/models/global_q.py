"""Global principal quantization (GQ).

Wu's dynamic-programming optimal 1-D partition of the color set projected on
its global principal axis (reference /root/reference/lib/src/quantize/global.c).
Semantics reproduced:

  * 512 projection buckets, ``max_k = 12`` cells, bias thresholds 0.9 / 0.1
    (global.c:19-22).
  * The DP moments cache is built UNWEIGHTED and the global PCA runs
    unweighted (global.c:407,418) — saliency weights only attach when
    clusters are materialized (quirk Q1, SURVEY.md H4).
  * Per-iteration termination: distortion-weighted cell bias against the
    global axis (global.c:99-187), evaluated on the previous iteration's
    quantizer before each refinement (global.c:244-254).
  * Cut backtracking through the L matrix (global.c:72-97), first-index
    tie-breaking... see note below.

Conscious divergence (documented, SURVEY.md H4 house-keeping):
  * Q7: the reference's inner DP initializes the t = n-1 candidate with cost
    ``E[n-1]`` only, omitting the last cell's own distortion ``D(n-1, n)``
    (global.c:270-276). We use the exact Bellman cost
    ``E[t] + D(t, n)`` for every candidate, which is the optimal partition
    per Wu's paper. Verified against brute force in tests.
  * Tie-breaking: the reference scans t downward with strict ``<`` so the
    LARGEST minimizing t wins; we match that.

Two implementations share the formulation:
  * :func:`gq_host` — numpy f64 on the (513, 11) prefix moments. The DP
    state is tiny, so the default pipeline runs it host-side at full
    precision; only the 512-bucket moment tuple ever leaves the device.
  * :func:`gq_device` — pure jnp, fully jittable (used by the one-shot
    compiled pipeline and the multi-chip dry run).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from patolette_tpu.ops import eigen3
from patolette_tpu.ops import moments as M

BUCKET_COUNT = 512
MAX_K = 12
BIAS_THRESHOLD = 0.1
CELL_BIAS_THRESHOLD = 0.9
DELTA = 1e-16


# --------------------------------------------------------------------------
# Shared pure-array formulation (np or jnp namespace)
# --------------------------------------------------------------------------

def _pairwise_cell_distortion(prefix, xp):
    """D[t, n] = SSE of the cell covering buckets (t, n], from prefix moments.

    ``prefix``: (B+1, 11) prefix-summed moment tuples (1-based, row 0 zero).
    Mirrors CELLS_get_cell_distortion (reference cells.c:141-182).
    """
    w0 = prefix[:, M.IDX_W0]
    w1 = prefix[:, M.IDX_W1]
    w2 = prefix[:, M.IDX_W2]
    dw0 = w0[None, :] - w0[:, None]            # (t, n)
    dw1 = w1[None, :, :] - w1[:, None, :]
    dw2 = w2[None, :] - w2[:, None]
    nonempty = dw0 > 0
    d = dw2 - xp.sum(dw1 * dw1, axis=-1) / xp.where(nonempty, dw0, 1.0)
    return xp.where(nonempty, xp.maximum(d, 0.0), 0.0)


def _cell_cov(prefix, a, b, xp):
    """Covariance of cell (a, b] from prefix moments (cells.c:184-250)."""
    m = prefix[b] - prefix[a]
    return M.moments_cov(m)


def _np_moments_cov(mom):
    """Pure-numpy covariance from an (11,) moment tuple.

    The host path must never touch jnp: on an accelerator every tiny jnp
    op is a device dispatch plus a host round trip.
    """
    w0 = mom[0]
    mu = mom[1:4] / w0
    xx, xy, xz, yy, yz, zz = mom[5:11] / w0
    second = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    return second - np.outer(mu, mu)


def _cell_bias_host(prefix, a, b, global_axis):
    """|cos angle(cell principal axis, global axis)|, clamped to <= 1
    (reference cells.c:280-328). numpy f64."""
    mom = prefix[b] - prefix[a]
    w0 = mom[M.IDX_W0]
    if w0 <= 0:
        # empty cell: zero covariance -> numpy eigh gives identity vectors
        cell_axis = np.array([0.0, 0.0, 1.0])
    else:
        cov = _np_moments_cov(mom)
        _, vecs = np.linalg.eigh(cov)
        cell_axis = vecs[:, 2]
    norms = np.linalg.norm(cell_axis) * np.linalg.norm(global_axis)
    if norms < DELTA:
        return 0.0
    cosv = float(np.dot(cell_axis, global_axis)) / norms
    return min(1.0, abs(cosv))


def _should_terminate_host(quantizer, dmat, prefix, global_axis):
    """Mirror of should_terminate (reference global.c:99-187)."""
    cells = list(zip(quantizer[:-1], quantizer[1:]))
    distortion = sum(float(dmat[a, b]) for a, b in cells)
    if distortion < DELTA:
        return True
    bias = 0.0
    for a, b in cells:
        cell_d = float(dmat[a, b])
        cell_bias = _cell_bias_host(prefix, a, b, global_axis)
        if cell_bias < CELL_BIAS_THRESHOLD:
            continue
        bias += (cell_d / distortion) * cell_bias
    return bias < BIAS_THRESHOLD


def _backtrack(cuts_rows, k, n_total):
    """l_chain (reference global.c:72-97): build [0=q0, ..., qk=N]."""
    chain = np.zeros(k + 1, dtype=np.int64)
    t = n_total
    for j in range(k - 1, 0, -1):
        t = int(cuts_rows[j + 1][t])
        chain[j] = t
    chain[0] = 0
    chain[k] = n_total
    return chain


def gq_host(bucket_moments, palette_size):
    """Host-side GQ on per-bucket (unweighted) moment tuples.

    ``bucket_moments``: (BUCKET_COUNT, 11) f64 per-bucket moments (NOT
    prefix-summed), as produced on device by
    :func:`patolette_tpu.ops.moments.segment_moments`.

    Returns ``cuts``: int64 array [0 = q0, q1, ..., qK = 512] with K <= 12.
    """
    bm = np.asarray(bucket_moments, dtype=np.float64)
    b = bm.shape[0]
    prefix = np.zeros((b + 1, M.NUM_MOMENTS))
    np.cumsum(bm, axis=0, out=prefix[1:])

    # Global principal axis from the total covariance (global.c:209 uses the
    # cache's full-range PCA; identical statistics).
    total_cov = _np_moments_cov(prefix[b])
    _, vecs = np.linalg.eigh(total_cov)
    global_axis = vecs[:, 2]

    dmat = _pairwise_cell_distortion(prefix, np)

    k_max = min(MAX_K, palette_size)
    e_prev = dmat[0, :].copy()               # E for k = 1
    cuts_rows = {1: None}
    result = np.array([0, b], dtype=np.int64)

    t_idx = np.arange(b + 1)
    for k in range(2, k_max + 1):
        if _should_terminate_host(result, dmat, prefix, global_axis):
            break
        # E_k[n] = min_{k-1 <= t <= n-1} E_{k-1}[t] + D(t, n); largest
        # minimizing t wins (reference scans t downward with strict <).
        cost = e_prev[:, None] + dmat         # (t, n)
        valid = (t_idx[:, None] >= k - 1) & (t_idx[:, None] <= t_idx[None, :] - 1)
        cost = np.where(valid, cost, np.inf)
        rev = cost[::-1, :]
        arg_rev = np.argmin(rev, axis=0)
        cut = b - arg_rev
        e_new = np.min(cost, axis=0)
        cuts_rows[k] = cut
        e_prev = e_new
        result = _backtrack(cuts_rows, k, b)

    return result


# --------------------------------------------------------------------------
# Device (jittable) implementation
# --------------------------------------------------------------------------

def _cell_bias_device(prefix, a, b, global_axis):
    mom = prefix[b] - prefix[a]
    cov = M.moments_cov(mom)
    cell_axis, _ = eigen3.principal_axis(cov)
    norms = jnp.linalg.norm(cell_axis) * jnp.linalg.norm(global_axis)
    cosv = jnp.dot(cell_axis, global_axis, precision="highest") / jnp.maximum(
        norms, DELTA
    )
    empty = mom[M.IDX_W0] <= 0
    bias = jnp.where(
        norms < DELTA, 0.0, jnp.minimum(1.0, jnp.abs(cosv))
    )
    # empty cell: zero cov -> fallback axis e_x; bias value is irrelevant
    # because its distortion weight is 0, but keep it finite.
    return jnp.where(empty, 0.0, bias)


def gq_device(bucket_moments, palette_size: int):
    """Jittable GQ. ``palette_size`` is static.

    Returns ``(cuts, k)``: cuts int32 (MAX_K + 1,) padded with BUCKET_COUNT
    beyond position k.
    """
    bm = bucket_moments
    b = bm.shape[0]
    dtype = bm.dtype
    prefix = jnp.concatenate(
        [jnp.zeros((1, M.NUM_MOMENTS), dtype), jnp.cumsum(bm, axis=0)], axis=0
    )

    total_cov = M.moments_cov(prefix[b])
    global_axis, _ = eigen3.principal_axis(total_cov)

    dmat = _pairwise_cell_distortion(prefix, jnp)
    t_idx = jnp.arange(b + 1)

    k_max = min(MAX_K, int(palette_size))

    def dp_step(e_prev, k):
        cost = e_prev[:, None] + dmat
        valid = (t_idx[:, None] >= k - 1) & (t_idx[:, None] <= t_idx[None, :] - 1)
        cost = jnp.where(valid, cost, jnp.inf)
        arg_rev = jnp.argmin(cost[::-1, :], axis=0)
        cut = (b - arg_rev).astype(jnp.int32)
        e_new = jnp.min(cost, axis=0)
        return e_new, cut

    e1 = dmat[0, :]
    ks = jnp.arange(2, k_max + 1)
    _, cut_rows = jax.lax.scan(dp_step, e1, ks)
    # cut_rows[k - 2] is the cut row for level k; prepend dummies for k=0,1.
    pad = jnp.zeros((2, b + 1), jnp.int32)
    cuts_all = jnp.concatenate([pad, cut_rows], axis=0)  # (k_max+1, b+1)

    # Build quantizers for every level 1..k_max.
    def chain_scan(k):
        # t walks down from b through cut rows k, k-1, ..., 2
        def body(j, carry):
            t, chain = carry
            # active when j in [1, k-1]
            active = (j >= 1) & (j <= k - 1)
            row = jnp.clip(j + 1, 2, k_max)
            t_next = jnp.where(active, cuts_all[row, t], t)
            chain = chain.at[j].set(jnp.where(active, t_next, chain[j]))
            return (t_next, chain)

        chain0 = jnp.full((MAX_K + 1,), jnp.int32(b))
        chain0 = chain0.at[0].set(0)
        carry = (jnp.int32(b), chain0)
        for j in range(MAX_K - 1, 0, -1):
            carry = body(j, carry)
        return carry[1]

    chains = jnp.stack([chain_scan(jnp.int32(k)) for k in range(1, k_max + 1)])

    # Termination flags for levels 1..k_max-1 (evaluated on quantizer of
    # level k before refining to k+1, global.c:244-254).
    def terminate(chain, k):
        starts = chain[:-1]
        ends = chain[1:]
        cell_live = jnp.arange(MAX_K) < k
        cell_d = jnp.where(cell_live, dmat[starts, ends], 0.0)
        distortion = jnp.sum(cell_d)

        def bias_one(a, bb):
            return _cell_bias_device(prefix, a, bb, global_axis)

        biases = jax.vmap(bias_one)(starts, ends)
        contrib = jnp.where(
            cell_live & (biases >= CELL_BIAS_THRESHOLD),
            (cell_d / jnp.maximum(distortion, DELTA)) * biases,
            0.0,
        )
        bias_total = jnp.sum(contrib)
        return (distortion < DELTA) | (bias_total < BIAS_THRESHOLD)

    term = jnp.stack(
        [terminate(chains[k - 1], k) for k in range(1, k_max + 1)]
    )
    # First level whose quantizer terminates the loop; if none of levels
    # 1..k_max-1 terminate, the result is level k_max.
    lv = jnp.arange(1, k_max + 1)
    stop_candidates = jnp.where(term & (lv < k_max), lv, k_max)
    k_final = jnp.min(stop_candidates)
    cuts = chains[k_final - 1]
    return cuts, k_final


def labels_from_cuts(buckets, cuts):
    """Map bucket ids to GQ cell labels.

    Quantizer entries use 1-based bucket indexing: bucket b belongs to cell j
    iff q_j < b + 1 <= q_{j+1} (reference global.c:324-340).
    ``cuts``: [0, q1, ..., qK (, padding = BUCKET_COUNT...)].
    """
    interior = cuts[1:]
    return jnp.searchsorted(interior, buckets + 1, side="left").astype(jnp.int32)
