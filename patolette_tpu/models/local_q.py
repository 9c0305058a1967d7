"""Local quantization (LQ): greedy weighted principal-axis splitting.

Reference: /root/reference/lib/src/quantize/local.c. Turns the K <= 12 GQ
clusters into up to ``palette_size`` clusters by repeatedly splitting the
cluster whose candidate split yields the largest weighted-SSE benefit
``d - (dl + dr)`` (local.c:256-307), where each candidate split projects the
cluster on its own weighted principal axis and picks the 512-bucket cut that
maximizes the between-cluster objective ``sum_ch csl^2/sl + csr^2/sr``
(local.c:102-177).

Accelerator reformulation (SURVEY.md section 7, stage 4):
  * index-list clusters (reference cluster.h:40-52) become a dense ``(N,)``
    int32 labels array; every gather becomes a masked reduction and every
    bucket histogram a one-hot segment matmul.
  * the candidate split of a cluster is summarized by
    ``(mu, axis, pmin, pmax, split_bucket)`` so applying a cached split later
    is a recomputation of bucket ids, bit-identical to candidate time.
  * the greedy loop runs as a fixed-trip-count ``lax.fori_loop``
    (palette_size - 1 iterations) with no-op rounds once the stop condition
    hits (benefit < DELTA, local.c:364-370), keeping the whole thing
    jittable with a traced initial cluster count.

Conscious divergences (SURVEY.md H4):
  * Q2: the reference accumulates weighted bucket masses into a ``size_t``
    array, truncating fractional weights per bucket (local.c:119,133); we
    keep float masses.
  * degenerate clusters (flat projection) use plain linear binning
    (everything lands in bucket 0 => zero benefit => never split) instead
    of the reference's round-robin fallback (sort.c:61-79). Round-robin is
    only reachable for point-mass clusters whose split benefit is ~0, so
    the greedy selection is unaffected, and dropping it removes an O(N)
    prefix scan from every round (see ops.moments.bucketize_linear).

Numerics: all cluster statistics are computed on colors shifted by the
cluster's weighted mean (translation-invariant), so f32 accumulation holds
the 0.5% Delta-E budget (SURVEY.md H3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from patolette_tpu.ops import eigen3
from patolette_tpu.ops import moments as M

BUCKET_COUNT = 512
DELTA = 1e-16
_EPS = 1e-30


class LQState(NamedTuple):
    labels: jnp.ndarray        # (N,) int32 cluster id per pixel
    side: jnp.ndarray          # (N,) bool: pixel is LEFT of its cluster's
                               # optimal cut, cached at candidate time — a
                               # cluster's pixel set cannot change between
                               # its candidate evaluation and its split, so
                               # applying a split is a pure mask over this
                               # bit (no per-pixel re-projection / gathers)
    count: jnp.ndarray         # scalar int32, current cluster count
    done: jnp.ndarray          # scalar bool, stop flag
    benefit: jnp.ndarray       # (P,) candidate split benefit per cluster
    mu_child: jnp.ndarray      # (P, 2, 3) cached means of the candidate's
                               # left/right children (from the cumulative
                               # bucket sums -- saves the mean pass when the
                               # split is applied)


def _psum(x, axis_name):
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def _rank_map(ids, size: int):
    """Scatter-free inverse map: ``out[c] = j`` where ``ids[j] == c``, else
    ``len(ids)``. Built as a dense (size, C) compare + argmax — ``ids`` has
    at most ~24 entries, and XLA combines the .at[].set formulation inside
    the LQ loop into a variadic scatter, which some backends' scatter
    emitters reject (scatter_emitter.cc CHECK operand_indices.size() == 1)."""
    C = ids.shape[0]
    eq = jnp.arange(size, dtype=jnp.int32)[:, None] == ids[None, :]
    j = jnp.argmax(eq, axis=1).astype(jnp.int32)
    return jnp.where(jnp.any(eq, axis=1), j, jnp.int32(C))


def _candidates_segmented(colors, w, labels, ids, p, bucket_count=BUCKET_COUNT,
                          axis_name=None, mu_known=None, exact_range=False,
                          chunk=1 << 18):
    """Candidate splits for a SET of pairwise-disjoint clusters, O(N) total.

    Mirrors split_cluster + get_optimal_bucket_index + get_split_benefit
    (reference local.c:102-275) for every cluster in ``ids`` at once: each
    pixel is keyed by which candidate (if any) it belongs to, so every
    statistic is ONE segment reduction over N instead of ``C`` masked
    full-array passes (the r2 formulation vmapped a masked ``_candidate``
    per cluster — ~100 O(N) passes per round; this is ~4).

    ``ids``: (C,) cluster ids; entries equal to ``p`` are dead slots that
    segment zero pixels and return zero benefit (their outputs are dropped
    by the caller). Live entries must be pairwise disjoint clusters.
    ``mu_known``: (C, 3) cluster means when already available (a freshly-
    split child's mean comes free from the parent's cumulative bucket
    sums) — skips the dedicated mean pass.

    Returns per-candidate arrays matching LQState fields
    ``(benefit, mu, axis, pmin, pmax, split_bucket, mu_child)`` plus two
    per-PIXEL arrays ``(side, member)``: ``member`` marks pixels belonging
    to a live candidate and ``side`` whether such a pixel falls on the LEFT
    of its candidate's optimal cut. Caching the side bit makes applying a
    split later a pure mask (bit-identical by construction — a cluster's
    pixel set cannot change between its candidate evaluation and its
    split), instead of re-gathering 5 per-cluster tables over all pixels.

    Per-pixel values from per-candidate tables are computed as broadcast
    compare + masked sum, NOT ``tab[cand]`` gathers: the (N, C) compare
    form is ordinary fused vector code, while a gather per table per round
    is a separate memory-bound pass (gather vs compare not measured on the
    H100).
    """
    C = ids.shape[0]
    dtype = colors.dtype
    eq = labels[:, None] == ids[None, :]      # (N, C) membership
    member = jnp.any(eq, axis=1)
    cand = jnp.where(
        member, jnp.argmax(eq, axis=1).astype(jnp.int32), jnp.int32(C)
    )
    wm = jnp.where(member, w, 0.0)

    def from_tab(tab):
        """Per-pixel value of each pixel's candidate; 0 for non-members."""
        if tab.ndim == 1:
            return jnp.sum(jnp.where(eq, tab[None, :], 0), axis=1)
        return jnp.sum(
            jnp.where(eq[:, :, None], tab[None, :, :], 0), axis=1
        )

    if mu_known is None:
        # Pass 1: weighted means (cluster.c:171-189), all candidates at once.
        m1 = M.segment_matmul(
            jnp.concatenate([wm[:, None], wm[:, None] * colors], axis=-1),
            cand, C + 1, axis_name=axis_name, chunk=chunk,
        )[:C]
        mu = m1[:, 1:4] / jnp.maximum(m1[:, 0:1], _EPS)
    else:
        mu = mu_known

    # Pass 2: central moments -> covariance, distortion, principal axis
    # (cluster.c:111-152, 191-217; pca.c:62-149 weighted), shifted by each
    # candidate's own mean (selected per pixel).
    x = colors - from_tab(mu)
    mom = M.segment_moments(
        x, cand, C + 1, weights=wm, axis_name=axis_name, chunk=chunk
    )[:C]
    w0 = mom[:, M.IDX_W0]
    d = M.moments_distortion(mom)
    cov = M.moments_cov(mom)
    axis, evals = eigen3.principal_axis(cov)

    # Pass 3: projection on each candidate's own axis (sort.c:12-92).
    proj = jnp.sum(x * from_tab(axis), axis=-1)
    if exact_range:
        # The reference's exact [min, max] of the projections (sort.c:58-60).
        pmin = jax.ops.segment_min(
            jnp.where(cand < C, proj, jnp.inf), cand, C + 1
        )[:C]
        pmax = jax.ops.segment_max(
            jnp.where(cand < C, proj, -jnp.inf), cand, C + 1
        )[:C]
        if axis_name is not None:
            pmin = jax.lax.pmin(pmin, axis_name)
            pmax = jax.lax.pmax(pmax, axis_name)
        pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
        pmax = jnp.where(jnp.isfinite(pmax), pmax, 0.0)
    else:
        # Analytic +-4 sigma range from the top eigenvalue (divergence S7:
        # projections of the mean-centered cluster have mean 0 and variance
        # lambda_max; outliers clip into the edge buckets, which CONCENTRATES
        # the 512-bucket resolution where the mass is).
        sigma = jnp.sqrt(jnp.maximum(evals[..., 2], 0.0))
        pmax = 4.0 * sigma
        pmin = -pmax

    # Pass 4: per-(candidate, bucket) weighted sums (local.c:119-146). The
    # objective's argmax is invariant to the mean shift: substituting
    # csl = csl' + sl*mu into sum_ch csl^2/sl + csr^2/sr adds a
    # split-independent constant.
    #
    # Layout: keying one segment matmul on cand * bucket_count + bucket
    # would make the one-hot (N, C*512+1) — ~9 GB of device-memory
    # traffic per round at the headline shapes. So the candidate axis rides
    # the FEATURE columns instead: features widen to (N, C*5) columns (zero
    # except the pixel's own candidate block) and the one-hot shrinks to
    # (N, 512) — ~25x less traffic, all XLA.
    buckets = M.bucketize_linear(
        proj, bucket_count, from_tab(pmin), from_tab(pmax)
    )
    feats = jnp.concatenate(
        [
            wm[:, None],
            wm[:, None] * x,
            jnp.sum(wm[:, None] * x * x, axis=-1, keepdims=True),
        ],
        axis=-1,
    )  # (N, 5): [w, w*x', w*|x'|^2]; zero for non-member pixels (wm = 0)
    feats_ext = jnp.where(
        eq[:, :, None], feats[:, None, :], jnp.zeros((), dtype)
    ).reshape(-1, C * 5)
    bstats = (
        M.segment_matmul(
            feats_ext, buckets, bucket_count, axis_name=axis_name,
            fast=True, chunk=chunk,
        )
        .reshape(bucket_count, C, 5)
        .transpose(1, 0, 2)
    )  # (C, 512, 5)

    cum = jnp.cumsum(bstats, axis=1)          # (C, 512, 5)
    sl = cum[..., 0]
    csl = cum[..., 1:4]
    cw2l = cum[..., 4]
    st = cum[:, -1, 0]
    cst = cum[:, -1, 1:4]
    w2t = cum[:, -1, 4]
    sr = st[:, None] - sl
    csr = cst[:, None, :] - csl

    sl_ok = sl > 0.0
    sr_ok = sr > 0.0
    obj = jnp.where(
        sl_ok, jnp.sum(csl * csl, -1) / jnp.where(sl_ok, sl, 1.0), 0.0
    ) + jnp.where(
        sr_ok, jnp.sum(csr * csr, -1) / jnp.where(sr_ok, sr, 1.0), 0.0
    )
    s = jnp.argmax(obj, axis=1).astype(jnp.int32)  # first max (Vector_maxloc)

    def at_s(a):  # (C, bucket_count, ...) -> (C, ...) at each cand's cut
        return jnp.take_along_axis(
            a, s.reshape((C,) + (1,) * (a.ndim - 1)), axis=1
        )[:, 0]

    sl_s, csl_s, cw2l_s = at_s(sl), at_s(csl), at_s(cw2l)
    sl_ok_s = sl_s > 0.0
    sr_s = st - sl_s
    sr_ok_s = sr_s > 0.0

    # Child distortions from the cumulative sums at the chosen cut.
    dl = jnp.where(
        sl_ok_s,
        jnp.maximum(
            cw2l_s - jnp.sum(csl_s ** 2, -1) / jnp.maximum(sl_s, _EPS), 0.0
        ),
        0.0,
    )
    w2r = w2t - cw2l_s
    csr_s = cst - csl_s
    dr = jnp.where(
        sr_ok_s,
        jnp.maximum(
            w2r - jnp.sum(csr_s ** 2, -1) / jnp.maximum(sr_s, _EPS), 0.0
        ),
        0.0,
    )
    benefit = jnp.maximum(d - (dl + dr), 0.0)
    # A size<=1 or empty cluster has zero distortion, hence zero benefit —
    # the reference's explicit size guard (local.c:186-190) is implied.
    benefit = jnp.where(w0 <= 0.0, 0.0, benefit)

    # Child means from the cumulative shifted sums (linearity of the
    # weighted mean): free when this split is later applied.
    mu_l = mu + csl_s / jnp.maximum(sl_s, _EPS)[:, None]
    mu_r = mu + csr_s / jnp.maximum(sr_s, _EPS)[:, None]
    mu_child = jnp.stack([mu_l, mu_r], axis=1)  # (C, 2, 3)

    # Per-pixel side of each candidate's optimal cut (see docstring).
    side = member & (buckets <= from_tab(s))
    return benefit, mu, axis, pmin, pmax, s, mu_child, side, member


def lq_quantize(colors, weights, init_labels, k0, palette_size: int,
                bucket_count=BUCKET_COUNT, axis_name=None,
                batch_splits: int = 1, exact_range: bool = False):
    """Greedy splitting from ``k0`` initial clusters up to ``palette_size``.

    Args:
      colors: (N, 3) working-space colors.
      weights: (N,) or None.
      init_labels: (N,) int32 labels in [0, k0).
      k0: traced or static scalar, initial cluster count (<= 12).
      palette_size: static int.
      batch_splits: clusters split per round. 1 reproduces the reference's
        strictly sequential greedy (local.c:347-390). B > 1 splits the top-B
        benefit clusters per round — a documented divergence (S6) that cuts
        the sequential round count ~B-fold with quality validated to be
        neutral (the top-B by benefit are almost always what B successive
        greedy rounds would have picked).

    Returns ``(labels, count)`` — final labels in [0, count).
    """
    n = colors.shape[0]
    p = int(palette_size)
    dtype = colors.dtype
    w = (
        jnp.ones((n,), dtype)
        if weights is None
        else weights.astype(dtype)
    )
    k0 = jnp.asarray(k0, jnp.int32)

    max_k0 = min(12, p)

    # Batched candidate computation: ONE segment-keyed pass over all pixels
    # for the whole candidate set (the clusters are pairwise disjoint).
    def cand_many(labels_arr, ids, mu_known=None):
        return _candidates_segmented(
            colors, w, labels_arr, ids, p, bucket_count,
            axis_name=axis_name, mu_known=mu_known, exact_range=exact_range,
        )

    ids0 = jnp.arange(max_k0, dtype=jnp.int32)
    b0, _, _, _, _, _, mc0, side0, _ = cand_many(init_labels, ids0)
    live = ids0 < k0
    b0 = jnp.where(live, b0, 0.0)

    def pad(vals, fill_shape, fill_dtype):
        padding = jnp.zeros((p - max_k0,) + fill_shape, fill_dtype)
        return jnp.concatenate([vals.astype(fill_dtype), padding], axis=0)

    state = LQState(
        labels=init_labels.astype(jnp.int32),
        side=side0,
        count=k0,
        done=jnp.asarray(False),
        benefit=pad(b0, (), dtype),
        mu_child=pad(mc0, (2, 3), dtype),
    )

    # Cap the batch relative to the palette: with B comparable to the live
    # cluster count, batching degrades into balanced splitting (every
    # cluster splits regardless of benefit). ~P/16 keeps the split order
    # near-greedy where it matters (r5 A/B: B=16 at p=256 matched B=1
    # quality on the guardrail battery and cut the round count ~1.6x).
    bsz = max(1, min(int(batch_splits), (p + 15) // 16, p - 1))

    def round_body(_, st):
        def do_round(st):
            vals, sel = jax.lax.top_k(st.benefit, bsz)
            sel = sel.astype(jnp.int32)
            # top_k is value-sorted, so the valid entries form a prefix:
            # benefit >= DELTA and room left in the palette.
            room = p - st.count
            j_idx = jnp.arange(bsz, dtype=jnp.int32)
            valid = (vals >= DELTA) & (j_idx < room)
            m = jnp.sum(valid, dtype=jnp.int32)

            def stop(st):
                return st._replace(done=jnp.asarray(True))

            def split(st):
                # Relabel: each selected cluster's cached LEFT side moves to
                # slot count + j (disjoint parents => no conflicts). The
                # side bit was computed at candidate time, so this is a pure
                # mask — no per-pixel projection or table lookups. The rank
                # of a pixel's cluster among this round's splits comes from
                # a (N, bsz) compare, not a (p,)-table gather (see
                # _candidates_segmented docstring).
                sel_v = jnp.where(valid, sel, p)  # invalid picks -> dead id
                eqs = st.labels[:, None] == sel_v[None, :]  # (N, bsz)
                jpix = jnp.argmax(eqs, axis=1).astype(jnp.int32)
                hit = jnp.any(eqs, axis=1)
                labels = jnp.where(
                    hit & st.side, st.count + jpix, st.labels
                )

                # Left child takes the NEW slot (count + j), right child
                # keeps the old slot (local.c:372-379). All 2B fresh children
                # are evaluated in one segmented pass; means come free from
                # the parents' cumulative bucket sums.
                left_ids = st.count + j_idx
                ids2b = jnp.concatenate([left_ids, sel])
                mu_known = jnp.concatenate(
                    [st.mu_child[sel, 0], st.mu_child[sel, 1]]
                )
                valid2 = jnp.concatenate([valid, valid])
                # Invalid selections can collide with valid left-child slots
                # (top_k picks arbitrary zero-benefit indices); route them to
                # the dead id p, so they segment zero pixels in cand_many and
                # never appear in the rank map below.
                ids2b_w = jnp.where(valid2, ids2b, p)
                C2 = 2 * bsz
                bc, _, _, _, _, _, mcc, sidec, memberc = cand_many(
                    labels, ids2b_w, mu_known=mu_known
                )
                side = jnp.where(memberc, sidec, st.side)

                # State write-back as gathers from the rank map instead of
                # same-index scatters: XLA's scatter combiner would merge
                # those into one variadic scatter, which some backends'
                # scatter emitters reject (scatter_emitter.cc CHECK
                # operand_indices.size() == 1 -> compile SIGABRT).
                rk = _rank_map(ids2b_w, p + 1)[:p]
                has = rk < C2
                rk_c = jnp.minimum(rk, C2 - 1)

                def upd(arr, vals_new):
                    mask = has.reshape((p,) + (1,) * (arr.ndim - 1))
                    return jnp.where(mask, vals_new[rk_c], arr)

                return st._replace(
                    labels=labels,
                    side=side,
                    count=st.count + m,
                    benefit=upd(st.benefit, bc),
                    mu_child=upd(st.mu_child, mcc),
                )

            return jax.lax.cond(m == 0, stop, split, st)

        active = (~st.done) & (st.count < p)
        return jax.lax.cond(active, do_round, lambda s: s, st)

    # Ramp-up headroom: early rounds can split at most count clusters, so
    # from k0 = 1 it takes ~log2(bsz) doubling rounds before bsz splits per
    # round are possible. Extra rounds no-op once count reaches p.
    ramp = max(1, bsz).bit_length()
    rounds = -(-(p - 1) // bsz) + ramp
    state = jax.lax.fori_loop(0, rounds, round_body, state)
    return state.labels, state.count
