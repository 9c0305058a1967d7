"""Weighted Lloyd KMeans palette refinement.

Accelerator equivalent of the reference's modified-faiss clustering path
(/root/reference/lib/src/palette/refine.c:165-224 ->
/root/reference/lib/faiss/faiss/Clustering.cpp):

  * caller-seeded initial centroids, weights carried through
    (Clustering.cpp:587-602 modified ``kmeans_clustering``)
  * subsampling to ``k * max_points_per_centroid`` with
    ``max_points_per_centroid = max(max_samples, 256^2) / k``
    (refine.c:77-90, Clustering.cpp:309-319)
  * per-iteration exact assignment (IndexFlatL2.search -> here a matmul
    distance argmin), weighted centroid update (compute_centroids,
    Clustering.cpp:135-204), empty-cluster splitting with eps = 1/1024
    symmetric perturbation (Clustering.cpp:216-262)

Everything runs as one jitted program: assignment is a chunked matmul
argmin, the weighted update a one-hot segment matmul, the empty-split a
``fori_loop`` over the (tiny) centroid array.

Conscious divergences (documented):
  * subsampling uses JAX PRNG draws with replacement instead of faiss'
    ``rand_perm`` prefix — statistically equivalent for moment estimation,
    deterministic under ``seed``.
  * the donor cluster for an empty-cluster split is the currently largest
    cluster (argmax hassign) instead of faiss' RNG-walk proportional choice
    — deterministic, same intent (split big clusters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from patolette_tpu.ops import moments as M
from patolette_tpu.ops.assign import assign

MIN_KMEANS_SAMPLES = 256 * 256  # refine.c:21 min_kmeans_samples
SPLIT_EPS = 1.0 / 1024.0        # Clustering.cpp EPS


def subsample_cap(k: int, max_samples: int) -> int:
    """k * max_points_per_centroid (refine.c:87, integer division)."""
    return (max(int(max_samples), MIN_KMEANS_SAMPLES) // max(k, 1)) * k


def subsample(colors, weights, cap: int, seed: int):
    """Deterministic subsample of at most ``cap`` pixels (with replacement)."""
    n = colors.shape[0]
    if n <= cap:
        return colors, weights
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (cap,), 0, n)
    c = jnp.take(colors, idx, axis=0)
    w = None if weights is None else jnp.take(weights, idx, axis=0)
    return c, w


def _split_empty(centers, hassign, valid):
    """Empty-cluster handling (Clustering.cpp:216-262), deterministic donor.

    Sequentially walks the centroid slots; every valid empty cluster steals
    half the mass of the currently largest cluster, with the +/- eps
    even/odd-coordinate perturbation faiss uses.
    """
    k = centers.shape[0]
    parity = jnp.asarray([1.0, -1.0, 1.0], centers.dtype)

    def body(ci, st):
        centers, hassign = st

        def fix(st):
            centers, hassign = st
            cj = jnp.argmax(jnp.where(valid, hassign, -jnp.inf))
            c = centers[cj]
            centers = centers.at[ci].set(c * (1.0 + SPLIT_EPS * parity))
            centers = centers.at[cj].set(c * (1.0 - SPLIT_EPS * parity))
            half = hassign[cj] / 2.0
            hassign = hassign.at[ci].set(half)
            hassign = hassign.at[cj].add(-half)
            return centers, hassign

        need = valid[ci] & (hassign[ci] == 0.0)
        return jax.lax.cond(need, fix, lambda s: s, (centers, hassign))

    return jax.lax.fori_loop(0, k, body, (centers, hassign))


def lloyd_iterations(samples, weights, centers, valid, niter: int,
                     axis_name=None):
    """``niter`` weighted Lloyd iterations over fixed samples.

    ``centers``: (P, 3) with ``valid`` (P,) masking live slots; invalid
    slots never attract assignments and are never updated.
    """
    p = centers.shape[0]
    dtype = samples.dtype
    w = (
        jnp.ones((samples.shape[0],), dtype)
        if weights is None
        else weights.astype(dtype)
    )

    def body(_, centers):
        labels = assign(samples, centers, valid=valid)
        mom = M.segment_matmul(
            jnp.concatenate([w[:, None], w[:, None] * samples], axis=-1),
            labels,
            p,
            axis_name=axis_name,
        )
        hassign = mom[:, 0]
        nonzero = hassign > 0.0
        new = mom[:, 1:4] / jnp.where(nonzero, hassign, 1.0)[:, None]
        centers = jnp.where((nonzero & valid)[:, None], new, centers)
        centers, _ = _split_empty(centers, jnp.where(valid, hassign, 1.0), valid)
        return centers

    return jax.lax.fori_loop(0, niter, body, centers)


def refine_palette(colors, weights, centers, valid, k: int, niter: int,
                   max_samples: int, seed: int, axis_name=None):
    """Full refinement: subsample then iterate (refine.c:165-224).

    ``k`` is the static upper bound on live clusters used for the sampling
    cap (the reference divides by the true cluster count; using the palette
    size bound changes the cap by at most one k-rounding — documented).
    """
    cap = subsample_cap(k, max_samples)
    if axis_name is not None:
        # per-shard local sampling keeps the sample sharded; each shard
        # draws cap/axis_size of the subset with a shard-distinct key
        size = jax.lax.axis_size(axis_name)
        me = jax.lax.axis_index(axis_name)
        local_cap = -(-cap // size)
        n = colors.shape[0]
        if n > local_cap:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), me)
            idx = jax.random.randint(key, (local_cap,), 0, n)
            samples = jnp.take(colors, idx, axis=0)
            w = None if weights is None else jnp.take(weights, idx, axis=0)
        else:
            samples, w = colors, weights
    else:
        samples, w = subsample(colors, weights, cap, seed)
    return lloyd_iterations(samples, w, centers, valid, niter,
                            axis_name=axis_name)
