"""Nearest-centroid assignment: distance-matrix argmin.

Vectorized replacement for both kd-tree uses in the reference:
  * FLANN batch palette mapping (/root/reference/lib/src/palette/nearest.c:150-209)
  * faiss ``IndexFlatL2.search`` inside KMeans
    (/root/reference/lib/faiss/faiss/Clustering.cpp:446-452)

For k <= a few thousand centroids, ``argmin_k (|x|^2 - 2 x.C^T + |c|^2)``
over a (tile, k) product is the accelerator formulation — a dense product
and a reduction, no pointer-chasing data structure (SURVEY.md section 7).

The distance matrix is never materialized for the full pixel array: pixels
stream through in chunks under ``lax.scan`` (XLA) so the transient is
``chunk x k``. (A hand-written fused variant lost to this XLA formulation
on the accelerator this was first built for and was removed; see git
history.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_DEFAULT_CHUNK = 65536

def _assign_block(x, centers, c2, valid):
    """labels, dists for one block. centers: (K,3); c2: (K,) squared norms."""
    # -2 x.C^T + |c|^2 ; |x|^2 is constant per row and irrelevant for argmin
    # but needed for returned distances.
    prod = jnp.dot(x, centers.T, precision="highest")  # (n, K)
    d = c2[None, :] - 2.0 * prod
    if valid is not None:
        d = jnp.where(valid[None, :], d, jnp.inf)
    labels = jnp.argmin(d, axis=-1).astype(jnp.int32)
    x2 = jnp.sum(x * x, axis=-1)
    dmin = jnp.min(d, axis=-1) + x2
    return labels, jnp.maximum(dmin, 0.0)


def assign(colors, centers, valid=None, chunk=_DEFAULT_CHUNK,
           with_distances=False):
    """Nearest centroid per pixel.

    Args:
      colors: (N, 3).
      centers: (K, 3). K is expected <= ~4096.
      valid: optional (K,) bool; invalid centroids never win
        (used for palette slots beyond the live cluster count).
      with_distances: also return squared L2 distances (N,).

    Ties resolve to the lowest centroid index, like faiss' exhaustive
    ``knn_L2sqr`` and FLANN's exact search.
    """
    n = colors.shape[0]
    c2 = jnp.sum(centers * centers, axis=-1)

    if n <= chunk:
        labels, dists = _assign_block(colors, centers, c2, valid)
        return (labels, dists) if with_distances else labels

    pad = (-n) % chunk
    x = colors
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((pad, 3), colors.dtype)], axis=0
        )
    xc = x.reshape(-1, chunk, 3)

    def body(_, xb):
        return None, _assign_block(xb, centers, c2, valid)

    _, (labels, dists) = jax.lax.scan(body, None, xc)
    labels = labels.reshape(-1)[:n]
    dists = dists.reshape(-1)[:n]
    return (labels, dists) if with_distances else labels


_PLANAR_CHUNK = 1 << 20


def assign_planar(channels, centers, valid=None, chunk=_PLANAR_CHUNK,
                  with_distances=False):
    """Nearest centroid for channel-planar pixels (3-tuple of ``(N,)``).

    Same semantics as :func:`assign`, formulated for the planar image
    layout: the distance matrix of a chunk is built from three rank-1
    broadcast products ``x_ch (chunk,1) * c_ch (1,K)``, so no interleaved
    ``(N, 3)`` intermediate ever exists. K <= a few thousand.
    """
    a, b, c = channels
    n = a.shape[0]
    c2 = jnp.sum(centers * centers, axis=-1)
    ca, cb, cc = centers[:, 0], centers[:, 1], centers[:, 2]

    def block(xa, xb, xc):
        d = c2[None, :] - 2.0 * (
            xa[:, None] * ca[None, :]
            + xb[:, None] * cb[None, :]
            + xc[:, None] * cc[None, :]
        )
        if valid is not None:
            d = jnp.where(valid[None, :], d, jnp.inf)
        labels = jnp.argmin(d, axis=-1).astype(jnp.int32)
        if not with_distances:
            return labels, None
        x2 = xa * xa + xb * xb + xc * xc
        return labels, jnp.maximum(jnp.min(d, axis=-1) + x2, 0.0)

    if n <= chunk:
        labels, dists = block(a, b, c)
        return (labels, dists) if with_distances else labels

    pad = (-n) % chunk
    if pad:
        z = jnp.zeros((pad,), a.dtype)
        a, b, c = (jnp.concatenate([v, z]) for v in (a, b, c))

    def body(_, xs):
        return None, block(*xs)

    _, (labels, dists) = jax.lax.scan(
        body, None,
        (a.reshape(-1, chunk), b.reshape(-1, chunk), c.reshape(-1, chunk)),
    )
    labels = labels.reshape(-1)[:n]
    if with_distances:
        return labels, dists.reshape(-1)[:n]
    return labels
