"""Batched closed-form symmetric 3x3 eigendecomposition.

Vectorized replacement for the reference's LAPACK ``dsyev_`` path
(/root/reference/lib/src/math/eigen.c:83-140) and the PCA wrappers
(/root/reference/lib/src/math/pca.c:122-149). A 3x3 symmetric eigenproblem
has a closed form (trigonometric solution of the characteristic cubic), which
vectorizes over arbitrarily many matrices — every cluster/cell PCA in the
pipeline becomes one fused elementwise pass instead of a LAPACK call per
cell.

Only the quantities the reference consumes are produced: the principal axis
(unit eigenvector of the largest eigenvalue) and the explained-variance ratio
``lambda_max / trace`` (pca.c:139-147).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-20


def eigvals_sym3(a):
    """Eigenvalues of symmetric ``(..., 3, 3)`` matrices, ascending.

    Trigonometric method (Smith 1961): exact for 3x3 symmetric input.
    """
    a00 = a[..., 0, 0]
    a11 = a[..., 1, 1]
    a22 = a[..., 2, 2]
    a01 = a[..., 0, 1]
    a02 = a[..., 0, 2]
    a12 = a[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    p_safe = jnp.where(p > 0.0, p, 1.0)

    # det((A - qI) / p) / 2
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(det_b / (2.0 * p_safe**3), -1.0, 1.0)

    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    # Degenerate (near-diagonal spherical) case: p ~ 0 -> all eigenvalues ~ q.
    diag_sorted = jnp.sort(jnp.stack([a00, a11, a22], axis=-1), axis=-1)
    tiny = p2 <= _EPS
    lo = jnp.where(tiny, diag_sorted[..., 0], e_lo)
    mid = jnp.where(tiny, diag_sorted[..., 1], e_mid)
    hi = jnp.where(tiny, diag_sorted[..., 2], e_hi)
    return jnp.stack([lo, mid, hi], axis=-1)


def principal_axis(a):
    """Unit eigenvector of the largest eigenvalue of symmetric ``(...,3,3)``.

    By Cayley-Hamilton, every nonzero column of
    ``(A - lambda_mid I)(A - lambda_lo I)`` lies in the top eigenspace; the
    largest-norm column is the numerically best-conditioned choice. For
    (near-)degenerate spectra any unit vector in the top eigenspace is a
    valid principal axis, and we fall back to the coordinate axis of the
    largest diagonal entry (what LAPACK returns for a diagonal matrix).

    Returns ``(axis, evals)`` with ``axis`` of shape ``(..., 3)`` and
    ``evals`` ascending of shape ``(..., 3)``.
    """
    evals = eigvals_sym3(a)
    lo = evals[..., 0]
    mid = evals[..., 1]

    eye = jnp.eye(3, dtype=a.dtype)
    a_mid = a - mid[..., None, None] * eye
    a_lo = a - lo[..., None, None] * eye
    m = jnp.matmul(a_mid, a_lo, precision="highest")

    col_norm2 = jnp.sum(m * m, axis=-2)  # (..., 3) squared column norms
    best = jnp.argmax(col_norm2, axis=-1)
    v = jnp.take_along_axis(m, best[..., None, None], axis=-1)[..., 0]
    vnorm2 = jnp.sum(v * v, axis=-1, keepdims=True)

    # Fallback for degenerate spectra: coordinate axis of largest diagonal.
    diag = jnp.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], axis=-1)
    fallback = jnp.eye(3, dtype=a.dtype)[jnp.argmax(diag, axis=-1)]

    ok = vnorm2[..., 0] > _EPS
    axis = jnp.where(
        ok[..., None],
        v / jnp.sqrt(jnp.where(ok[..., None], vnorm2, 1.0)),
        fallback,
    )
    return axis, evals


def pca_from_cov(cov, delta=1e-16):
    """PCA results from a (batch of) covariance matrices.

    Mirrors ``patolette__PCA_perform_PCA_vcov`` (reference pca.c:122-149):
    axis = top eigenvector, explained_variance = lambda_max / sum(lambda)
    when the eigenvalue sum exceeds ``delta``, else 0.
    """
    axis, evals = principal_axis(cov)
    total = jnp.sum(evals, axis=-1)
    ok = total > delta
    explained = jnp.where(
        ok, evals[..., 2] / jnp.where(ok, total, 1.0), 0.0
    )
    return axis, explained
