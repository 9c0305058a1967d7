"""Minimum-Barrier-Distance saliency weighting.

Reference: the Cython/NumPy implementation at
/root/reference/src/patolette/patolette.pyx:47-317. Pipeline reproduced:

  1. MBD transform of the channel-mean image: 3 passes of alternating
     raster scans (iteration 0 and 2 are INVERSE scans, iteration 1 forward
     — pyx:181-199), barrier cost ``max(U, I) - min(L, I)`` with the
     neighbor that minimizes it (pyx:54-156).
  2. Border prior: Mahalanobis distance of every pixel's Lab color to the
     mean of each of 4 border strips (thickness = floor(0.1 * sqrt(W*H))),
     each normalized by its max; combined as ``sum - max`` (pyx:203-288).
  3. Center prior (radial falloff, pyx:296-304), sigmoid squash with b = 10
     (pyx:306-312), final weights ``1 + sal^2 * (rows*cols)/tile_size^2``
     (pyx:313).

Accelerator reformulation (SURVEY.md section 7, stage 7): the serial 2-D
raster recurrence is a wavefront: cell (x, y) depends on (x-1, y), (x, y-1)
— both on the previous anti-diagonal — so each pass is a ``lax.scan`` over
anti-diagonals of a skewed layout with O(rows) vector work per step.

Divergences: singular border covariances use pseudo-inverse (the reference
would raise LinAlgError); images with a dimension <= 3 return None (no
weighting), where the reference would crash on ``sal.shape``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from patolette_tpu.ops import colorspace as cs


# --------------------------------------------------------------------------
# MBD raster scans as anti-diagonal wavefronts
# --------------------------------------------------------------------------

def _skew(a):
    """(rows, cols) -> (rows, rows+cols-1) with S[x, x+y] = A[x, y].

    Pure pad + reshape, no scatter: padding each row to width cols+rows
    and reflowing at width cols+rows-1 shifts row x right by exactly x
    (flat index x*(cols+rows) + y = x*(W2) + (x+y) with W2 = cols+rows-1).
    """
    rows, cols = a.shape
    w2 = rows + cols - 1
    flat = jnp.pad(a, ((0, 0), (0, rows))).reshape(-1)[: rows * w2]
    return flat.reshape(rows, w2)


def _unskew(s, rows, cols):
    """Inverse of :func:`_skew`: A[x, y] = flat(S)[x*(W2+1) + y]."""
    w2 = rows + cols - 1
    flat = jnp.pad(s.reshape(-1), (0, rows))
    return flat.reshape(rows, w2 + 1)[:, :cols]


def _wavefront_pass(img, l, u, d, inverse: bool):
    """One raster scan (forward: pyx:54-104; inverse: pyx:106-156).

    Forward updates x in [1, rows-2], y in [1, cols-2] reading already-
    updated (x-1, y) and (x, y-1). Inverse updates x, y in [2, rows-2] /
    [2, cols-2] (note the reference's ``while x > 1``) reading (x+1, y),
    (x, y+1). Both neighbor sets live on the adjacent anti-diagonal, so a
    scan over diagonals with the previous diagonal as carry is exact.
    """
    rows, cols = img.shape
    ndiag = rows + cols - 1
    xs_idx = jnp.arange(rows)

    # (ndiag, rows) layout consumed through the scan's xs: each step then
    # reads a contiguous leading-axis slice, not a strided column of a
    # (rows, ndiag) array (bit-identical either way).
    s_img = _skew(img).T
    s_l, s_u, s_d = _skew(l).T, _skew(u).T, _skew(d).T

    diags = jnp.arange(ndiag)
    if not inverse:
        x_lo, x_hi = 1, rows - 2
        y_lo, y_hi = 1, cols - 2
    else:
        s_img, s_l, s_u, s_d = (
            a[::-1] for a in (s_img, s_l, s_u, s_d)
        )
        diags = diags[::-1]
        x_lo, x_hi = 2, rows - 2
        y_lo, y_hi = 2, cols - 2

    def step(carry, inputs):
        pl, pu, pd = carry  # previous diagonal's NEW columns (len rows)
        ix, il, iu, idd, dg = inputs

        y = dg - xs_idx
        active = (
            (xs_idx >= x_lo) & (xs_idx <= x_hi) & (y >= y_lo) & (y <= y_hi)
        )

        if not inverse:
            # neighbor 1: (x-1, y) -> prev diag, row x-1
            u1 = jnp.roll(pu, 1)
            l1 = jnp.roll(pl, 1)
            # neighbor 2: (x, y-1) -> prev diag, row x
            u2, l2 = pu, pl
        else:
            u1 = jnp.roll(pu, -1)   # (x+1, y)
            l1 = jnp.roll(pl, -1)
            u2, l2 = pu, pl         # (x, y+1)

        b1 = jnp.maximum(u1, ix) - jnp.minimum(l1, ix)
        b2 = jnp.maximum(u2, ix) - jnp.minimum(l2, ix)

        keep = (idd <= b1) & (idd <= b2)
        use1 = (~keep) & (b1 < idd) & (b1 <= b2)
        use2 = (~keep) & (~use1)

        nd = jnp.where(use1, b1, jnp.where(use2, b2, idd))
        nu = jnp.where(use1, jnp.maximum(u1, ix),
                       jnp.where(use2, jnp.maximum(u2, ix), iu))
        nl = jnp.where(use1, jnp.minimum(l1, ix),
                       jnp.where(use2, jnp.minimum(l2, ix), il))

        nd = jnp.where(active, nd, idd)
        nu = jnp.where(active, nu, iu)
        nl = jnp.where(active, nl, il)
        return (nl, nu, nd), (nl, nu, nd)

    init = (
        jnp.zeros((rows,), img.dtype),
        jnp.zeros((rows,), img.dtype),
        jnp.zeros((rows,), img.dtype),
    )
    # unroll: each step touches only (rows,)-sized vectors, so the scan is
    # likely step-overhead-bound (3 passes x rows+cols-1 steps; not
    # measured on the H100); unrolling amortizes the per-step cost with
    # bit-identical results.
    _, (ol, ou, od) = jax.lax.scan(
        step, init, (s_img, s_l, s_u, s_d, diags), unroll=8
    )
    if inverse:
        ol, ou, od = ol[::-1], ou[::-1], od[::-1]
    l_new = _unskew(ol.T, rows, cols)
    u_new = _unskew(ou.T, rows, cols)
    d_new = _unskew(od.T, rows, cols)
    return l_new, u_new, d_new


@jax.jit
def mbd(img):
    """Minimum barrier distance, 3 alternating scans (pyx:158-201)."""
    rows, cols = img.shape
    l = img
    u = img
    d = jnp.full((rows, cols), jnp.inf, img.dtype)
    d = d.at[0, :].set(0).at[-1, :].set(0).at[:, 0].set(0).at[:, -1].set(0)

    for it in range(3):
        inverse = it % 2 == 0  # pyx:182: x % 2 == 1 -> forward scan
        l, u, d = _wavefront_pass(img, l, u, d, inverse)
    return d


# --------------------------------------------------------------------------
# Border + center priors, final weight formula
# --------------------------------------------------------------------------

def _pinv3(a):
    """Pseudo-inverse of a 3x3 matrix, as ``jnp.linalg.pinv`` computes it
    (SVD, singular values below ``30 * eps * s_max`` dropped), with the
    reconstruction product pinned to full f32 so it cannot run in TF32."""
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    cutoff = 30.0 * jnp.finfo(a.dtype).eps * s[0]
    s = jnp.where(s > cutoff, s, jnp.inf)
    return jnp.matmul(vh.T, u.T / s[:, None], precision="highest")


def _border_prior(lab, border):
    """4 Mahalanobis border maps, each /max, combined sum - max
    (pyx:215-288).

    ``lab`` is channel-planar: a 3-tuple of (rows, cols) arrays. The
    Mahalanobis form is expanded into its 6 unique quadratic terms on the
    channel planes, so no interleaved (N, 3) intermediate exists.
    """
    l0, l1, l2 = lab
    rows, cols = l0.shape

    def strip_view(ch):
        return [
            ch[0:border],                      # "left" (top rows, pyx:215)
            ch[rows - border - 1:-1],          # "right" (bottom rows)
            ch[:, 0:border],                   # "top" (left cols)
            ch[:, cols - border - 1:-1],       # "bottom" (right cols)
        ]

    s0, s1, s2 = strip_view(l0), strip_view(l1), strip_view(l2)

    maps = []
    for k in range(4):
        a, b, c = s0[k].reshape(-1), s1[k].reshape(-1), s2[k].reshape(-1)
        m = jnp.stack([jnp.mean(a), jnp.mean(b), jnp.mean(c)])
        da, db, dc = a - m[0], b - m[1], c - m[2]
        # np.cov: unbiased (n-1) normalization (pyx:232-236)
        nrm = 1.0 / jnp.maximum(a.shape[0] - 1, 1)
        cov = jnp.stack([
            jnp.stack([jnp.sum(da * da), jnp.sum(da * db), jnp.sum(da * dc)]),
            jnp.stack([jnp.sum(da * db), jnp.sum(db * db), jnp.sum(db * dc)]),
            jnp.stack([jnp.sum(da * dc), jnp.sum(db * dc), jnp.sum(dc * dc)]),
        ]) * nrm
        vi = _pinv3(cov)
        x0, x1, x2 = l0 - m[0], l1 - m[1], l2 - m[2]
        d2 = (
            vi[0, 0] * x0 * x0 + vi[1, 1] * x1 * x1 + vi[2, 2] * x2 * x2
            + 2.0 * (vi[0, 1] * x0 * x1 + vi[0, 2] * x0 * x2
                     + vi[1, 2] * x1 * x2)
        )
        u = jnp.sqrt(jnp.maximum(d2, 0.0))
        maps.append(u / jnp.maximum(jnp.max(u), 1e-30))

    stacked = jnp.stack(maps)
    return jnp.sum(stacked, axis=0) - jnp.max(stacked, axis=0)


def get_weights(img_srgb, tile_size: float):
    """Saliency weights for an (H, W, 3) sRGB image (pyx:203-313).

    Returns (H*W,) weights in [1, inf), or None for degenerate sizes.
    """
    rows, cols = int(img_srgb.shape[0]), int(img_srgb.shape[1])
    planar = (
        img_srgb[..., 0], img_srgb[..., 1], img_srgb[..., 2]
    )
    return get_weights_planar(planar, rows, cols, tile_size)


def get_weights_planar(channels, rows: int, cols: int, tile_size: float,
                       total_pixels: int | None = None):
    """Planar-channel saliency: ``channels`` is a 3-tuple of (rows*cols,)
    or (rows, cols) sRGB arrays. See :func:`get_weights`.

    ``total_pixels`` overrides the area factor in the final weight formula
    ``1 + sal^2 * area / tile_size^2`` (pyx:313) — used by the per-strip
    sharded path, where ``rows`` is only the strip height but weights must
    keep the full-image scale.

    Jitted as ONE program when called eagerly (the priors are ~80 ops,
    each an eager dispatch otherwise); transparent when traced into a
    larger program.
    """
    if rows <= 3 or cols <= 3:
        return None
    return _weights_planar_jit(
        tuple(channels), rows=rows, cols=cols, tile_size=float(tile_size),
        total_pixels=total_pixels,
    )


@functools.partial(jax.jit, static_argnames=(
    "rows", "cols", "tile_size", "total_pixels"
))
def _weights_planar_jit(channels, *, rows, cols, tile_size, total_pixels):
    r, g, b = (ch.reshape(rows, cols).astype(jnp.float32)
               for ch in channels)

    img_mean = (r + g + b) * (1.0 / 3.0)
    sal = mbd(img_mean)

    border = int(0.1 * (rows * cols) ** 0.5)
    border = max(border, 1)

    lab = cs.srgb_to_lab((r, g, b))
    u_final = _border_prior(lab, border)

    sal = sal / jnp.maximum(jnp.max(sal), 1e-30) + u_final / jnp.maximum(
        jnp.max(u_final), 1e-30
    )
    sal = sal / jnp.maximum(jnp.max(sal), 1e-30)

    # center prior (pyx:296-304); w = rows, h = cols in the reference's
    # (confusing) naming
    w2 = rows / 2.0
    h2 = cols / 2.0
    yv, xv = jnp.meshgrid(
        jnp.arange(rows, dtype=sal.dtype),
        jnp.arange(cols, dtype=sal.dtype),
        indexing="ij",
    )
    c = 1.0 - jnp.sqrt((xv - h2) ** 2 + (yv - w2) ** 2) / jnp.sqrt(
        w2**2 + h2**2
    )
    sal = sal * c

    sal = sal / jnp.maximum(jnp.max(sal), 1e-30)
    sal = 1.0 / (1.0 + jnp.exp(-10.0 * (sal - 0.5)))  # pyx:306-312

    area = rows * cols if total_pixels is None else int(total_pixels)
    return 1.0 + sal.reshape(-1) ** 2 * area / (tile_size**2)
