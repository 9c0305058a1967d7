"""Fused, vectorized color-space transforms.

Vectorized reimplementation of the reference's per-row C converters
(/root/reference/lib/src/color/{sRGB,xyz,CIELuv,ICtCp,rec2020,eotf}.c) as
pure ``jnp`` functions. Everything is elementwise + 3x3 matmuls, so a
single ``jit`` fuses each composite transform into one pass over the
pixel array.

Every transform accepts EITHER an ``(..., 3)`` array OR a channel-planar
3-tuple of same-shaped arrays, returning the matching form. Full images use
the planar form: each channel is read with unit stride (coalesced), and no
interleaved copy of the image is ever built. (The reference stores colors
column-major / Fortran-order for the same data-locality reason,
patolette.c:126-129.) The 3x3 "matmuls" in planar form are nine explicit
f32 multiply-adds — full precision, never a reduced-precision matrix
unit — so ``precision="highest"`` concerns only the array form.

Conventions (identical to the reference):
  * sRGB values are gamma-encoded in [0, 1]; gamma decode/encode clamp to
    [0, 1] (reference sRGB.c:70-110).
  * The ICtCp triplet is stored with the Ct coordinate HALVED so Euclidean
    distance approximates the Delta-E ITP perceptual metric
    (reference ICtCp.c:60-65,78; the inverse doubles it, rec2020.c:51-56).
  * CIELuv uses the D65 reference white (reference CIELuv.c:19-25).

All constants are standard published colorimetry values (sRGB/Rec2020
primaries, SMPTE ST 2084 PQ curve); citations point at where the reference
uses them so parity can be checked.
"""

from __future__ import annotations

import jax.numpy as jnp

# --------------------------------------------------------------------------
# Matrices. Rows act on column vectors: out = M @ [c0, c1, c2]^T.
# Stored here as (3, 3) so that `colors @ M.T` maps (..., 3) -> (..., 3).
# --------------------------------------------------------------------------

# sRGB (linear) -> CIE XYZ (reference xyz.c:37-39)
M_SRGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)

# CIE XYZ -> sRGB (linear) (reference sRGB.c:52-54)
M_XYZ_TO_SRGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)

# CIE XYZ -> linear Rec2020 (reference rec2020.c:99-101)
M_XYZ_TO_REC2020 = (
    (1.71666343, -0.35567332, -0.25336809),
    (-0.66667384, 1.61645574, 0.0157683),
    (0.01764248, -0.04277698, 0.94224328),
)

# linear Rec2020 -> CIE XYZ (reference xyz.c:61-63)
M_REC2020_TO_XYZ = (
    (0.63695351, 0.14461919, 0.16885585),
    (0.26269834, 0.67800877, 0.0592929),
    (0.0, 0.02807314, 1.06082723),
)

# linear Rec2020 -> LMS (reference ICtCp.c:66-68)
M_REC2020_TO_LMS = (
    (1688.0 / 4096.0, 2146.0 / 4096.0, 262.0 / 4096.0),
    (683.0 / 4096.0, 2951.0 / 4096.0, 462.0 / 4096.0),
    (99.0 / 4096.0, 309.0 / 4096.0, 3688.0 / 4096.0),
)

# L'M'S' -> ICtCp, with the Ct row already halved (reference ICtCp.c:74-78)
M_LMSP_TO_ICTCP = (
    (0.5, 0.5, 0.0),
    (0.5 * 6610.0 / 4096.0, 0.5 * -13613.0 / 4096.0, 0.5 * 7003.0 / 4096.0),
    (17933.0 / 4096.0, -17390.0 / 4096.0, -543.0 / 4096.0),
)

# ICtCp (halved Ct) -> L'M'S'; Ct column doubled (reference rec2020.c:51-56)
M_ICTCP_TO_LMSP = (
    (1.0, 2.0 * 0.00860904, 0.11102963),
    (1.0, 2.0 * -0.00860904, -0.11102963),
    (1.0, 2.0 * 0.56003134, -0.32062717),
)

# LMS -> linear Rec2020 (reference rec2020.c:58-60)
M_LMS_TO_REC2020 = (
    (3.43660669, -2.50645212, 0.06984542),
    (-0.79132956, 1.98360045, -0.1922709),
    (-0.0259499, -0.09891371, 1.12486361),
)

# D65 reference white (reference CIELuv.c:19-25)
D65_X = 0.95047
D65_Y = 1.0
D65_Z = 1.08883
K_E = 216.0 / 24389.0
K_K = 24389.0 / 27.0
K_KE = 8.0

# SMPTE ST 2084 PQ constants (reference eotf.c:13-18)
PQ_LP = 10000.0
PQ_M1 = 0.1593017578125
PQ_M2 = 78.84375
PQ_C1 = 0.8359375
PQ_C2 = 18.8515625
PQ_C3 = 18.6875


def _is_planar(x):
    return isinstance(x, (tuple, list))


def _split(x):
    """(..., 3) array or 3-tuple -> 3 channel arrays."""
    if _is_planar(x):
        return x[0], x[1], x[2]
    return x[..., 0], x[..., 1], x[..., 2]


def _join(like, a, b, c):
    """3 channel arrays -> same container kind as ``like``."""
    if _is_planar(like):
        return (a, b, c)
    return jnp.stack([a, b, c], axis=-1)


def _map1(f, x):
    """Apply an elementwise primitive to an array or each planar channel."""
    if _is_planar(x):
        return tuple(f(ch) for ch in x)
    return f(x)


def _matmul(x, m):
    # precision='highest': at the default an f32 matmul may run at reduced
    # precision (TF32 on the GPU, bf16 passes elsewhere), which costs up to
    # ~0.5 absolute error on CIELuv-scale coordinates. These (N,3)@(3,3)
    # products are bandwidth-bound, so full f32 is free. The planar branch
    # is nine explicit f32 multiply-adds (exact).
    if _is_planar(x):
        a, b, c = x
        return tuple(
            m[i][0] * a + m[i][1] * b + m[i][2] * c for i in range(3)
        )
    mt = jnp.asarray(m, dtype=x.dtype).T
    return jnp.dot(x, mt, precision="highest")


# --------------------------------------------------------------------------
# Elementwise primitives
# --------------------------------------------------------------------------

def srgb_gamma_decode(c):
    """sRGB transfer function; clamps output to [0, 1]
    (reference sRGB.c:70-89)."""
    lin = jnp.where(
        c <= 0.0404500,
        c / 12.92,
        jnp.power(jnp.maximum(c + 0.055, 0.0) / 1.055, 2.4),
    )
    return jnp.clip(lin, 0.0, 1.0)


def srgb_gamma_encode(c):
    """Inverse sRGB transfer function; clamps output to [0, 1]
    (reference sRGB.c:91-110)."""
    enc = jnp.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * jnp.power(jnp.maximum(c, 0.0), 1.0 / 2.4) - 0.055,
    )
    return jnp.clip(enc, 0.0, 1.0)


def pq_eotf(v):
    """SMPTE ST 2084 electro-optical transfer function
    (reference eotf.c:29-44).

    Negative inputs (out-of-gamut intermediates) are clamped to 0 instead of
    propagating NaN through ``pow``.
    """
    v_p = jnp.power(jnp.maximum(v, 0.0), 1.0 / PQ_M2)
    n = jnp.maximum(0.0, v_p - PQ_C1)
    l = jnp.power(n / (PQ_C2 - PQ_C3 * v_p), 1.0 / PQ_M1)
    return PQ_LP * l


def pq_eotf_inverse(f):
    """Inverse of the ST 2084 EOTF (reference eotf.c:46-57).

    Negative inputs clamp to 0 (same rationale as :func:`pq_eotf`)."""
    y = jnp.power(jnp.maximum(f, 0.0) / PQ_LP, PQ_M1)
    return jnp.power((PQ_C1 + PQ_C2 * y) / (1.0 + PQ_C3 * y), PQ_M2)


# --------------------------------------------------------------------------
# Pairwise space conversions, (..., 3) -> (..., 3)
# --------------------------------------------------------------------------

def srgb_to_xyz(rgb):
    """Gamma decode + primaries matrix (reference xyz.c:14-40)."""
    return _matmul(_map1(srgb_gamma_decode, rgb), M_SRGB_TO_XYZ)


def xyz_to_srgb(xyz):
    """Primaries matrix + gamma encode (reference sRGB.c:30-58)."""
    return _map1(srgb_gamma_encode, _matmul(xyz, M_XYZ_TO_SRGB))


def xyz_to_linear_rec2020(xyz):
    return _matmul(xyz, M_XYZ_TO_REC2020)


def linear_rec2020_to_xyz(rgb2020):
    return _matmul(rgb2020, M_REC2020_TO_XYZ)


def xyz_to_cieluv(xyz):
    """CIE XYZ -> CIELuv with D65 white (reference CIELuv.c:54-100)."""
    x, y, z = _split(xyz)
    den = x + 15.0 * y + 3.0 * z
    safe = den > 0.0
    den_safe = jnp.where(safe, den, 1.0)
    up = jnp.where(safe, 4.0 * x / den_safe, 0.0)
    vp = jnp.where(safe, 9.0 * y / den_safe, 0.0)

    ref_den = D65_X + 15.0 * D65_Y + 3.0 * D65_Z
    urp = 4.0 * D65_X / ref_den
    vrp = 9.0 * D65_Y / ref_den

    yr = y / D65_Y
    big = yr > K_E
    l = jnp.where(
        big,
        116.0 * jnp.power(jnp.maximum(yr, 0.0), 1.0 / 3.0) - 16.0,
        K_K * yr,
    )
    u = 13.0 * l * (up - urp)
    v = 13.0 * l * (vp - vrp)
    return _join(xyz, l, u, v)


def cieluv_to_xyz(luv):
    """CIELuv -> CIE XYZ with zero-denominator guards
    (reference CIELuv.c:110-164)."""
    l, u, v = _split(luv)
    y = jnp.where(
        l > K_KE,
        jnp.power((l + 16.0) / 116.0, 3.0),
        l / K_K,
    )
    ref_den = D65_X + 15.0 * D65_Y + 3.0 * D65_Z
    u0 = 4.0 * D65_X / ref_den
    v0 = 9.0 * D65_Y / ref_den

    a_den = u + 13.0 * l * u0
    a_safe = a_den != 0.0
    a = jnp.where(
        a_safe,
        ((52.0 * l) / jnp.where(a_safe, a_den, 1.0) - 1.0) / 3.0,
        0.0,
    )
    b = -5.0 * y
    c = -1.0 / 3.0
    d_den = v + 13.0 * l * v0
    d_safe = d_den != 0.0
    d = jnp.where(
        d_safe,
        y * ((39.0 * l) / jnp.where(d_safe, d_den, 1.0) - 5.0),
        0.0,
    )
    x_den = a - c
    x_safe = x_den != 0.0
    x = jnp.where(x_safe, (d - b) / jnp.where(x_safe, x_den, 1.0), 0.0)
    z = x * a + b
    return _join(luv, x, y, z)


def linear_rec2020_to_ictcp(rgb2020):
    """Linear Rec2020 -> ICtCp with HALVED Ct (reference ICtCp.c:41-79)."""
    lms = _matmul(rgb2020, M_REC2020_TO_LMS)
    lmsp = _map1(pq_eotf_inverse, lms)
    return _matmul(lmsp, M_LMSP_TO_ICTCP)


def ictcp_to_linear_rec2020(ictcp):
    """ICtCp (halved Ct) -> linear Rec2020 (reference rec2020.c:32-69)."""
    lmsp = _matmul(ictcp, M_ICTCP_TO_LMSP)
    lms = _map1(pq_eotf, lmsp)
    return _matmul(lms, M_LMS_TO_REC2020)


# --------------------------------------------------------------------------
# Composite conversions used by the pipeline
# --------------------------------------------------------------------------

def srgb_to_linear_rec2020(rgb):
    return xyz_to_linear_rec2020(srgb_to_xyz(rgb))


def linear_rec2020_to_srgb(rgb2020):
    return xyz_to_srgb(linear_rec2020_to_xyz(rgb2020))


def srgb_to_cieluv(rgb):
    return xyz_to_cieluv(srgb_to_xyz(rgb))


def cieluv_to_linear_rec2020(luv):
    return xyz_to_linear_rec2020(cieluv_to_xyz(luv))


def srgb_to_ictcp(rgb):
    return linear_rec2020_to_ictcp(srgb_to_linear_rec2020(rgb))


def cieluv_to_srgb(luv):
    return xyz_to_srgb(cieluv_to_xyz(luv))


def ictcp_to_srgb(ictcp):
    return linear_rec2020_to_srgb(ictcp_to_linear_rec2020(ictcp))


def srgb_to_lab(rgb):
    """sRGB -> CIELAB (D65), used by the saliency border prior.

    The reference delegates to skimage.color.rgb2lab
    (/root/reference/src/patolette/patolette.pyx:213); this is the standard
    closed-form CIELAB transform with the same D65 white.
    """
    x0, y0, z0 = _split(srgb_to_xyz(rgb))
    fwhite = lambda t: jnp.where(
        t > K_E, jnp.cbrt(t), (K_K * t + 16.0) / 116.0
    )
    fx = fwhite(x0 / D65_X)
    fy = fwhite(y0 / D65_Y)
    fz = fwhite(z0 / D65_Z)
    l = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return _join(rgb, l, a, b)


# --------------------------------------------------------------------------
# Pipeline dispatchers
# --------------------------------------------------------------------------

def srgb_to_working(rgb, color_space):
    """sRGB -> working space (reference patolette.c:201-207).

    ``color_space`` is a static int (ColorSpace value)."""
    cs = int(color_space)
    if cs == 1:  # CIELuv
        return srgb_to_cieluv(rgb)
    if cs == 2:  # ICtCp
        return srgb_to_ictcp(rgb)
    return rgb


def working_to_linear_rec2020(x, color_space):
    """Working space -> linear Rec2020 for dithering
    (reference patolette.c:274-287)."""
    cs = int(color_space)
    if cs == 1:
        return cieluv_to_linear_rec2020(x)
    if cs == 2:
        return ictcp_to_linear_rec2020(x)
    return srgb_to_linear_rec2020(x)


def working_to_ictcp(x, color_space):
    """Working space -> ICtCp for plain NN mapping.

    The reference documents NN mapping as always running in ICtCp
    (patolette.c:140) but its sRGB+no-dither path skips the conversion
    (quirk Q4, SURVEY.md section 7/H4); we always convert as documented.
    The CIELuv path follows the reference's exact chain
    Luv -> Rec2020 -> sRGB -> ICtCp (patolette.c:304-313).
    """
    cs = int(color_space)
    if cs == 1:
        return srgb_to_ictcp(linear_rec2020_to_srgb(cieluv_to_linear_rec2020(x)))
    if cs == 2:
        return x
    return srgb_to_ictcp(x)


def working_to_srgb(x, color_space):
    """Working space -> sRGB for final palette output."""
    cs = int(color_space)
    if cs == 1:
        return linear_rec2020_to_srgb(cieluv_to_linear_rec2020(x))
    if cs == 2:
        return linear_rec2020_to_srgb(ictcp_to_linear_rec2020(x))
    return x
