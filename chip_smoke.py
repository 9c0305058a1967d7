#!/usr/bin/env python
"""Bring-up smoke test: drive ``patolette_tpu.quantize`` end to end on a GPU.

Usage:
    python chip_smoke.py          # one card, phases 0-4
    python chip_smoke.py --four   # phase 0, then the mesh path on four cards

Phase 0  device: JAX's first device must be a GPU (no CPU fallback) and the
         native helper must load. Prints the device, the jax version and
         the card's name and power limit (nvidia-smi).
Phase 1  parity: CIELuv-MSE ratio of quantize() against the numpy f64
         reference (tests/ref_oracle.py) on three 512x512 fixtures at
         p = 64 and 256, each at most the CPU suite's CASE_TOL.
Phase 2  per-stage checks at real widths against numpy f64: colour-space
         round trips over all 2^24 uint8 codes, assign_planar, the segment
         moments, the 24-bit LUT, and the packed-u8 dither.
Phase 3  the four routes of quantize(), each asserted by its stage names
         (so a silent OOM retry or reroute fails), timed once warm.
Phase 4  the resident path's memory model against XLA's memory analysis
         of the compiled 4K map programs.

With ``--four`` only the mesh path runs: cases (a) and (b) of phase 3 with
``mesh=`` over four cards and then on one card, comparing CIELuv MSE.

Every check raises on failure, so the process exits non-zero and prints no
result. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Times printed here are single bring-up runs, not benchmark results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import patolette_tpu as pt  # noqa: E402
import ref_oracle  # noqa: E402
import test_parity_ref as T  # noqa: E402
from bench import (  # noqa: E402
    card_name_and_power_limit, device_record, synth_image, synth_image_u8,
)
from bench_suite import mse_luv  # noqa: E402
from patolette_tpu import native  # noqa: E402
from patolette_tpu.models import dither as D  # noqa: E402
from patolette_tpu.models import pipeline  # noqa: E402
from patolette_tpu.ops import colorspace as cs  # noqa: E402
from patolette_tpu.ops import lut as LUT  # noqa: E402
from patolette_tpu.ops import moments as M  # noqa: E402
from patolette_tpu.ops import wire  # noqa: E402
from patolette_tpu.ops.assign import assign_planar  # noqa: E402
from patolette_tpu.parallel.mesh import make_mesh  # noqa: E402

UHD = (3840, 2160)
PARITY_SIDE = 512
PARITY_PALETTES = (64, 256)
# assign_planar: argmin agreement with the f64 reference, and the largest
# distance gap of a disagreement, relative to the squared norms the
# expanded f32 distance is computed from (a gap that small is a tie).
ASSIGN_AGREE = 0.9999
ASSIGN_TIE_RTOL = 1e-5
# segment_moments: error relative to the sum of |terms| of each entry (the
# scale of f32 summation error); 1e-2 on the bf16 fast path.
MOMENTS_RTOL = {False: 1e-5, True: 1e-2}
# sRGB -> working -> sRGB over all codes: the CPU suite's 2e-3
# (tests/test_colorspace.py, which checks it at f64) holds for 99.9% of
# codes, and ROUNDTRIP_MAX for every code. At f32 the ICtCp inverse loses
# more on a few saturated codes with one channel near 0 (cancellation in
# the LMS -> sRGB matrices): 2.6e-3 worst on the CPU, 3.8e-3 on the H100,
# 1.5e-6 at f64. sRGB and CIELuv stay below 3e-5.
ROUNDTRIP_ATOL = 2e-3
ROUNDTRIP_QUANTILE = 0.999
ROUNDTRIP_MAX = 5e-3
DITHER_LUM_TOL = 1.15   # tests/test_native.py dither quality gate
# LUT vs direct NN map: the two compute each code's f32 ICtCp coordinates
# in different programs, which differ in the last bits (up to 1.3e-5 from
# the f64 value, Euclidean, over all codes on the CPU), so they may pick
# different entries at near-ties. A mismatch passes if moving the pixel by
# less than LUT_TIE_DIST (ICtCp units) would flip the exact f64 choice.
LUT_TIE_DIST = 2e-5
MESH_MSE_TOL = 1.02


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# Phase 0: device
# --------------------------------------------------------------------------

def phase0_device(platform: str = "gpu"):
    """The first JAX device, which must be on ``platform``; the native
    helper must load (the LUT host map silently falls back to numpy
    without it, and the smoke must run the designed path)."""
    dev = jax.devices()[0]
    require(dev.platform == platform,
            f"JAX's first device is {dev.platform} ({dev.device_kind}), "
            f"not {platform}")
    require(native.available(),
            f"native helper unavailable: {native.build_error()}")
    print(f"[phase 0] device {dev.platform} / {dev.device_kind} "
          f"x{len(jax.devices())}, jax {jax.__version__}", flush=True)
    return dev


# --------------------------------------------------------------------------
# Phase 1: parity against the numpy f64 reference
# --------------------------------------------------------------------------

def phase1_parity(side: int = PARITY_SIDE, palettes=PARITY_PALETTES):
    """CIELuv-MSE ratio vs tests/ref_oracle.py per fixture and palette."""
    fixtures = {
        "photo_like": T._photo_like(side, seed=0),
        "gradient_texture": T._gradient_texture(side),
        "gaussian_mixture": T._gaussian_mixture(side * side, seed=0),
    }
    ratios = {}
    for name, colors in fixtures.items():
        for p in palettes:
            r = T._ratio(colors, side, p, pt.ColorSpace_CIELuv, 0)
            ratios[f"{name}_p{p}"] = r
            print(f"[phase 1] {name} {side}x{side} p={p} CIELuv "
                  f"MSE ratio {r:.5f}", flush=True)
    worst = max(ratios, key=ratios.get)
    require(ratios[worst] <= T.CASE_TOL,
            f"parity: {worst} ratio {ratios[worst]:.5f} > {T.CASE_TOL}")
    return ratios


# --------------------------------------------------------------------------
# Phase 2: per-stage checks at real widths
# --------------------------------------------------------------------------

def _code_channels(codes):
    """24-bit codes -> (N, 3) uint8 pixels."""
    return np.stack(
        [(codes >> 16) & 0xFF, (codes >> 8) & 0xFF, codes & 0xFF], axis=-1
    ).astype(np.uint8)


def check_colorspace_roundtrip(step: int = 1):
    """sRGB -> working -> sRGB over every ``step``-th uint8 code, all three
    working spaces, planar f32 on device vs the exact input."""
    pix = _code_channels(np.arange(0, 1 << 24, step, dtype=np.uint32))
    ref = pix.astype(np.float64) / 255.0
    chans = wire.put_planar_image(pix)
    errs = {}
    for space in (0, 1, 2):
        back = jax.jit(
            lambda ch, s=space: jnp.stack(
                cs.working_to_srgb(cs.srgb_to_working(ch, s), s), axis=-1
            )
        )(chans)
        err = np.abs(np.asarray(back, np.float64) - ref).max(-1)
        q = float(np.quantile(err, ROUNDTRIP_QUANTILE))
        worst = np.argsort(err)[-3:][::-1]
        errs[space] = (q, float(err.max()))
        print(f"[phase 2] colour round trip space {space} over {len(pix)} "
              f"codes: {ROUNDTRIP_QUANTILE} quantile {q:.3e}, max "
              f"{err.max():.3e}, {int((err > ROUNDTRIP_ATOL).sum())} codes "
              f"> {ROUNDTRIP_ATOL}, worst {pix[worst].tolist()}", flush=True)
        require(q <= ROUNDTRIP_ATOL and err.max() <= ROUNDTRIP_MAX,
                f"round trip space {space}: quantile {q:.3e} (bound "
                f"{ROUNDTRIP_ATOL}), max {err.max():.3e} (bound "
                f"{ROUNDTRIP_MAX})")
    return errs


def _nn_reference(x, c, chunk=1 << 15):
    """Exact f64 nearest-centre index and squared distance table access."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c, np.float64)
    c2 = (c * c).sum(-1)
    labels = np.empty(len(x), np.int64)
    for i in range(0, len(x), chunk):
        xb = x[i:i + chunk]
        d = (xb * xb).sum(-1)[:, None] - 2.0 * xb @ c.T + c2[None, :]
        labels[i:i + chunk] = np.argmin(d, axis=-1)
    return labels


def check_assign(n: int, p: int = 256, seed: int = 0):
    """assign_planar over ``n`` pixels x ``p`` entries vs exact f64 argmin:
    agreement >= ASSIGN_AGREE and every disagreement a tie."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    xi = cs.srgb_to_ictcp(tuple(jnp.asarray(px[:, k]) for k in range(3)))
    pal = rng.uniform(0.05, 0.95, (p, 3)).astype(np.float32)
    pi = cs.srgb_to_ictcp(jnp.asarray(pal))
    ours = np.asarray(assign_planar(xi, pi))

    x = np.stack([np.asarray(v, np.float64) for v in xi], axis=-1)
    c = np.asarray(pi, np.float64)
    ref = _nn_reference(x, c)
    agree = float((ours == ref).mean())
    bad = np.flatnonzero(ours != ref)
    d_ours = ((x[bad] - c[ours[bad]]) ** 2).sum(-1)
    d_ref = ((x[bad] - c[ref[bad]]) ** 2).sum(-1)
    scale = (x[bad] ** 2).sum(-1) + (c[ours[bad]] ** 2).sum(-1)
    gap = float(((d_ours - d_ref) / scale).max()) if len(bad) else 0.0
    print(f"[phase 2] assign_planar {n} x {p}: agreement {agree:.7f}, "
          f"{len(bad)} disagreements, max relative gap {gap:.2e}",
          flush=True)
    require(agree >= ASSIGN_AGREE, f"assign agreement {agree} < {ASSIGN_AGREE}")
    require(gap <= ASSIGN_TIE_RTOL,
            f"assign disagreement gap {gap:.2e} > {ASSIGN_TIE_RTOL} (not a tie)")
    return agree, gap


def check_segment_moments(n: int, segments: int = 512, seed: int = 0):
    """segment_moments (weighted, mean-shifted) vs f64 bincount, full-f32
    and bf16 ``fast`` paths."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(-50, 100, (n, 3)).astype(np.float32)
    weights = rng.uniform(1, 5, n).astype(np.float32)
    ids = rng.integers(0, segments, n).astype(np.int32)
    shift = colors.mean(0)

    x = colors.astype(np.float64) - shift.astype(np.float64)
    w = weights.astype(np.float64)
    feats = np.stack([
        w, w * x[:, 0], w * x[:, 1], w * x[:, 2], w * (x * x).sum(-1),
        w * x[:, 0] * x[:, 0], w * x[:, 0] * x[:, 1], w * x[:, 0] * x[:, 2],
        w * x[:, 1] * x[:, 1], w * x[:, 1] * x[:, 2], w * x[:, 2] * x[:, 2],
    ], axis=-1)
    ref = np.stack([np.bincount(ids, f, segments) for f in feats.T], -1)
    scale = np.stack(
        [np.bincount(ids, np.abs(f), segments) for f in feats.T], -1
    )
    del feats

    args = (jnp.asarray(colors), jnp.asarray(ids), jnp.asarray(weights),
            jnp.asarray(shift))
    errs = {}
    for fast, rtol in MOMENTS_RTOL.items():
        ours = jax.jit(
            lambda c, i, wt, s, f=fast: M.segment_moments(
                c, i, segments, weights=wt, shift=s, fast=f)
        )(*args)
        rel = np.abs(np.asarray(ours, np.float64) - ref) / np.maximum(
            scale, 1e-30)
        errs[fast] = float(rel.max())
        print(f"[phase 2] segment_moments {n} -> {segments} fast={fast}: "
              f"max error / sum|terms| {errs[fast]:.2e}", flush=True)
        require(errs[fast] <= rtol,
                f"segment_moments fast={fast}: {errs[fast]:.2e} > {rtol}")
    return errs


def check_lut(p: int = 256, step: int = 1, seed: int = 0):
    """build_lut_device vs the direct NN map of the same uint8 pixels
    (every ``step``-th code): every mismatch must be a near-tie."""
    csp = 2
    rng = np.random.default_rng(seed)
    pal_work = cs.srgb_to_working(
        jnp.asarray(rng.uniform(0.05, 0.95, (p, 3)), jnp.float32), csp)
    valid = jnp.asarray([True] * (p - 1) + [False])
    lut = np.asarray(LUT.build_lut_device(pal_work, valid, csp, jnp.uint8))

    codes = np.arange(0, 1 << 24, step, dtype=np.uint32)
    pix = _code_channels(codes)
    pi = cs.working_to_ictcp(pal_work, csp)
    xw = cs.srgb_to_working(wire.put_planar_image(pix), csp)
    direct = np.asarray(assign_planar(cs.working_to_ictcp(xw, csp), pi,
                                      valid=valid))
    via_lut = lut[codes]
    bad = np.flatnonzero(via_lut != direct)
    x = ref_oracle.srgb_to_ictcp(pix[bad] / 255.0)
    c = np.asarray(pi, np.float64)
    r_lut = np.sqrt(((x - c[via_lut[bad]]) ** 2).sum(-1))
    r_dir = np.sqrt(((x - c[direct[bad]]) ** 2).sum(-1))
    flip = float((np.abs(r_lut - r_dir) / 2).max()) if len(bad) else 0.0
    print(f"[phase 2] LUT p={p} vs direct NN map over {len(codes)} codes: "
          f"{len(bad)} mismatches (agreement {1 - len(bad) / len(codes):.7f})"
          f", max flip distance {flip:.2e}", flush=True)
    require(flip <= LUT_TIE_DIST,
            f"LUT/direct mismatch is not a tie: flip distance {flip:.2e} > "
            f"{LUT_TIE_DIST}")
    return len(bad), flip


def check_dither(width: int, height: int, p: int = 256, seed: int = 0):
    """The packed-u8 dither against the exact serial native dither, held
    to the CPU suite's quality gate (mean luminance error)."""
    csp = 2
    img = synth_image_u8(width, height, seed=seed,
                         tile=min(1000, width, height))
    rng = np.random.default_rng(seed)
    pal_work = cs.srgb_to_working(
        jnp.asarray(rng.uniform(0, 1, (p, 3)), jnp.float32), csp)
    valid = jnp.ones((p,), bool)
    ours = np.asarray(D.riemersma_dither_packed_u8(
        wire.put_planar_raw(img), pal_work, valid, width, height, csp,
        segment=4096,
    ))

    img2020 = ref_oracle.srgb_to_linear_rec2020(img.astype(np.float64) / 255)
    pal2020 = np.asarray(cs.working_to_linear_rec2020(pal_work, csp),
                         np.float64)
    cw = np.array([D.R_WEIGHT, D.G_WEIGHT, D.B_WEIGHT])
    serial = native.riemersma_dither(img2020, width, height, pal2020, cw)

    def lum_err(out):
        return float(np.abs(((img2020 - pal2020[out]) * cw).sum(-1)).mean())

    e_ours, e_serial = lum_err(ours), lum_err(serial)
    print(f"[phase 2] packed-u8 dither {width}x{height} p={p}: luminance "
          f"error {e_ours:.6f} vs serial {e_serial:.6f} "
          f"(ratio {e_ours / e_serial:.4f})", flush=True)
    require(e_ours < DITHER_LUM_TOL * e_serial,
            f"dither luminance error {e_ours} >= {DITHER_LUM_TOL} x "
            f"{e_serial}")
    return e_ours, e_serial


def phase2_stages():
    w, h = UHD
    check_colorspace_roundtrip()
    check_assign(w * h)
    check_segment_moments(w * h)
    check_lut(256)
    check_dither(w, h)


# --------------------------------------------------------------------------
# Phase 3: the main path through quantize()
# --------------------------------------------------------------------------

FULL_UPLOAD = {"stage-in", "saliency", "gq-moments", "gq-dp", "lq", "kmeans",
               "dither"}
SAMPLE_LUT = {"sample-in", "palette+lut-build", "lut-pull", "lut-map-host"}
STRIP_DITHER = {"sample-in", "palette (device)", "dither"}
ONE_SHOT = {"stage-in", "one-shot"}
MESH_DITHER = {"stage-in", "saliency", "palette (sharded)", "dither"}
MESH_LUT = {"stage-in", "palette (sharded)", "nn-map"}


def route_cases(scale: int = 1):
    """Phase 3's cases: (name, width, height, input dtype, palette,
    quantize kwargs, expected single-device stages). ``scale`` shrinks
    every side (CPU rehearsals)."""
    w4, h4 = UHD[0] // scale, UHD[1] // scale
    side = 10000 // scale
    return [
        ("a_4k_defaults_full_upload", w4, h4, "float", 256,
         dict(dither=True, tile_size=512, kmeans_niter=32,
              color_space=pt.ColorSpace_ICtCp), FULL_UPLOAD),
        ("b_100mp_u8_sample_lut", side, side, "u8", 256,
         dict(dither=False, tile_size=0, kmeans_niter=25,
              color_space=pt.ColorSpace_ICtCp), SAMPLE_LUT),
        ("c_4k_u8_strip_dither", w4, h4, "u8", 256,
         dict(dither=True, tile_size=0, kmeans_niter=25,
              color_space=pt.ColorSpace_ICtCp), STRIP_DITHER),
        ("d_512_cieluv_one_shot", 512 // scale, 512 // scale, "u8", 256,
         dict(dither=False, tile_size=0, kmeans_niter=0,
              color_space=pt.ColorSpace_CIELuv), ONE_SHOT),
    ]


def make_image(width, height, kind):
    tile = min(1000, width, height)
    if kind == "u8":
        return synth_image_u8(width, height, tile=tile)
    return synth_image(width, height, tile=tile)


def run_case(name, width, height, colors, p, expect, mesh=None, **kw):
    """One warm-up call, then one timed call; asserts success, finite
    output of the right shape and the expected stage names."""
    def call():
        t0 = time.perf_counter()
        out = pt.quantize(width, height, colors, p, mesh=mesh, **kw)
        return out, time.perf_counter() - t0

    (ok, _, _, msg), warm_s = call()
    require(ok, f"{name}: warm-up failed: {msg}")
    (ok, pal, pmap, msg), wall_s = call()
    require(ok, f"{name}: {msg}")
    stages = dict(pipeline.LAST_STAGE_TIMES)
    require(set(stages) == expect,
            f"{name}: stages {sorted(stages)} != expected {sorted(expect)}")
    require(pal.shape == (p, 3) and np.isfinite(pal).all(),
            f"{name}: bad palette")
    live = pal[:, 0] >= 0
    require(pmap.shape == (width * height,) and pmap.dtype == np.int32
            and live[pmap].all(), f"{name}: bad palette map")
    mse = mse_luv(colors, pal, pmap)
    require(np.isfinite(mse), f"{name}: MSE {mse}")
    stats = jax.devices()[0].memory_stats() or {}
    rec = {
        "case": name, "pixels": width * height, "palette": p,
        "mesh_devices": 0 if mesh is None else int(mesh.devices.size),
        "warmup_s": warm_s, "wall_s": wall_s, "stages_ms": stages,
        "mse_luv_4mp": mse, "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    print(f"[phase 3] {json.dumps(rec)}", flush=True)
    return rec


def phase3_routes(scale: int = 1):
    recs = []
    for name, w, h, kind, p, kw, expect in route_cases(scale):
        recs.append(run_case(name, w, h, make_image(w, h, kind), p, expect,
                             **kw))
    return recs


# --------------------------------------------------------------------------
# Phase 4: memory model
# --------------------------------------------------------------------------

def phase4_memory(width: int = UHD[0], height: int = UHD[1], p: int = 256):
    """_device_footprint_bytes against XLA's memory analysis of the
    compiled full-upload map programs (dither and NN map), plus the sRGB
    planar channels the caller keeps alive beside them."""
    n = width * height
    ch = jax.ShapeDtypeStruct((n,), jnp.float32)
    pal = jax.ShapeDtypeStruct((p, 3), jnp.float32)
    valid = jax.ShapeDtypeStruct((p,), jnp.bool_)
    programs = {
        True: lambda chs, pw, v: D.riemersma_dither_planar(
            chs, pw, v, width, height, 2, segment=4096),
        False: lambda chs, pw, v: pipeline._nn_map_stage_planar(
            chs, pw, v, 2),
    }
    out = {}
    for dither, fn in programs.items():
        mem = jax.jit(fn).lower((ch, ch, ch), pal, valid).compile() \
            .memory_analysis()
        measured = (12 * n + mem.argument_size_in_bytes
                    + mem.output_size_in_bytes + mem.temp_size_in_bytes)
        est = pipeline._device_footprint_bytes(n, dither)
        print(f"[phase 4] {'dither' if dither else 'nn-map'} {width}x{height}:"
              f" memory_analysis argument {mem.argument_size_in_bytes} "
              f"output {mem.output_size_in_bytes} temp "
              f"{mem.temp_size_in_bytes} (+ 12n held sRGB) = {measured}; "
              f"estimate {est} ({est / measured:.3f}x)", flush=True)
        out[dither] = (est, measured)
    for dither, (est, measured) in out.items():
        require(est >= measured, f"footprint estimate {est} < measured "
                                 f"{measured} (dither={dither})")
    return out


# --------------------------------------------------------------------------
# --four: the mesh path
# --------------------------------------------------------------------------

def _record_shard_devices(seen):
    """Wrap the two pulls the mesh route's maps leave the devices through,
    recording how many devices each pulled array spanned."""
    orig_map, orig_lut = wire.get_palette_map, LUT.pull_lut_sharded

    def get_palette_map(pmap_dev, palette_size):
        seen.append(len(pmap_dev.sharding.device_set))
        return orig_map(pmap_dev, palette_size)

    def pull_lut_sharded(enc, lut_sharded, n_shards):
        seen.append(len(enc.sharding.device_set))
        return orig_lut(enc, lut_sharded, n_shards)

    wire.get_palette_map, LUT.pull_lut_sharded = get_palette_map, \
        pull_lut_sharded
    return lambda: (setattr(wire, "get_palette_map", orig_map),
                    setattr(LUT, "pull_lut_sharded", orig_lut))


def run_mesh(n_devices: int = 4, scale: int = 1):
    """Cases (a) and (b) with ``mesh=`` over ``n_devices`` and then on one
    device; the sharded route must run on all of them and lose at most
    MESH_MSE_TOL in CIELuv MSE."""
    devices = jax.devices()
    require(len(devices) >= n_devices,
            f"--four needs {n_devices} devices, JAX sees {len(devices)}")
    mesh = make_mesh(devices[:n_devices])
    cases = {c[0]: c for c in route_cases(scale)}
    out = []
    for key, mesh_stages in (("a_4k_defaults_full_upload", MESH_DITHER),
                             ("b_100mp_u8_sample_lut", MESH_LUT)):
        name, w, h, kind, p, kw, single_stages = cases[key]
        colors = make_image(w, h, kind)
        seen: list[int] = []
        restore = _record_shard_devices(seen)
        try:
            sharded = run_case(f"{name}_mesh{n_devices}", w, h, colors, p,
                               mesh_stages, mesh=mesh, **kw)
        finally:
            restore()
        require(seen and all(s == n_devices for s in seen),
                f"{name}: map shards came from {seen} devices, "
                f"not {n_devices}")
        single = run_case(name, w, h, colors, p, single_stages, **kw)
        ratio = sharded["mse_luv_4mp"] / single["mse_luv_4mp"]
        print(f"[mesh] {name}: MSE {n_devices}-device / 1-device = "
              f"{ratio:.5f}", flush=True)
        require(ratio <= MESH_MSE_TOL,
                f"{name}: mesh MSE ratio {ratio:.5f} > {MESH_MSE_TOL}")
        out.append((sharded, single, ratio))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path on four cards")
    args = ap.parse_args(argv)


    dev = phase0_device("gpu")
    print(f"nvidia-smi: {card_name_and_power_limit()}", flush=True)
    if args.four:
        run_mesh(4)
        count = 4
    else:
        phase1_parity()
        phase2_stages()
        phase3_routes()
        phase4_memory()
        count = 1
    print(json.dumps({"ok": True, "device": device_record(dev, count)}))


if __name__ == "__main__":
    main()
