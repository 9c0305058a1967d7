#!/usr/bin/env python
"""Full BASELINE-config benchmark suite (SURVEY.md §7 stage 10).

Runs the five BASELINE.md configs on one GPU and prints one JSON object per
config: wall time, MP/s, and the CIELuv MSE of the delivered mapping, each
with the device it ran on. ``bench.py`` stays the single-line headline
bench; this suite is the broad table. Fails without a GPU.

Usage: python bench_suite.py [--quick] [--trace DIR]
  --quick      shrink images 4x
  --trace DIR  capture one jax.profiler trace per config under DIR/<name>
               (SURVEY.md section 5; open with tensorboard or xprof)
"""

import json
import sys
import time

import numpy as np

from bench import (
    card_name_and_power_limit, device_record, require_gpu, synth_image_u8,
)

TRACE_DIR = None


def synth_image(w, h, seed=0):
    """uint8 sRGB test image (the 8-bit format, like bench.py); tiled
    texture + full-size gradient so large sizes synthesize fast."""
    return synth_image_u8(w, h, seed=seed, tile=min(1000, w, h))


def mse_luv(colors, palette, pmap, cap=1 << 22):
    """Diagnostic CIELuv MSE on a seeded <= 4 MP subsample.

    ``colors``: (N, 3) uint8 or float sRGB in [0, 1]. The subsample keeps
    the transfer and transform cost flat across image sizes for a number
    whose sampling error at 4 MP is < 0.1%."""
    from patolette_tpu.ops import colorspace as cs

    if len(colors) > cap:
        idx = np.random.default_rng(0).integers(0, len(colors), size=cap)
        colors, pmap = colors[idx], pmap[idx]
    if colors.dtype == np.uint8:
        colors = colors.astype(np.float32) / 255.0
    colors = colors.astype(np.float32)
    a = np.asarray(cs.srgb_to_cieluv(colors))
    b = np.asarray(cs.srgb_to_cieluv(np.clip(palette, 0, 1)))[pmap]
    return float(((a - b) ** 2).sum(-1).mean())


def run_config(name, w, h, palette, reps=4, **kw):
    import jax

    import patolette_tpu as pt

    colors = synth_image(w, h)

    def once():
        ok, pal, pmap, msg = pt.quantize(w, h, colors, palette, **kw)
        assert ok, msg
        return pal, pmap

    from patolette_tpu.models import pipeline

    t0 = time.perf_counter()
    pal, pmap = once()  # warm-up/compile
    warmup = time.perf_counter() - t0
    times, laps = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        pal, pmap = once()
        times.append(time.perf_counter() - t0)
        laps.append(dict(pipeline.LAST_STAGE_TIMES))
    med_i = int(np.argsort(times)[len(times) // 2])
    wall = times[med_i]
    stages = laps[med_i]

    # One extra diagnostic pass with sync-staged laps: async laps bill
    # device work to the next host sync, so without this the committed
    # artifact misattributes stage time (VERDICT r3 weak #5). The sync pass
    # is NOT the headline wall (the per-stage pulls break async
    # pipelining); sync_lap_sum ~~ sync_wall by construction.
    prev = pipeline.set_sync_stages(True)
    try:
        # twice, keep the faster: the first sync pass may compile the
        # per-shape 1-element pull programs
        sync_wall, stages_sync = None, None
        for _ in range(2):
            t0 = time.perf_counter()
            once()
            wall = time.perf_counter() - t0
            if sync_wall is None or wall < sync_wall:
                sync_wall = wall
                stages_sync = dict(pipeline.LAST_STAGE_TIMES)
    finally:
        pipeline.set_sync_stages(prev)

    if TRACE_DIR:
        # one profiler trace per config
        with jax.profiler.trace(f"{TRACE_DIR}/{name}"):
            once()

    rec = {
        "config": name,
        "device": device_record(jax.devices()[0], 1),
        "pixels": w * h,
        "palette": palette,
        "wall_s_median": wall,
        "wall_s_all": times,
        "mp_per_s": w * h / 1e6 / wall,
        "mse_luv": mse_luv(colors, pal, pmap) if pmap is not None else None,
        "warmup_s": warmup,
        "stages_ms_async": stages,
        "stages_ms_sync": stages_sync,
        "sync_wall_s": sync_wall,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    global TRACE_DIR
    quick = "--quick" in sys.argv
    if "--trace" in sys.argv:
        i = sys.argv.index("--trace")
        if i + 1 >= len(sys.argv) or sys.argv[i + 1].startswith("-"):
            sys.exit("--trace requires a directory operand")
        TRACE_DIR = sys.argv[i + 1]
    s = 4 if quick else 1
    import jax

    dev = require_gpu()
    print(f"device: {dev.device_kind} x{len(jax.devices())}, "
          f"jax {jax.__version__}", flush=True)
    print(f"nvidia-smi: {card_name_and_power_limit()}", flush=True)

    # Config 1: 512x512 -> 256 colors, CIELuv, no dither, no KMeans
    run_config(
        "1_512_cieluv_plain", 512 // s, 512 // s, 256,
        dither=False, tile_size=0, kmeans_niter=0, color_space=1,
    )
    # Config 2: 4K -> 256 colors, ICtCp + saliency
    run_config(
        "2_4k_ictcp_saliency", 3840 // s, 2160 // s, 256,
        dither=False, tile_size=512, kmeans_niter=0, color_space=2,
    )
    # Config 3: 4K + 25-iter KMeans
    run_config(
        "3_4k_kmeans25", 3840 // s, 2160 // s, 256,
        dither=False, tile_size=0, kmeans_niter=25, color_space=2,
    )
    # Config 4: 4K + error-diffusion dither
    run_config(
        "4_4k_dither", 3840 // s, 2160 // s, 256,
        dither=True, tile_size=0, kmeans_niter=25, color_space=2,
    )
    # Config 5: 100 MP on one card (the sharded path is exercised on the
    # virtual mesh in tests/test_quantize_mesh.py and by chip_smoke --four)
    run_config(
        "5_100mp_kmeans", 10000 // s, 10000 // s, 256, reps=2,
        dither=False, tile_size=0, kmeans_niter=25, color_space=2,
    )


if __name__ == "__main__":
    main()
