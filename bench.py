#!/usr/bin/env python
"""Benchmark: 256-color quantization of a 100 MP image on one GPU.

Prints the device, the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "device", ...}.

Config: 256 colors, 25-iteration weighted-KMeans refinement, ICtCp working
space, no dither, no saliency. The image enters as uint8 sRGB (the native
format of real 8-bit images) and the palette map returns as int32; it takes
the sample+LUT route (only the palette-stage subsamples go up, the map comes
back as one RLE-coded 24-bit LUT resolved on the host by the threaded native
pack+gather).

Fails without a GPU: a CPU timing is not a measurement of this system.
"""

import json
import subprocess
import time

import numpy as np

WIDTH, HEIGHT = 10000, 10000
PALETTE = 256
KMEANS_ITERS = 25
REPEATS = 5


def synth_image(w, h, seed=0, tile=1000):
    """(w*h, 3) float32 sRGB in [0, 1]: a texture synthesized on a small tile
    and tiled up, with a full-size vertical gradient + noise so the image is
    not k-colorable. Large sizes synthesize in seconds."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:tile, 0:tile].astype(np.float32)
    pat = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 97.0) * np.cos(yy / 131.0),
            0.5 + 0.45 * np.cos(xx / 177.0 + yy / 211.0),
            0.5 + 0.05 * rng.standard_normal((tile, tile)).astype(np.float32),
        ],
        axis=-1,
    )
    reps_y, reps_x = -(-h // tile), -(-w // tile)
    img = np.tile(pat, (reps_y, reps_x, 1))[:h, :w]
    img[:, :, 2] += np.linspace(-0.45, 0.45, h, dtype=np.float32)[:, None]
    return np.clip(img, 0, 1, out=img).reshape(-1, 3)


def synth_image_u8(w, h, seed=0, tile=1000):
    """:func:`synth_image` quantized to uint8."""
    return np.round(synth_image(w, h, seed, tile) * 255.0).astype(np.uint8)


def require_gpu():
    """The first JAX device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )
    return dev


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of every card, from nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_record(dev, count):
    return {"platform": dev.platform, "kind": dev.device_kind, "count": count}


def main():
    import jax

    import patolette_tpu as pt
    from patolette_tpu.models import pipeline
    from patolette_tpu import native

    dev = require_gpu()
    print(f"device: {dev.device_kind} x{len(jax.devices())}, "
          f"jax {jax.__version__}", flush=True)
    print(f"nvidia-smi: {card_name_and_power_limit()}", flush=True)

    colors = synth_image_u8(WIDTH, HEIGHT)

    def run():
        ok, pal, pmap, msg = pt.quantize(
            WIDTH, HEIGHT, colors, PALETTE,
            dither=False, tile_size=0, kmeans_niter=KMEANS_ITERS,
            color_space=pt.ColorSpace_ICtCp,
        )
        if not ok:
            raise RuntimeError(msg)
        return pal, pmap

    t0 = time.perf_counter()
    run()  # warm-up: compiles, or loads from the persistent cache
    warmup_s = time.perf_counter() - t0

    times, laps = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
        laps.append(dict(pipeline.LAST_STAGE_TIMES))

    med = float(np.median(times))
    print(json.dumps({
        "metric": "megapixels_per_sec_256color_100mp_kmeans25",
        "value": (WIDTH * HEIGHT) / 1e6 / med,
        "unit": "MP/s",
        "device": device_record(dev, 1),
        "wall_s_median": med,
        "wall_s_all": times,
        "warmup_s": warmup_s,
        "stages_ms": laps[int(np.argsort(times)[len(times) // 2])],
        "native_lut": native.available(),
    }))


if __name__ == "__main__":
    main()
