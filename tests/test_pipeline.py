"""End-to-end quantize() tests: API parity, quality, properties."""

import numpy as np
import pytest

import patolette_tpu as pt


def _posterized_image(w=64, h=64, k=5, seed=0):
    """Image with k exact colors => a k-palette must reproduce it."""
    rng = np.random.default_rng(seed)
    palette = rng.uniform(0.05, 0.95, size=(k, 3))
    idx = rng.integers(0, k, size=(h * w))
    return palette[idx], palette, idx


def _natural_image(w=96, h=64, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
            0.5 + 0.45 * np.cos(xx / 17.0),
            np.clip(yy / h + 0.08 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).reshape(-1, 3)


def _mse_luv(colors_srgb, palette_srgb, pmap):
    from patolette_tpu.ops import colorspace as cs

    a = np.asarray(cs.srgb_to_cieluv(colors_srgb))
    b = np.asarray(cs.srgb_to_cieluv(palette_srgb))[pmap]
    return float(((a - b) ** 2).sum(-1).mean())


class TestValidation:
    def test_bad_channels(self):
        ok, _, _, msg = pt.quantize(2, 2, np.zeros((4, 4)), 4)
        assert not ok and "Channel count" in msg

    def test_count_mismatch(self):
        ok, _, _, msg = pt.quantize(2, 2, np.zeros((5, 3)), 4)
        assert not ok and "doesn't match" in msg

    def test_bad_dims(self):
        ok, _, _, msg = pt.quantize(0, 2, np.zeros((0, 3)), 4)
        assert not ok and "greater than 0" in msg

    def test_bad_palette(self):
        ok, _, _, msg = pt.quantize(2, 2, np.zeros((4, 3)), 0)
        assert not ok and "Palette size" in msg

    def test_bad_tile_size(self):
        ok, _, _, msg = pt.quantize(
            2, 2, np.zeros((4, 3)), 2, tile_size=-1.0
        )
        assert not ok and "tile_size" in msg

    def test_internal_error_returns_bad_quant(self, monkeypatch):
        """Fault injection: a device/runtime failure mid-pipeline surfaces
        as the reference's typed -1 contract (False, None, None, message)
        instead of a raw traceback (patolette.c:26-38,219-225)."""
        from patolette_tpu.models import pipeline
        from patolette_tpu.utils import errors

        def boom(*a, **kw):
            raise RuntimeError("injected device failure")

        # small images route through the one-shot program, large through
        # the staged bucket stage — fail both entry points
        monkeypatch.setattr(pipeline, "_gq_bucket_stage", boom)
        monkeypatch.setattr(pipeline, "_one_shot_program", boom)
        colors, _, _ = _posterized_image()
        ok, pal, pmap, msg = pt.quantize(
            64, 64, colors, 8, dither=False, tile_size=0, kmeans_niter=0
        )
        assert ok is False and pal is None and pmap is None
        assert msg.startswith(
            errors.exit_code_message(errors.ExitCode.BAD_QUANT)
        )
        assert "injected device failure" in msg

    def test_validation_errors_not_wrapped(self):
        """Validation failures keep their specific messages — only internal
        failures collapse to the -1 message."""
        ok, _, _, msg = pt.quantize(0, 2, np.zeros((0, 3)), 4)
        assert not ok and "Internal" not in msg


class TestOneShotPath:
    """Small images route through the single-program path (VERDICT r3 next
    #3); it must agree with the staged multi-sync path."""

    def _both(self, colors, w, h, p, monkeypatch, **kw):
        res_one = pt.quantize(w, h, colors, p, **kw)
        monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
        res_staged = pt.quantize(w, h, colors, p, **kw)
        monkeypatch.delenv("PATOLETTE_NO_ONE_SHOT")
        return res_one, res_staged

    def test_agrees_with_staged(self, monkeypatch):
        colors = _natural_image()
        (ok1, pal1, map1, _), (ok2, pal2, map2, _) = self._both(
            colors, 96, 64, 24, monkeypatch,
            dither=False, tile_size=0, kmeans_niter=4,
        )
        assert ok1 and ok2
        # device f32 DP vs host f64 DP: identical except at f32 ties
        np.testing.assert_allclose(pal1, pal2, atol=2e-3)
        assert (map1 == map2).mean() > 0.999

    def test_agrees_with_staged_saliency_dither(self, monkeypatch):
        colors = _natural_image()
        (ok1, pal1, map1, _), (ok2, pal2, map2, _) = self._both(
            colors, 96, 64, 16, monkeypatch,
            dither=True, tile_size=256, kmeans_niter=0,
            color_space=pt.ColorSpace_CIELuv,
        )
        assert ok1 and ok2
        np.testing.assert_allclose(pal1, pal2, atol=2e-3)
        assert (map1 == map2).mean() > 0.99


class TestExactRecovery:
    @pytest.mark.parametrize("space", [
        pt.ColorSpace_sRGB, pt.ColorSpace_CIELuv, pt.ColorSpace_ICtCp
    ])
    def test_posterized_all_spaces(self, space):
        colors, true_pal, idx = _posterized_image(k=5)
        ok, pal, pmap, msg = pt.quantize(
            64, 64, colors, 8, dither=False, color_space=space,
            tile_size=0, kmeans_niter=0,
        )
        assert ok, msg
        # 5 used entries, 3 filled with -1
        used = pal[pal[:, 0] >= 0]
        assert len(used) == 5
        # every true color recovered
        for c in true_pal:
            assert np.min(np.abs(used - c).sum(-1)) < 5e-3
        # map reproduces the image
        recon = pal[pmap]
        np.testing.assert_allclose(recon, colors, atol=5e-3)

    def test_palette_only(self):
        colors, _, _ = _posterized_image()
        ok, pal, pmap, _ = pt.quantize(
            64, 64, colors, 8, palette_only=True, tile_size=0,
            kmeans_niter=0, dither=False,
        )
        assert ok and pmap is None and pal.shape == (8, 3)

    def test_unused_fill(self):
        colors, _, _ = _posterized_image(k=3)
        ok, pal, _, _ = pt.quantize(
            64, 64, colors, 16, dither=False, tile_size=0, kmeans_niter=0
        )
        assert ok
        assert np.all(pal[(pal[:, 0] < 0)] == -1.0)
        assert (pal[:, 0] >= 0).sum() == 3


class TestQuality:
    def test_kmeans_improves_mse(self):
        colors = _natural_image()
        common = dict(dither=False, tile_size=0,
                      color_space=pt.ColorSpace_CIELuv)
        ok1, pal1, map1, _ = pt.quantize(96, 64, colors, 16,
                                         kmeans_niter=0, **common)
        ok2, pal2, map2, _ = pt.quantize(96, 64, colors, 16,
                                         kmeans_niter=25, **common)
        assert ok1 and ok2
        m1 = _mse_luv(colors, np.clip(pal1, 0, 1), map1)
        m2 = _mse_luv(colors, np.clip(pal2, 0, 1), map2)
        assert m2 <= m1 * 1.05  # refinement should not hurt

    def test_more_colors_less_error(self):
        colors = _natural_image(seed=3)
        common = dict(dither=False, tile_size=0, kmeans_niter=8)
        _, pal8, map8, _ = pt.quantize(96, 64, colors, 8, **common)
        _, pal64, map64, _ = pt.quantize(96, 64, colors, 64, **common)
        m8 = _mse_luv(colors, np.clip(pal8, 0, 1), map8)
        m64 = _mse_luv(colors, np.clip(pal64, 0, 1), map64)
        assert m64 < m8

    def test_weights_shift_palette(self):
        """Upweighted region's colors gain palette share (SURVEY 4.4)."""
        rng = np.random.default_rng(7)
        a = np.clip(rng.normal(0.25, 0.05, (2048, 3)), 0, 1)
        b = np.clip(rng.normal(0.75, 0.05, (2048, 3)), 0, 1)
        colors = np.concatenate([a, b])
        w = np.concatenate([np.full(2048, 50.0), np.ones(2048)])
        common = dict(dither=False, tile_size=0, kmeans_niter=10,
                      color_space=pt.ColorSpace_sRGB)
        ok, pal_w, _, _ = pt.quantize(64, 64, colors, 8, weights=w, **common)
        assert ok
        used = pal_w[pal_w[:, 0] >= 0]
        near_a = (np.abs(used - 0.25).mean(-1) < 0.15).sum()
        near_b = (np.abs(used - 0.75).mean(-1) < 0.15).sum()
        assert near_a > near_b


class TestDitherPath:
    def test_dither_runs_and_uses_palette(self):
        colors = _natural_image()
        ok, pal, pmap, _ = pt.quantize(
            96, 64, colors, 16, dither=True, tile_size=0, kmeans_niter=4,
        )
        assert ok
        assert pmap.shape == (96 * 64,)
        used = np.unique(pmap)
        assert np.all(pal[used][:, 0] >= 0)

    def test_dither_mse_reasonable(self):
        colors = _natural_image(seed=9)
        common = dict(tile_size=0, kmeans_niter=8)
        _, pal_n, map_n, _ = pt.quantize(96, 64, colors, 32,
                                         dither=False, **common)
        _, pal_d, map_d, _ = pt.quantize(96, 64, colors, 32,
                                         dither=True, **common)
        m_n = _mse_luv(colors, np.clip(pal_n, 0, 1), map_n)
        m_d = _mse_luv(colors, np.clip(pal_d, 0, 1), map_d)
        # dithering trades MSE for visual quality but must stay in the
        # same ballpark
        assert m_d < m_n * 6 + 10


class TestSaliencyPath:
    def test_saliency_default_runs(self):
        colors = _natural_image()
        ok, pal, pmap, _ = pt.quantize(
            96, 64, colors, 8, dither=False, kmeans_niter=2
        )
        assert ok and pmap is not None

    def test_tiny_image_skips_saliency(self):
        colors = np.random.default_rng(0).uniform(0, 1, (6, 3))
        ok, pal, pmap, _ = pt.quantize(
            3, 2, colors, 2, dither=False, kmeans_niter=0
        )
        assert ok


class TestUint8Input:
    """uint8 sRGB input (extension: quarter-width transfers)."""

    def test_uint8_matches_float(self):
        colors_f = _natural_image(seed=4)
        colors_u8 = np.round(colors_f * 255.0).astype(np.uint8)
        common = dict(dither=False, tile_size=0, kmeans_niter=4)
        ok_f, pal_f, map_f, _ = pt.quantize(
            96, 64, colors_u8.astype(np.float64) / 255.0, 16, **common
        )
        ok_u, pal_u, map_u, _ = pt.quantize(96, 64, colors_u8, 16, **common)
        assert ok_f and ok_u
        assert map_u.dtype == np.int32
        np.testing.assert_allclose(pal_u, pal_f, atol=1e-5)
        assert np.mean(map_u == map_f) > 0.999

    def test_uint8_saliency_and_dither(self):
        colors_u8 = np.round(_natural_image(seed=5) * 255.0).astype(np.uint8)
        ok, pal, pmap, _ = pt.quantize(
            96, 64, colors_u8, 16, dither=True, kmeans_niter=2
        )
        assert ok and pmap is not None and pmap.dtype == np.int32
        used = pal[:, 0] >= 0
        assert np.all(np.isin(pmap, np.flatnonzero(used)))

    def test_large_palette_map_dtype(self):
        # palette > 256 exercises the uint16 wire path
        colors = _natural_image(seed=6)
        ok, pal, pmap, _ = pt.quantize(
            96, 64, colors, 300, dither=False, tile_size=0, kmeans_niter=0
        )
        assert ok and pmap.dtype == np.int32 and pal.shape == (300, 3)


def test_large_palette_1024_end_to_end():
    """p=1024 exercises the LQ bsz cap (~132 fori rounds), the u16 map
    wire, and quality monotonicity vs a small palette (VERDICT r4 next
    #6 — the large-palette regime was previously uncompiled)."""
    rng = np.random.default_rng(41)
    side = 96
    # continuous gradient + noise: far more than 1024 distinct colors
    yy, xx = np.mgrid[0:side, 0:side] / side
    img = np.stack([
        xx, yy, 0.5 + 0.45 * np.sin(6.0 * xx) * np.cos(5.0 * yy)
    ], axis=-1)
    img = np.clip(img + 0.02 * rng.standard_normal(img.shape), 0, 1)
    img8 = np.round(img.reshape(-1, 3) * 255).astype(np.uint8)

    ok, pal, pmap, msg = pt.quantize(
        side, side, img8, 1024, dither=False, tile_size=0, kmeans_niter=4,
    )
    assert ok, msg
    assert pal.shape == (1024, 3)
    live = np.flatnonzero(pal[:, 0] >= 0)
    assert len(live) > 256  # the LQ loop really went past the u8 regime
    assert pmap.dtype == np.int32 and pmap.max() < 1024
    assert np.isin(np.unique(pmap), live).all()

    ok2, pal2, pmap2, _ = pt.quantize(
        side, side, img8, 64, dither=False, tile_size=0, kmeans_niter=4,
    )
    assert ok2
    x = img8 / 255.0
    mse_1024 = np.mean((np.clip(pal, 0, 1)[pmap] - x) ** 2)
    mse_64 = np.mean((np.clip(pal2, 0, 1)[pmap2] - x) ** 2)
    assert mse_1024 < 0.5 * mse_64


@pytest.mark.parametrize("name,w,h,p,kw", [
    ("1x1_p1_dither", 1, 1, 1, dict(dither=True, tile_size=0,
                                    kmeans_niter=0)),
    ("8x1_p2_dither", 8, 1, 2, dict(dither=True, tile_size=0,
                                    kmeans_niter=0)),
    ("1x8_p2_dither", 1, 8, 2, dict(dither=True, tile_size=0,
                                    kmeans_niter=0)),
    ("2x2_p1_saliency", 2, 2, 1, dict(dither=False, tile_size=512,
                                      kmeans_niter=4)),
    ("5x3_p16_sal_dither", 5, 3, 16, dict(dither=True, tile_size=512,
                                          kmeans_niter=2)),
])
def test_degenerate_shapes(name, w, h, p, kw):
    """The reference accepts any w, h, palette_size >= 1 (patolette.c:78-94);
    every routing path must survive single-pixel / single-row / single-
    column images and p=1 (r5 edge battery)."""
    rng = np.random.default_rng(hash(name) % 2**31)
    colors = rng.uniform(0, 1, (w * h, 3))
    ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw)
    assert ok, msg
    assert pal.shape == (p, 3)
    assert pmap.shape == (w * h,)
    live = np.flatnonzero(pal[:, 0] >= 0)
    assert len(live) >= 1
    assert np.isin(np.unique(pmap), live).all()


def test_routing_combination_fuzz():
    """Seeded fuzz over the routing-relevant config lattice: every
    combination must return ok=True with a valid palette/map (or a typed
    -1, never a raise). Catches cross-path regressions the per-path
    tests miss (r5; ~24 sampled combos)."""
    rng = np.random.default_rng(1234)
    for trial in range(24):
        w = int(rng.integers(1, 70))
        h = int(rng.integers(1, 70))
        p = int(rng.choice([1, 2, 7, 16, 300]))
        dtype_u8 = bool(rng.integers(0, 2))
        colors = rng.uniform(0, 1, (w * h, 3))
        if dtype_u8:
            colors = (colors * 255).astype(np.uint8)
        kw = dict(
            dither=bool(rng.integers(0, 2)),
            palette_only=bool(rng.integers(0, 2)),
            tile_size=int(rng.choice([0, 256])),
            kmeans_niter=int(rng.choice([0, 3])),
            color_space=int(rng.integers(0, 3)),
            lq_max_samples=int(rng.choice([0, 512, 1 << 18])),
            dither_segment=int(rng.choice([0, 64, 4096])),
        )
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw)
        ctx = f"trial {trial}: {w}x{h} p={p} u8={dtype_u8} {kw}"
        assert ok, f"{ctx}: {msg}"
        assert pal.shape == (p, 3), ctx
        live = np.flatnonzero(pal[:, 0] >= 0)
        assert len(live) >= 1, ctx
        if kw["palette_only"]:
            assert pmap is None, ctx
        else:
            assert pmap.shape == (w * h,) and pmap.dtype == np.int32, ctx
            assert np.isin(np.unique(pmap), live).all(), ctx


def test_negative_dims_rejected():
    """width/height must each be >= 1 — a negative pair with a positive
    product must not sail through (r5 review finding)."""
    colors = np.zeros((36, 3))
    ok, pal, pmap, msg = pt.quantize(-4, -9, colors, 4)
    assert ok is False and pal is None and pmap is None
    assert "greater than 0" in msg
