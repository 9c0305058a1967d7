"""chip_smoke.py's own logic on the CPU, at tiny sizes.

These check the smoke's device gate and its comparison and routing
checks, not the GPU: the phase functions are called directly, without the
phase-0 GPU gate, and route thresholds are shrunk so tiny images take the
routes the full sizes take on the card.
"""

import json

import jax
import numpy as np
import pytest

import chip_smoke as C
from patolette_tpu.models import pipeline

# sides shrink by SCALE: 4K -> 192x108 (108 rows split over 4 devices),
# 100 MP -> 500x500, 512^2 -> 25x25
SCALE = 20


@pytest.fixture
def tiny_routes(monkeypatch):
    monkeypatch.setattr(pipeline, "ONE_SHOT_MAX_PIXELS", 25 * 25)
    monkeypatch.setattr(pipeline, "LUT_MIN_PIXELS", 100_000)


class TestDeviceGate:
    def test_raises_on_the_cpu_backend(self):
        with pytest.raises(AssertionError, match="not gpu"):
            C.phase0_device("gpu")

    def test_passes_on_the_platform_it_is_given(self):
        assert C.phase0_device("cpu").platform == "cpu"

    def test_main_fails_without_gpu_and_prints_no_result(self, capsys):
        with pytest.raises(AssertionError):
            C.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestComparisons:
    def test_parity_ratios(self):
        ratios = C.phase1_parity(side=48, palettes=(16,))
        assert len(ratios) == 3
        assert all(0.5 < r < 1.055 for r in ratios.values())

    def test_colorspace_roundtrip(self):
        errs = C.check_colorspace_roundtrip(step=4099)
        for q, worst in errs.values():
            assert q <= C.ROUNDTRIP_ATOL and worst <= C.ROUNDTRIP_MAX

    def test_assign_agrees_with_f64(self):
        agree, gap = C.check_assign(20_000, p=64)
        assert agree >= C.ASSIGN_AGREE and gap <= C.ASSIGN_TIE_RTOL

    def test_assign_check_rejects_wrong_labels(self, monkeypatch):
        orig = C.assign_planar
        monkeypatch.setattr(C, "assign_planar",
                            lambda *a, **k: (orig(*a, **k) + 1) % 64)
        with pytest.raises(AssertionError, match="assign"):
            C.check_assign(2_000, p=64)

    def test_segment_moments_both_paths(self):
        errs = C.check_segment_moments(30_000, segments=64)
        assert errs[False] <= 1e-5 and errs[True] <= 1e-2

    def test_lut_mismatches_are_ties(self):
        mismatches, flip = C.check_lut(8, step=97)
        assert flip <= C.LUT_TIE_DIST

    def test_dither_quality_gate(self):
        ours, serial = C.check_dither(96, 64, p=16)
        assert ours < C.DITHER_LUM_TOL * serial

    def test_memory_model_covers_measurement(self):
        for est, measured in C.phase4_memory(256, 128).values():
            assert est >= measured


class TestRoutes:
    @pytest.mark.parametrize("index", range(4))
    def test_each_case_takes_its_route(self, tiny_routes, index, capsys):
        name, w, h, kind, p, kw, expect = C.route_cases(SCALE)[index]
        rec = C.run_case(name, w, h, C.make_image(w, h, kind), p, expect,
                         **kw)
        assert rec["stages_ms"].keys() == expect
        printed = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(printed.split("] ", 1)[1])["case"] == name

    def test_reroute_fails_the_case(self, tiny_routes):
        name, w, h, kind, p, kw, _ = C.route_cases(SCALE)[3]
        with pytest.raises(AssertionError, match="stages"):
            C.run_case(name, w, h, C.make_image(w, h, kind), p,
                       C.FULL_UPLOAD, **kw)

    def test_mesh_path_on_four_virtual_devices(self, tiny_routes):
        assert len(jax.devices()) >= 4
        out = C.run_mesh(4, scale=SCALE)
        assert len(out) == 2
        for sharded, single, ratio in out:
            assert sharded["mesh_devices"] == 4
            assert single["mesh_devices"] == 0
            assert ratio <= C.MESH_MSE_TOL

    def test_silent_single_device_fallback_fails_the_case(self,
                                                           tiny_routes):
        # 2500 pixels do not divide over three devices: quantize() drops
        # the mesh and runs on one device, which the smoke must refuse
        mesh = C.make_mesh(jax.devices()[:3])
        with pytest.raises(AssertionError, match="stages"):
            C.run_case("fallback", 50, 50, C.make_image(50, 50, "u8"), 16,
                       C.MESH_LUT, mesh=mesh, dither=False, tile_size=0,
                       kmeans_niter=0)

    def test_shard_recorder_restores_the_pulls(self):
        from patolette_tpu.ops import lut as LUT
        from patolette_tpu.ops import wire

        before = (wire.get_palette_map, LUT.pull_lut_sharded)
        restore = C._record_shard_devices([])
        assert wire.get_palette_map is not before[0]
        restore()
        assert (wire.get_palette_map, LUT.pull_lut_sharded) == before

    def test_route_images(self):
        u8 = C.make_image(30, 20, "u8")
        f = C.make_image(30, 20, "float")
        assert u8.shape == f.shape == (600, 3)
        assert u8.dtype == np.uint8 and f.dtype == np.float32
        assert 0.0 <= f.min() and f.max() <= 1.0
