"""Every float matrix product in the device programs asks for full precision.

On a GPU a float32 ``dot_general`` left at the default precision may run in
TF32 (about 10 mantissa bits), which moves palette coordinates and
dither errors. This walks the jaxprs of the programs quantize() runs, at
tiny shapes, and requires ``Precision.HIGHEST`` on every ``dot_general``
whose operands are not bf16. The LQ bucket statistics use bf16 operands
on purpose (``ops/moments.py::segment_matmul(fast=True)``); their numerics
do not depend on the device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from patolette_tpu.models import dither as D
from patolette_tpu.models import pipeline as P
from patolette_tpu.models import saliency as S
from patolette_tpu.ops import lut as LUT

W, H, PAL = 24, 20, 16
N = W * H
_HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dots(sub, out)
    return out


def _unpinned(fn, *args):
    """dot_generals with a non-bf16 operand and less than HIGHEST."""
    bad = []
    for eqn in _dots(jax.make_jaxpr(fn)(*args).jaxpr, []):
        dtypes = {v.aval.dtype for v in eqn.invars}
        if dtypes == {jnp.dtype(jnp.bfloat16)}:
            continue
        if eqn.params["precision"] != _HIGHEST:
            bad.append(jax._src.source_info_util.summarize(eqn.source_info))
    return bad


def _chans(dtype=np.float32):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        return tuple(jnp.asarray(rng.integers(0, 256, N, dtype=np.uint8))
                     for _ in range(3))
    return tuple(jnp.asarray(rng.random(N).astype(dtype)) for _ in range(3))


def _palette():
    rng = np.random.default_rng(1)
    return (jnp.asarray(rng.random((PAL, 3)).astype(np.float32)),
            jnp.ones((PAL,), bool))


def _one_shot(dither):
    return lambda ch: P._one_shot_program(
        ch, None, width=W, height=H, p=PAL, csp=2, dither=dither,
        with_map=True, tile_size=8.0, kmeans_niter=2,
        kmeans_max_samples=4096, seed=1, lq_max_samples=0,
        lq_batch_splits=8, dither_segment=64,
    )


def _full_upload_programs():
    """The staged programs of the resident full-upload route, chained as
    _quantize_full_upload calls them (host GQ DP replaced by fixed cuts)."""
    def run(ch):
        w = S.get_weights_planar(ch, H, W, 8.0).reshape(-1)
        xw = P._to_working(ch, 2)
        x = jnp.stack(xw, axis=-1)
        buckets, bm = P._gq_bucket_stage(x)
        cuts = jnp.asarray([0, 256] + [512] * 12, jnp.int32)
        _, _, centers, valid = P._lq_stage(
            x, w, buckets, cuts, jnp.int32(1), PAL, batch_splits=8)
        centers = P._kmeans_stage_planar(xw, w, centers, valid, 2, 4096, 1)
        return (bm, P._nn_map_stage_planar(xw, centers, valid, 2),
                D.riemersma_dither_planar(xw, centers, valid, W, H, 2,
                                          segment=64))
    return run


def _dither_programs():
    pal, valid = _palette()
    return lambda ch, ch8: (
        D.riemersma_dither_planar(ch, pal, valid, W, H, 2, segment=64),
        D.riemersma_dither_packed_u8(ch8, pal, valid, W, H, 2, segment=64),
        D.riemersma_dither(jnp.stack(ch, -1), pal, valid, W, H, 2,
                           segment=64),
    )


def _sample_programs():
    pal, valid = _palette()

    def run(sub):
        centers, valid2, _ = P._sample_palette_program(
            sub, None, None, None, p=PAL, csp=2, kmeans_niter=2,
            kmeans_max_samples=4096, seed=1, lq_batch_splits=8)
        pi, c2 = LUT._palette_ictcp(centers, valid2, 2)
        grid = tuple(jnp.zeros((1, 64), jnp.float32) for _ in range(3))
        return LUT._argmin_lut(grid, pi, c2, jnp.uint8)
    return run


CASES = {
    "one_shot_dither": (_one_shot(True), lambda: (_chans(),)),
    "one_shot_nn_map": (_one_shot(False), lambda: (_chans(),)),
    "full_upload": (_full_upload_programs(), lambda: (_chans(),)),
    "dither_feeds": (_dither_programs(),
                     lambda: (_chans(), _chans(np.uint8))),
    "sample_palette_and_lut": (
        _sample_programs(),
        lambda: (jnp.asarray(np.random.default_rng(2).random((N, 3)),
                             jnp.float32),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_float_products_pinned_to_highest(name):
    fn, make_args = CASES[name]
    bad = _unpinned(fn, *make_args())
    assert not bad, f"float dot_general below HIGHEST at: {bad}"


def test_walk_sees_the_bf16_fast_path():
    """The LQ stage's bf16 segment matmul is found and exempted, so the
    walk really descends into the scan/while bodies."""
    dots = _dots(jax.make_jaxpr(_one_shot(False))(_chans()).jaxpr, [])
    dtypes = [{v.aval.dtype for v in e.invars} for e in dots]
    assert {jnp.dtype(jnp.bfloat16)} in dtypes
    assert any(d != {jnp.dtype(jnp.bfloat16)} for d in dtypes)


def test_walk_flags_a_default_precision_product():
    x = jnp.ones((4, 3), jnp.float32)
    assert _unpinned(lambda a: a @ a.T, x)
    assert not _unpinned(lambda a: jnp.dot(a, a.T, precision="highest"), x)
