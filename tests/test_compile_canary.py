"""Compile-size canary: the LQ program's CPU lowering+compile must stay
cheap. Accelerator compile cost tracks graph size; a blowup here flags a
structural regression (scan-in-vmap-in-cond nesting, unrolled candidates,
...) before it costs an hour on the GPU compiler."""

import time

import jax
import jax.numpy as jnp

from patolette_tpu.models import pipeline as P


def test_lq_program_compiles_quickly_on_cpu():
    n = 1 << 18
    xs = jax.ShapeDtypeStruct((n, 3), jnp.float32)
    bs = jax.ShapeDtypeStruct((n,), jnp.int32)
    cuts = jax.ShapeDtypeStruct((13,), jnp.int32)
    k0 = jax.ShapeDtypeStruct((), jnp.int32)
    t0 = time.perf_counter()
    lowered = P._lq_stage.lower(xs, None, bs, cuts, k0, 256)
    compiled = lowered.compile()
    dt = time.perf_counter() - t0
    assert compiled is not None
    assert dt < 180.0, f"LQ compile blew up: {dt:.0f}s on CPU"
