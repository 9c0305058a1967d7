"""Multi-host (multi-process) execution of the sharded pipeline.

The reference is strictly single-process (SURVEY.md section 2.3); this
module is the framework north-star analogue: the same ``shard_map``
pipeline as :mod:`patolette_tpu.parallel.mesh`, with the 1-D ``pixels``
mesh laid over EVERY process's devices so the moment/KMeans ``psum``s ride
the device interconnect within a host and the network across hosts. Only the ~11-float moment tuples
and the (P, 3) palette ever cross process boundaries.

Launch (one command per host, standard JAX multi-controller):

    # host 0 (also the coordinator)
    python -c "from patolette_tpu.parallel import distributed as D; \\
               D.init_distributed('host0:8476', 2, 0); ..."
    # host 1
    python -c "... D.init_distributed('host0:8476', 2, 1); ..."

Each process then builds the global mesh (:func:`make_global_mesh`),
feeds its LOCAL row strip (:func:`put_pixels_local`), and calls
:func:`quantize_palette_distributed`. Results: the palette is replicated
(pullable everywhere); the palette map is pixel-sharded, and each process
reads back its own rows (:func:`local_shard`).

CI exercises this very path as 2 CPU processes x 4 virtual devices with
Gloo collectives (tests/test_distributed.py) — process-spanning psum
included; no multi-host cluster is required for the logic to be
validated.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from patolette_tpu.parallel import mesh as PM


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, local_device_ids=None):
    """Join the multi-process runtime (wrapper of
    ``jax.distributed.initialize``). Call once per process, BEFORE any
    backend use. After this, ``jax.devices()`` lists every process's
    devices and collectives span them all."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_global_mesh():
    """1-D ``pixels`` mesh over all processes' devices."""
    return PM.make_mesh(jax.devices())


def put_pixels_local(local_rows: np.ndarray, mesh, global_len: int):
    """Assemble a globally pixel-sharded (N, ...) array from each
    process's contiguous local rows.

    ``local_rows``: this process's slice (concatenating all processes'
    slices in process order must give the full array). Returns a global
    jax.Array sharded over ``pixels``.
    """
    local_rows = np.ascontiguousarray(local_rows)
    shape = (global_len,) + local_rows.shape[1:]
    sharding = NamedSharding(mesh, P(*(("pixels",) + (None,) * (local_rows.ndim - 1))))
    return jax.make_array_from_process_local_data(sharding, local_rows, shape)


def put_planar_local(local_colors: np.ndarray, mesh, global_len: int):
    """(local_n, 3) rows -> 3 global (N,) channel vectors (u8 raw or f32),
    the distributed analogue of ``mesh.put_planar_sharded``."""
    local_colors = np.asarray(local_colors)
    return tuple(
        put_pixels_local(PM.wire_channel(local_colors[:, k]), mesh,
                         global_len)
        for k in range(3)
    )


def quantize_palette_distributed(mesh, palette_size: int, **kw):
    """The sharded palette pipeline on a (possibly multi-process) mesh.

    Identical program to ``mesh.quantize_palette_sharded`` — shard_map is
    process-count-agnostic; the psum schedule simply spans hosts when the
    mesh does."""
    return PM.quantize_palette_sharded(mesh, palette_size, **kw)


def dither_distributed(mesh, width: int, height: int, color_space: int,
                       **kw):
    """Per-strip dither on a multi-process mesh (seam semantics as
    ``mesh.dither_sharded``)."""
    return PM.dither_sharded(mesh, width, height, color_space, **kw)


def local_shard(global_array) -> np.ndarray:
    """This process's rows of a pixel-sharded result, in device order."""
    shards = sorted(
        global_array.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards])
