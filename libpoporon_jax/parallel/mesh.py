"""Device mesh / sharding helpers.

The reference library is strictly single-threaded per call (SURVEY.md §2
"Parallelism"); here the scaling model is a 1-D mesh over all devices
of one host — e.g. four NVLink-connected GPUs, every card reaching
every other at the same rate — with the codeword batch sharded across
it.  Codewords are independent, so the decode math needs no
cross-device traffic; statistics are psum-reduced over the mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialise jax.distributed for a multi-process run.

    No-op for single-process runs (one process drives every card of a
    host).  With several processes, call once per process before
    building the mesh, with an explicit coordinator address
    (``localhost:<port>`` on one host).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def batch_mesh(devices=None) -> Mesh:
    """1-D mesh with a single 'batch' axis over all (or given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Mesh):
    """Place a [B, ...] array with the leading axis sharded over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(BATCH_AXIS)))


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad the batch axis so it divides the mesh; returns (padded, orig_len)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(np.asarray(x), pad_width), n
