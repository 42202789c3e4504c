"""Collective statistics over the device mesh.

BER / iteration statistics are psum-reduced across the devices of the
mesh (NVLink between the cards of one host); the decode math itself
needs no codeword payload from another device (SURVEY.md §2).

Contract: `axis_name` names a mesh axis that MUST be bound in the
caller's shard_map/pjit scope — a wrong name raises (it is not
silently downgraded to a local reduction, which would report per-shard
stats as global ones).  Callers outside any collective scope pass
`axis_name=None` to reduce locally.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mesh import BATCH_AXIS


def ber_stats(bits_ref, bits_out, axis_name: str | None = BATCH_AXIS):
    """Bit-error-rate over a (possibly sharded) batch.

    axis_name: mesh axis to psum over (must be bound in the enclosing
    shard_map/pjit — an unbound name raises), or None for a local
    reduction.  Returns dict(errors, total, ber).
    """
    err = jnp.sum(bits_ref != bits_out)
    tot = jnp.asarray(bits_ref.size, dtype=jnp.int32)
    if axis_name is not None:
        err = jax.lax.psum(err, axis_name)
        tot = jax.lax.psum(tot, axis_name)
    return dict(errors=err, total=tot, ber=err / jnp.maximum(tot, 1))


def iteration_histogram(iters, max_iterations: int, axis_name: str | None = BATCH_AXIS):
    """Histogram of BP iteration counts [0..max_iterations].

    axis_name semantics as in ber_stats: a bound mesh axis to psum
    over, or None for the local histogram."""
    hist = jnp.sum(
        jax.nn.one_hot(iters, max_iterations + 1, dtype=jnp.int32), axis=0
    )
    if axis_name is not None:
        hist = jax.lax.psum(hist, axis_name)
    return hist
