"""Sharded end-to-end codec pipelines.

`ShardedCodec` wraps a facade `Codec` and runs its batched kernels with
the codeword batch sharded over a device mesh.  Two execution styles:

1. `encode` / `decode`: the facade's jitted programs run on
   NamedSharding-annotated inputs and XLA's partitioner splits them.
   Batch-elementwise ops and matmuls against replicated constants need
   no communication; whatever else the partitioner inserts shows in the
   compiled HLO (`python chip_smoke.py --chips 4` lists it).
2. `ldpc_decode_step`: an explicit shard_map step that decodes the
   local shard and psum-reduces BER/iteration statistics across the
   mesh (SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import BATCH_AXIS, batch_mesh, pad_to_multiple
from ..config import FecType


class ShardedCodec:
    def __init__(self, codec, mesh=None):
        self.codec = codec
        self.mesh = mesh if mesh is not None else batch_mesh()
        self.n_devices = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
        self._sharding = NamedSharding(self.mesh, P(BATCH_AXIS))
        self._ldpc_step = None

    def _put(self, x):
        return jax.device_put(jnp.asarray(x), self._sharding)

    def encode(self, data):
        data, n = pad_to_multiple(np.asarray(data), self.n_devices)
        res = self.codec.encode(self._put(data))
        return type(res)(res.data[:n], res.parity[:n])

    def decode(self, data, parity, **kw):
        data, n = pad_to_multiple(np.asarray(data), self.n_devices)
        parity, _ = pad_to_multiple(np.asarray(parity), self.n_devices)
        if kw.get("soft_llr") is not None:
            kw = dict(kw)
            kw["soft_llr"], _ = pad_to_multiple(np.asarray(kw["soft_llr"]), self.n_devices)
            kw["soft_llr"] = self._put(kw["soft_llr"])
        res = self.codec.decode(self._put(data), self._put(parity), **kw)
        return type(res)(res.ok[:n], res.data[:n], res.parity[:n], res.corrected[:n])

    # ------------------------------------------------- explicit shard_map

    def ldpc_step_program(self):
        """The jitted shard_map program behind `ldpc_decode_step`
        (built once per ShardedCodec): decodes the local shard at full
        budget and psum-reduces converged / iteration counts."""
        if self._ldpc_step is None:
            assert self.codec.fec_type == FecType.LDPC
            ldpc = self.codec._ldpc
            max_it = ldpc.max_iterations

            @functools.partial(
                jax.shard_map,
                mesh=self.mesh,
                in_specs=(P(BATCH_AXIS, None),),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS, None), P(BATCH_AXIS),
                           P(), P()),
            )
            def step(cw):
                ok, out, iters = ldpc._decode_hard(cw, max_it)
                n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), BATCH_AXIS)
                it_sum = jax.lax.psum(jnp.sum(iters), BATCH_AXIS)
                return ok, out, iters, n_ok, it_sum

            self._ldpc_step = jax.jit(step)
        return self._ldpc_step

    def ldpc_decode_step(self, codeword):
        """One explicit-SPMD LDPC hard-decode step with psum statistics.

        codeword: uint8 [B, codeword_bytes]; padded to a mesh multiple.
        Returns (ok, codeword_out, iters, stats) where stats are GLOBAL
        (psum over the batch axis).
        """
        step = self.ldpc_step_program()
        cw, n = pad_to_multiple(np.asarray(codeword), self.n_devices)
        ok, out, iters, n_ok, it_sum = step(self._put(cw))
        stats = dict(converged=int(n_ok), iterations_total=int(it_sum))
        return ok[:n], out[:n], iters[:n], stats
