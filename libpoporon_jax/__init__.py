"""libpoporon_jax — a batched forward-error-correction framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
colopl/libpoporon (reference: /root/reference): GF(2^m) arithmetic,
Reed-Solomon, BCH and LDPC codecs, erasure decoding and a deterministic
RNG — operating on *batches* of codewords per jitted program instead of
one codeword per call, sharded over a device mesh.

Public API (mirrors the reference facade, poporon.h:67-99, re-imagined
functionally):

    import libpoporon_jax as pp

    codec  = pp.create(pp.rs_config_default())
    parity = codec.encode(data)              # data: uint8 [B, k] (or [k])
    res    = codec.decode(data, parity)      # -> DecodeResult

Everything is bit-exact against the reference C library (verified by
tests/test_oracle_compat.py) for symbol sizes <= 8.
"""

from .config import (
    FecType,
    LdpcMatrixType,
    LdpcRate,
    RSConfig,
    LdpcConfig,
    BchConfig,
    rs_config_default,
    ldpc_config_default,
    ldpc_config_burst_resistant,
    bch_config_default,
)
from .facade import Codec, DecodeResult, create
from .erasure import Erasure
from .version import version_id, buildtime

__all__ = [
    "FecType",
    "LdpcMatrixType",
    "LdpcRate",
    "RSConfig",
    "LdpcConfig",
    "BchConfig",
    "rs_config_default",
    "ldpc_config_default",
    "ldpc_config_burst_resistant",
    "bch_config_default",
    "Codec",
    "DecodeResult",
    "create",
    "Erasure",
    "version_id",
    "buildtime",
]
