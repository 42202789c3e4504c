"""Mod-2 matrix multiplication — the matmul workhorse of this framework.

All GF(2^m)-linear maps with *fixed* constants (RS encode, RS syndromes,
Chien evaluation, BCH syndromes, dense LDPC ops) reduce to
``bits @ M mod 2`` with a 0/1 matrix M.  XLA hands the product to the
platform's matmul library: 0/1 bf16 inputs with float32 accumulation
are exact for inner dimensions up to 2^24 (every partial sum is an
integer below 2^24, so neither reduced-precision accumulation nor
summation order can change a bit), and the final mod-2 is a cheap
fused elementwise op.
"""

from __future__ import annotations

import jax.numpy as jnp


def gf2_matmul(x_bits, mat_bits):
    """(x_bits @ mat_bits) mod 2.

    x_bits:  [..., K] 0/1 (any integer/float dtype)
    mat_bits:[K, N]    0/1
    returns: [..., N] int8 0/1

    Uses bf16 operands with f32 accumulation (exact: products are 0/1 and
    partial sums are integers < 2^24).
    """
    acc = jnp.dot(
        x_bits.astype(jnp.bfloat16),
        mat_bits.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8)

