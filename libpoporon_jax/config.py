"""Configuration value objects.

Functional re-design of the reference's opaque config system
(/root/reference/src/internal/config.h, src/poporon.c:214-299): frozen
dataclasses instead of heap-allocated tagged unions.  The default /
preset constructors reproduce the reference's defaults exactly:

- RS default:   (8, 0x11D, fcr=1, prim=1, 32 roots) -> RS(255,223)
  (poporon.c:281-284)
- LDPC default: RANDOM matrix, column_weight=3, use_soft_decode=True,
  both interleavers on (poporon.c:286-289) — note the reference quirk
  that use_soft_decode=True with soft_llr=None silently falls back to
  hard decoding (decode.c:509-514); this framework mirrors that at the
  facade level.
- LDPC burst-resistant: column_weight=7 (poporon.c:291-294)
- BCH default:  (4, 0x13, t=3) -> BCH(15,5) (poporon.c:296-299)
"""

from __future__ import annotations

import dataclasses
import enum


class FecType(enum.IntEnum):
    RS = 1
    LDPC = 2
    BCH = 3
    UNKNOWN = 255


class LdpcRate(enum.IntEnum):
    """Code rates (reference poporon.h:27-32, ldpc.c:38-69)."""

    RATE_1_3 = 0
    RATE_1_2 = 1
    RATE_2_3 = 2
    RATE_3_4 = 3
    RATE_4_5 = 4
    RATE_5_6 = 5

    @property
    def ratio(self) -> tuple[int, int]:
        """(info_num, parity_num) per ldpc.c:38-69."""
        return {
            LdpcRate.RATE_1_3: (1, 2),
            LdpcRate.RATE_1_2: (1, 1),
            LdpcRate.RATE_2_3: (2, 1),
            LdpcRate.RATE_3_4: (3, 1),
            LdpcRate.RATE_4_5: (4, 1),
            LdpcRate.RATE_5_6: (5, 1),
        }[self]


class LdpcMatrixType(enum.IntEnum):
    RANDOM = 1
    QC_RANDOM = 2


@dataclasses.dataclass(frozen=True)
class RSConfig:
    symbol_size: int = 8
    generator_polynomial: int = 0x11D
    first_consecutive_root: int = 1
    primitive_element: int = 1
    num_roots: int = 32

    fec_type = FecType.RS


@dataclasses.dataclass(frozen=True)
class LdpcConfig:
    block_size: int
    rate: LdpcRate
    matrix_type: LdpcMatrixType = LdpcMatrixType.RANDOM
    column_weight: int = 3
    use_soft_decode: bool = False
    use_outer_interleave: bool = False
    use_inner_interleave: bool = False
    interleave_depth: int = 0
    lifting_factor: int = 0
    max_iterations: int = 0  # 0 -> default 50 (ldpc.c:23, 981-983)
    seed: int = 0

    # --- Execution policy (no reference analogue; results are
    # bit-identical for every setting — these trade wall-clock only).
    # 0 keeps the LDPCCodec default, none of which is tuned on the GPU.
    # Iterations the cheap first stage of the adaptive cascade runs
    # before straggler compaction (default STAGE1_ITERS = 3).
    adaptive_stage1_iters: int = 0
    # Straggler slots per full-budget pass (default STRAGGLER_SLOTS = 256).
    adaptive_straggler_slots: int = 0
    # Codewords per BP chunk (default DECODE_CHUNK = 1024).
    decode_chunk: int = 0
    # Batch size at which the facade switches to the adaptive cascade.
    # 0 -> default 512.
    adaptive_batch_threshold: int = 0

    fec_type = FecType.LDPC


@dataclasses.dataclass(frozen=True)
class BchConfig:
    symbol_size: int = 4
    generator_polynomial: int = 0x13
    correction_capability: int = 3

    fec_type = FecType.BCH


def rs_config_default() -> RSConfig:
    return RSConfig(8, 0x11D, 1, 1, 32)


def ldpc_config_default(block_size: int, rate: LdpcRate) -> LdpcConfig:
    return LdpcConfig(
        block_size=block_size,
        rate=rate,
        matrix_type=LdpcMatrixType.RANDOM,
        column_weight=3,
        use_soft_decode=True,
        use_outer_interleave=True,
        use_inner_interleave=True,
    )


def ldpc_config_burst_resistant(block_size: int, rate: LdpcRate) -> LdpcConfig:
    return LdpcConfig(
        block_size=block_size,
        rate=rate,
        matrix_type=LdpcMatrixType.RANDOM,
        column_weight=7,
        use_soft_decode=True,
        use_outer_interleave=True,
        use_inner_interleave=True,
    )


def bch_config_default() -> BchConfig:
    return BchConfig(4, 0x13, 3)
