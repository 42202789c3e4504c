"""Streaming interface: protect arbitrary-length byte streams.

The reference operates on caller-managed single codewords; a production
pipeline needs framing.  `StreamCodec` segments a byte stream into
fixed-size blocks, encodes/decodes them as ONE batched device program
invocation, and reassembles the stream — the "data loader" layer of the
framework.  Framing is deterministic (length header + zero padding), so
encode/decode round-trip for any input length.

    sc = StreamCodec(pp.create(pp.rs_config_default()))
    blob = sc.encode_stream(payload)       # payload: bytes
    out  = sc.decode_stream(blob)          # -> (payload, stats)
"""

from __future__ import annotations

import numpy as np

from .config import FecType

_HEADER = 8  # uint64 little-endian payload length


class StreamCodec:
    def __init__(self, codec):
        self.codec = codec
        self.info_size = int(codec.info_size)
        self.parity_size = int(codec.parity_size)
        if self.info_size <= 0:
            raise ValueError("codec has no byte-block structure")

    @property
    def block_size(self) -> int:
        return self.info_size + self.parity_size

    def encode_stream(self, payload: bytes) -> bytes:
        """Returns framed, FEC-protected bytes."""
        raw = np.frombuffer(
            len(payload).to_bytes(_HEADER, "little") + payload, dtype=np.uint8
        )
        k = self.info_size
        nblocks = max(1, -(-len(raw) // k))
        padded = np.zeros(nblocks * k, dtype=np.uint8)
        padded[: len(raw)] = raw
        data = padded.reshape(nblocks, k)
        enc = self.codec.encode(data)
        d = np.asarray(enc.data)
        p = np.asarray(enc.parity)
        return np.concatenate([d, p], axis=1).tobytes()

    def decode_stream(self, blob: bytes, **decode_kw):
        """Returns (payload bytes, stats dict).  Raises ValueError on
        framing errors; uncorrectable blocks are reported in stats."""
        bs = self.block_size
        if len(blob) % bs != 0:
            raise ValueError(f"stream length {len(blob)} not a multiple of {bs}")
        arr = np.frombuffer(blob, dtype=np.uint8).reshape(-1, bs)
        data = arr[:, : self.info_size]
        parity = arr[:, self.info_size :]
        res = self.codec.decode(data, parity, **decode_kw)
        ok = np.asarray(res.ok)
        out = np.asarray(res.data).reshape(-1)
        length = int.from_bytes(out[:_HEADER].tobytes(), "little")
        if length > len(out) - _HEADER:
            raise ValueError("corrupt stream header")
        payload = out[_HEADER : _HEADER + length].tobytes()
        stats = {
            "blocks": int(arr.shape[0]),
            "blocks_failed": int((~ok).sum()),
            "corrected": np.asarray(res.corrected).sum().item(),
        }
        return payload, stats
