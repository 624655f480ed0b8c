"""CT-BWT1 blocksort (BWT) transform codec (reference parity: BlkSort,
blksort.h:76-108,401-661 — prefix-doubling rotation sort on the device)."""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import bwt_ref


def encode(data, backend: str | None = None, block_log2: int = 15) -> bytes:
    from cpprcoder_tpu.ops import bwt_ops
    fn = pick_backend(backend, bwt_ops.bwt_encode_jax, bwt_ref.bwt_encode)
    return fn(data, block_log2=block_log2)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import bwt_ops
    fn = pick_backend(backend, bwt_ops.bwt_decode_jax, bwt_ref.bwt_decode)
    return fn(blob)


CODEC = register("blocksort", 4, encode, decode)
