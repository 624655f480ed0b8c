"""CT-LZ4 codec (reference parity: SLZ4, test/slz4.h:116-592 — LZ4 block
format with exact parallel match-finding instead of a single-probe hash)."""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import slz4_ref


def encode(data, backend: str | None = None, seg_log2: int = 17,
           lazy: bool = True) -> bytes:
    if backend == "native":
        from cpprcoder_tpu import native
        return native.slz4_encode(data, seg_log2=seg_log2, lazy=lazy)
    from cpprcoder_tpu.ops import lz_ops
    fn = pick_backend(backend, lz_ops.slz4_encode_jax, slz4_ref.slz4_encode)
    # one parse on every device route, so their containers are identical
    return fn(data, seg_log2=seg_log2, lazy=lazy, parse="v2")


def decode(blob, backend: str | None = None) -> bytes:
    if backend == "native":
        from cpprcoder_tpu import native
        return native.slz4_decode(blob)
    from cpprcoder_tpu.ops import lz_ops
    fn = pick_backend(backend, lz_ops.slz4_decode_jax, slz4_ref.slz4_decode)
    return fn(blob)


CODEC = register("slz4", 6, encode, decode)
