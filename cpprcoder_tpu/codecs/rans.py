"""CT-ANS1 interleaved rANS codec (reference parity: cppans.h rANS scalar +
8-way SIMD interleave, cppans.h:23-649, generalized to K lanes)."""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import rans_ref


def encode(data, backend: str | None = None, lanes: int | None = None) -> bytes:
    from cpprcoder_tpu.ops import rans_ops
    fn = pick_backend(backend, rans_ops.rans_encode_jax, rans_ref.rans_encode)
    return fn(data, lanes=lanes)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import rans_ops
    fn = pick_backend(backend, rans_ops.rans_decode_jax, rans_ref.rans_decode)
    return fn(blob)


CODEC = register("rans", 2, encode, decode)
