"""CT-RC2 adaptive range coder codec (reference parity:
AdaptiveRangeEncoder/Decoder + AdaptiveFrequencyTable, cpprcoder.h:256-940).

K lanes share one adaptive model updated with a batched per-step histogram —
the lane-parallel generalization of the per-symbol update at cpprcoder.h:1134-1177.
"""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import rc_ref


def encode(data, backend: str | None = None, lanes: int | None = None,
           inc: int | None = None, limit_log2: int | None = None) -> bytes:
    from cpprcoder_tpu.ops import range_ops
    fn = pick_backend(backend, range_ops.adaptive_encode_jax, rc_ref.adaptive_encode)
    return fn(data, lanes=lanes, inc=inc, limit_log2=limit_log2)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import range_ops
    fn = pick_backend(backend, range_ops.adaptive_decode_jax, rc_ref.adaptive_decode)
    return fn(blob)


CODEC = register("adaptive_range", 1, encode, decode)
