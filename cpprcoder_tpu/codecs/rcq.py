"""CT-RCQ quantized-model adaptive range coder codec.

The throughput flagship: same capability as CT-RC2 (reference parity:
AdaptiveRangeEncoder/Decoder + AdaptiveFrequencyTable, cpprcoder.h:256-940)
re-designed for division-free, lane-parallel execution — a power-of-two
quantized model re-derived per K-symbol window (models/qmodel.py). Format:
reference/rcq_ref.py. Routes: "jax" (XLA scan), "ref" (host oracle); both
produce byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import rcq_ref


def encode(data, backend: str | None = None, lanes: int | None = None,
           inc: int | None = None, climit_log2: int | None = None) -> bytes:
    from cpprcoder_tpu.ops import rcq_ops

    fn = pick_backend(backend, rcq_ops.rcq_encode_jax, rcq_ref.rcq_encode)
    return fn(data, lanes=lanes, inc=inc, climit_log2=climit_log2)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import rcq_ops

    fn = pick_backend(backend, rcq_ops.rcq_decode_jax, rcq_ref.rcq_decode)
    return fn(blob)


CODEC = register("rcq", 14, encode, decode)
