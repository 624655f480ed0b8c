"""CT-RCX context-conditioned quantized adaptive range coder codec.

The ratio+throughput flagship: CT-RCQ's division-free quantized window
model (models/qmodel.py) conditioned on an order-1 context — the top
`cbits` bits of each lane's previous byte (models/cxmodel.py), with a
CHUNKED lane layout so the context is the true preceding byte. This is a
capability the reference does not have (its AdaptiveFrequencyTable is
order-0, cpprcoder.h:256-298); CT-RCX beats the reference adaptive coder's
ratio on every Canterbury file.
Format: reference/rcx_ref.py. Routes (codecs/base.py): the CUDA kernels on
a GPU (ops/rcx_cuda.py), "jax" (XLA scan, ops/rcx_ops.py), "ref" (host
oracle); all produce byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.core.bytesutil import as_u8
from cpprcoder_tpu.models.cxmodel import rcx_params
from cpprcoder_tpu.reference import rcx_ref


def _params(n: int, lanes=None, inc=None, climit_log2=None, cbits=None,
            mode: str = "balanced", wlog=None) -> dict:
    if mode != "balanced" and lanes is None and cbits is None:
        lanes, _, _, cbits = rcx_params(n, mode=mode)
        if wlog is None:
            wlog = 0          # ratio preset: per-step requant (best ratio)
    return dict(lanes=lanes, inc=inc, climit_log2=climit_log2, cbits=cbits,
                wlog=wlog)


def _kernel_encode(xs, params) -> list[bytes]:
    from cpprcoder_tpu.ops import rcx_cuda, rcx_ops

    return rcx_ops.encode_many(xs, params, events_fn=rcx_cuda.kernel_events)


def _kernel_decode(blobs) -> list[bytes]:
    from cpprcoder_tpu.ops import rcx_cuda, rcx_ops

    return rcx_ops.decode_many(blobs, symbols_fn=rcx_cuda.kernel_symbols)


def encode_many(chunks, backend: str | None = None, **opts) -> list[bytes]:
    """One container per chunk. Both device routes frame containers in
    rcx_ops.encode_many: one launch per group of chunks with equal
    parameters (on the kernel route one thread block per container)."""
    from cpprcoder_tpu.ops import rcx_cuda, rcx_ops

    xs = [as_u8(c) for c in chunks]
    params = [_params(len(x), **opts) for x in xs]
    shapes = [rcx_params(len(x), p["lanes"], p["inc"], p["cbits"])
              for x, p in zip(xs, params)]
    ref = lambda items, ps: [rcx_ref.rcx_encode(x, **p)
                             for x, p in zip(items, ps)]
    fn = pick_backend(backend, rcx_ops.encode_many, ref,
                      kernel_fn=_kernel_encode,
                      kernel_takes=all(rcx_cuda.takes(s[0], s[3])
                                       for s in shapes))
    return fn(xs, params)


def decode_many(blobs, backend: str | None = None) -> list[bytes]:
    from cpprcoder_tpu.ops import rcx_cuda, rcx_ops

    blobs = list(blobs)
    ref = lambda items: [rcx_ref.rcx_decode(b) for b in items]
    fn = pick_backend(backend, rcx_ops.decode_many, ref,
                      kernel_fn=_kernel_decode,
                      kernel_takes=all(rcx_cuda.takes(*rcx_ops.header_shape(b))
                                       for b in blobs))
    return fn(blobs)


def encode(data, backend: str | None = None, **opts) -> bytes:
    return encode_many([data], backend, **opts)[0]


def decode(blob, backend: str | None = None) -> bytes:
    return decode_many([blob], backend)[0]


CODEC = register("rcx", 15, encode, decode, encode_many=encode_many,
                 decode_many=decode_many)
