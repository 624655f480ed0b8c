"""CT-HUF1 canonical Huffman codec. The reference's cpphuff.h declares this
capability but is an empty stub (cpphuff.h:33,43-45); built from scratch with
exact package-merge length limiting (models/huffman.py)."""

from __future__ import annotations

from cpprcoder_tpu.codecs import register
from cpprcoder_tpu.codecs.base import pick_backend
from cpprcoder_tpu.reference import huffman_ref


def encode(data, backend: str | None = None, lanes: int | None = None) -> bytes:
    from cpprcoder_tpu.ops import huffman_ops
    fn = pick_backend(backend, huffman_ops.huffman_encode_jax,
                      huffman_ref.huffman_encode)
    return fn(data, lanes=lanes)


def decode(blob, backend: str | None = None) -> bytes:
    from cpprcoder_tpu.ops import huffman_ops
    fn = pick_backend(backend, huffman_ops.huffman_decode_jax,
                      huffman_ref.huffman_decode)
    return fn(blob)


CODEC = register("huffman", 3, encode, decode)
