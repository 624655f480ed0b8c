"""Codec registry and top-level compress/decompress API.

Codec ids (stable, used by CT-PIPE containers):
    0 static_range   CT-RC1
    1 adaptive_range CT-RC2
    2 rans           CT-ANS1
    3 huffman        CT-HUF1
    4 blocksort      CT-BWT1
    5 mtf            CT-MTF1
    6 slz4           CT-LZ4
    7 ase            CT-ASE1
    8 mtf1           CT-MTF1 (MTF-1 variant)
    9 pipeline       CT-PIPE
   10 stream         CT-SB
   11 adaptive_o1    CT-RC3
   12 rle0           CT-RLE0
   13 adaptive_rans  CT-ANS2
   14 rcq            CT-RCQ (quantized-model adaptive range coder)
   15 rcx            CT-RCX (context-conditioned quantized adaptive RC)
"""

from __future__ import annotations

import threading
from typing import Callable

_REGISTRY: dict[str, "Codec"] = {}
_BY_ID: dict[int, "Codec"] = {}


class Codec:
    """encode_many/decode_many: optional batch forms that code several
    independent containers in one dispatch (same output as one call each)."""

    def __init__(self, name: str, codec_id: int,
                 encode: Callable, decode: Callable,
                 encode_many: Callable | None = None,
                 decode_many: Callable | None = None):
        self.name = name
        self.codec_id = codec_id
        self._encode = encode
        self._decode = decode
        self._encode_many = encode_many
        self._decode_many = decode_many

    def encode(self, data, **opts) -> bytes:
        blob = self._encode(data, **opts)
        from cpprcoder_tpu import debug

        if debug.shadow_enabled():
            debug.check_roundtrip(self, data, blob, opts)
        return blob

    def decode(self, blob, **opts) -> bytes:
        return self._decode(blob, **opts)

    def encode_many(self, chunks, **opts) -> list[bytes]:
        if self._encode_many is None:
            return [self.encode(c, **opts) for c in chunks]
        blobs = self._encode_many(chunks, **opts)
        from cpprcoder_tpu import debug

        if debug.shadow_enabled():
            for c, b in zip(chunks, blobs):
                debug.check_roundtrip(self, c, b, opts)
        return blobs

    def decode_many(self, blobs, **opts) -> list[bytes]:
        if self._decode_many is None:
            return [self.decode(b, **opts) for b in blobs]
        return self._decode_many(blobs, **opts)


def register(name: str, codec_id: int, encode: Callable, decode: Callable,
             encode_many: Callable | None = None,
             decode_many: Callable | None = None) -> Codec:
    c = Codec(name, codec_id, encode, decode, encode_many, decode_many)
    _REGISTRY[name] = c
    _BY_ID[codec_id] = c
    return c


def get_codec(name: str) -> Codec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_codec_by_id(codec_id: int) -> Codec:
    _ensure_loaded()
    return _BY_ID[codec_id]


def list_codecs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def compress(data, codec: str = "rans", **opts) -> bytes:
    return get_codec(codec).encode(data, **opts)


def decompress(blob, codec: str = "rans", **opts) -> bytes:
    return get_codec(codec).decode(blob, **opts)


_LOADED = False
_LOAD_LOCK = threading.RLock()


def _ensure_loaded():
    """Import every codec module once; safe when several threads make their
    first codec call at the same time."""
    global _LOADED
    if _LOADED:
        return
    with _LOAD_LOCK:
        if not _LOADED:
            _import_codecs()
            _LOADED = True


def _import_codecs():
    # import for registration side effects
    from cpprcoder_tpu.codecs import (  # noqa: F401
        static_range,
        adaptive_range,
        rans,
        huffman,
        blocksort,
        mtf,
        slz4,
        ase,
        adaptive_o1,
        adaptive_rans,
        rle0,
        rcq,
        rcx,
        pipeline,
        stream,
    )
