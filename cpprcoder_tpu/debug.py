"""Debug-mode divergence detection: encode-side decoder shadowing.

The reference's correctness contract is that encoder and decoder update
their adaptive models identically per symbol — any drift silently corrupts
the stream, and the reference only catches it in its benchmark harness's
after-the-fact byte compare (test/main.cpp:295-299). The device analogue of a
race detector here is value-divergence detection between the encode and
decode model states: in shadow mode, every `Codec.encode` immediately
re-decodes its own container with an INDEPENDENT backend (device encode is
checked by the host oracle and vice versa) and byte-compares against the
input, reporting the first mismatch index like the reference harness does.

Enable with CT_SHADOW=1 (env) or debug.set_shadow(True). Cost: one extra
decode per encode — a debug mode, not a production path.
"""

from __future__ import annotations

import os

_SHADOW = os.environ.get("CT_SHADOW", "") not in ("", "0")


class DivergenceError(AssertionError):
    """Encoder/decoder divergence caught by shadow decoding."""

    def __init__(self, codec: str, index: int, total: int, detail: str = ""):
        self.codec, self.index, self.total = codec, index, total
        super().__init__(
            f"shadow decode divergence in codec {codec!r}: first mismatch "
            f"at byte {index} of {total}{(' (' + detail + ')') if detail else ''}")


def set_shadow(on: bool) -> None:
    global _SHADOW
    _SHADOW = bool(on)


def shadow_enabled() -> bool:
    return _SHADOW


def _shadow_backend(encode_backend) -> str:
    # cross-check with an independent implementation of the same format
    return "jax" if encode_backend == "ref" else "ref"


def check_roundtrip(codec, data, blob, encode_opts: dict) -> None:
    """Decode `blob` with a backend independent of the one that encoded it
    and byte-compare against `data`. Raises DivergenceError on mismatch."""
    import numpy as np

    from cpprcoder_tpu.core.bytesutil import as_u8

    import inspect

    want = np.asarray(as_u8(data))
    # detect backend support explicitly (a TypeError raised INSIDE a
    # backend-aware decode must propagate, not silently degrade the
    # independent-backend property)
    try:
        has_backend = "backend" in inspect.signature(codec._decode).parameters
    except (TypeError, ValueError):
        has_backend = False
    if has_backend:
        backend = _shadow_backend(encode_opts.get("backend"))
        got_b = codec._decode(blob, backend=backend)
    else:  # codec without backend twins (e.g. CT-PIPE, CT-SB)
        backend = "default"
        got_b = codec._decode(blob)
    got = np.frombuffer(got_b, dtype=np.uint8)
    if got.shape == want.shape and (want.size == 0 or bool(np.all(got == want))):
        return
    if got.shape != want.shape:
        raise DivergenceError(codec.name, min(got.size, want.size), want.size,
                              f"length {got.size} != {want.size}, "
                              f"shadow backend {backend}")
    idx = int(np.argmax(got != want))
    raise DivergenceError(codec.name, idx, want.size,
                          f"shadow backend {backend}")
