"""CT-SB: superblock streaming container.

Splits large inputs into fixed superblocks (default 32 MiB), encodes each
independently with any registered codec, and concatenates the per-superblock
containers behind a size table. This bounds device memory for arbitrarily
large streams, gives block-granular resume (SURVEY.md §5 checkpoint/resume),
and is the unit of data-parallel distribution.

Layout:
    u8  codec_id
    u8  sb_log2
    u32 n_superblocks
    n × u32 container sizes
    n containers
"""

from __future__ import annotations

from cpprcoder_tpu.codecs import get_codec, get_codec_by_id, register
from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8


def stream_encode(data, codec: str = "rans", sb_log2: int = 25,
                  backend=None, **opts) -> bytes:
    x = as_u8(data)
    c = get_codec(codec)
    sb = 1 << sb_log2
    blobs = c.encode_many([x[i:i + sb] for i in range(0, max(len(x), 1), sb)],
                          backend=backend, **opts)
    w = ByteWriter().u8(c.codec_id).u8(sb_log2).u32(len(blobs))
    w.u32s([len(b) for b in blobs])
    for b in blobs:
        w.raw(b)
    return w.getvalue()


def stream_decode(blob, backend=None, **opts) -> bytes:
    r = ByteReader(blob)
    c = get_codec_by_id(r.u8())
    r.u8()
    n_sb = r.u32()
    sizes = r.u32s(n_sb)
    blobs = [r.raw(int(s)).tobytes() for s in sizes]
    return b"".join(c.decode_many(blobs, backend=backend))


CODEC = register("stream", 10, stream_encode, stream_decode)


# ------------------------------------------------------- resume / seek

class SuperblockEncoder:
    """Incremental CT-SB encoder with checkpoint/resume — the device-side
    equivalent of the reference's resumable coder protocol
    (Result{Pending, requestSize}, cpprcoder.h:112-123): feed bytes in any
    granularity, snapshot progress at superblock boundaries, resume after a
    crash from the snapshot without re-encoding finished superblocks.

        enc = SuperblockEncoder("adaptive_range")
        enc.feed(chunk); ...
        ckpt = enc.checkpoint()          # plain dict, picklable
        enc2 = SuperblockEncoder.resume(ckpt)
        enc2.feed(rest)
        blob = enc2.finish()
    """

    def __init__(self, codec: str = "rans", sb_log2: int = 25,
                 backend=None, **opts):
        self._codec = get_codec(codec)
        self._sb_log2 = sb_log2
        self._backend = backend
        self._opts = opts
        self._blobs: list[bytes] = []
        self._pending = bytearray()

    def feed(self, data) -> int:
        """Buffer input; encode every completed superblock. Returns the
        number of superblocks finished by this call."""
        self._pending += bytes(as_u8(data).tobytes())
        sb = 1 << self._sb_log2
        done = 0
        while len(self._pending) >= sb:
            chunk = bytes(self._pending[:sb])
            del self._pending[:sb]
            self._blobs.append(self._codec.encode(
                chunk, backend=self._backend, **self._opts))
            done += 1
        return done

    def checkpoint(self) -> dict:
        """Progress snapshot: completed superblock containers + the
        unencoded tail. Plain picklable values only."""
        return {
            "format": "CT-SB-ckpt-v1",
            "codec": self._codec.name,
            "sb_log2": self._sb_log2,
            "blobs": list(self._blobs),
            "pending": bytes(self._pending),
        }

    @classmethod
    def resume(cls, ckpt: dict, backend=None, **opts) -> "SuperblockEncoder":
        if ckpt.get("format") != "CT-SB-ckpt-v1":
            raise ValueError("not a CT-SB checkpoint")
        enc = cls(ckpt["codec"], ckpt["sb_log2"], backend=backend, **opts)
        enc._blobs = list(ckpt["blobs"])
        enc._pending = bytearray(ckpt["pending"])
        return enc

    def finish(self) -> bytes:
        """Encode the tail (if any) and emit the complete CT-SB container."""
        if self._pending or not self._blobs:
            self._blobs.append(self._codec.encode(
                bytes(self._pending), backend=self._backend, **self._opts))
            self._pending.clear()
        w = (ByteWriter().u8(self._codec.codec_id).u8(self._sb_log2)
             .u32(len(self._blobs)))
        w.u32s([len(b) for b in self._blobs])
        for b in self._blobs:
            w.raw(b)
        return w.getvalue()


def stream_decode_range(blob, start: int, stop: int, backend=None) -> bytes:
    """Random-access decode of raw bytes [start, stop) — only the covering
    superblocks are decoded (block-granular seek; the reference has no
    random access at all)."""
    r = ByteReader(blob)
    c = get_codec_by_id(r.u8())
    sb = 1 << r.u8()
    n_sb = r.u32()
    sizes = r.u32s(n_sb)
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + int(s))
    base = r.pos
    first = max(0, start // sb)
    last = min(n_sb, -(-stop // sb)) if stop > start else first
    parts = []
    for i in range(first, last):
        part = c.decode(bytes(r.buf[base + offsets[i]:
                                    base + offsets[i + 1]]), backend=backend)
        parts.append(part)
    joined = b"".join(parts)
    lo = start - first * sb
    return joined[lo:lo + (stop - start)]
