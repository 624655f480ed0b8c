"""Mid-stream resumable CT-RCQ encoder.

The reference's adaptive coders are resumable state machines: encode/decode
return Result{Pending, requestSize} on sink/source exhaustion and re-drive
from the saved coder state (cpprcoder.h:112-123, 708-711, 901-910). The device
equivalent: the K-lane coder state is a pytree — (low, carry, range, cache,
cache_size) u32 vectors plus the model counts C and the step index — so a
snapshot at any CHUNK boundary (chunk = a configurable number of K-symbol
steps, e.g. 64 KiB of input) captures everything needed to resume. Each
chunk's packed events are materialized into per-lane byte FRAGMENTS
immediately (continuation chunks keep their dummy byte — it was dropped in
chunk 0), so a checkpoint holds only O(compressed-so-far) bytes, never the
raw event grid.

`finish()` produces a container BYTE-IDENTICAL to the one-shot
rcq_encode_jax/ref output for the same data and parameters
(tests/test_rcq_resume.py), because the coder math runs the same schedule —
only the event-to-byte materialization is chunked.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.core.bytesutil import ByteWriter
from cpprcoder_tpu.models.qmodel import QBITS, QTOTAL, rcq_params
from cpprcoder_tpu.ops import compaction, rc_common
from cpprcoder_tpu.ops.lookup import coder_step_lookups2
from cpprcoder_tpu.models.qmodel import quantize_jnp, rescale_jnp
from cpprcoder_tpu.reference.rc_ref import _lane_desc, _write_sizes

U32 = jnp.uint32
I32 = jnp.int32

N_SLOTS = 2


@lru_cache(maxsize=32)
def _chunk_fn(steps: int, k: int, inc: int, climit_log2: int):
    """One chunk of the CT-RCQ encode scan, resumable: takes and returns
    the full coder pytree. Identical per-step math to ops/rcq_ops.py."""
    climit = 1 << climit_log2

    @jax.jit
    def run(x2d, n, t0, low, carry, rng, cache, csz, C):
        st0 = (low, carry, rng, cache, csz)
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry_, xt):
            st, t_idx, C = carry_
            C = rescale_jnp(C, climit)
            q = quantize_jnp(C)
            cum_incl = jnp.cumsum(q)
            syms = xt.astype(I32)
            active = (t_idx * k + lane_ids) < n
            f, c, upd = coder_step_lookups2(q, cum_incl, syms, active, inc)
            t = st[2] >> QBITS
            is_top = (c + f) == U32(QTOTAL)
            st2, evs = rc_common.encode_symbol(st, t, c, f, is_top, active,
                                               N_SLOTS)
            return (st2, t_idx + 1, C + upd), evs

        (st, t1, C), evs = lax.scan(step, (st0, t0, C), x2d)
        events_t = jnp.transpose(evs, (0, 1, 2)).reshape(-1, k)  # [2*steps,k]
        return st, t1, C, events_t

    return run


@lru_cache(maxsize=32)
def _chunk_mat_fn(e: int, k: int, out_cap: int):
    @jax.jit
    def run(events_t, may_drop):
        payload, sizes = compaction.materialize_t(events_t, out_cap,
                                                  may_drop=may_drop)
        emitted_any = (jnp.cumsum(jnp.where((events_t >> 31) > 0, 1, 0)
                                  .astype(I32), axis=0)[-1] > 0)
        return payload, sizes, emitted_any

    return run


@lru_cache(maxsize=32)
def _flush_fn(k: int):
    @jax.jit
    def run(low, carry, rng, cache, csz):
        fl = rc_common.flush((low, carry, rng, cache, csz))  # [2, k]
        return fl.reshape(2, k)

    return run


class RCQResumableEncoder:
    """Incremental CT-RCQ encoder with mid-superblock checkpoint/resume."""

    def __init__(self, total_n: int, lanes: int | None = None,
                 inc: int | None = None, climit_log2: int | None = None,
                 chunk_steps: int = 64):
        k, inc0, cl0 = rcq_params(total_n, lanes)
        self.n = total_n
        self.k = k
        self.inc = inc if inc is not None else inc0
        self.cl = climit_log2 if climit_log2 is not None else cl0
        self.chunk_steps = chunk_steps
        self._buf = bytearray()
        self._frag_payload: list[bytes] = []      # chunk payloads
        self._frag_sizes: list[np.ndarray] = []   # per-lane sizes per chunk
        self._t0 = 0
        self._fed = 0
        self._state = tuple(np.asarray(a) for a in (
            np.zeros(k, np.uint32), np.zeros(k, np.uint32),
            np.full(k, 0xFFFFFFFF, np.uint32), np.zeros(k, np.uint32),
            np.ones(k, np.uint32)))
        self._C = np.ones(256, np.uint32)
        self._never_emitted = np.ones(k, bool)

    # -------------------------------------------------------------- feed
    def feed(self, data: bytes) -> int:
        self._buf.extend(data)
        self._fed += len(data)
        if self._fed > self.n:
            raise ValueError("fed more than total_n bytes")
        chunk_syms = self.chunk_steps * self.k
        while len(self._buf) >= chunk_syms:
            self._run_chunk(bytes(self._buf[:chunk_syms]), self.chunk_steps)
            del self._buf[:chunk_syms]
        return len(self._buf)

    def _run_chunk(self, raw: bytes, steps: int):
        x = np.zeros(steps * self.k, np.uint8)
        x[: len(raw)] = np.frombuffer(raw, np.uint8)
        x2d = jnp.asarray(x.reshape(steps, self.k))
        fn = _chunk_fn(steps, self.k, self.inc, self.cl)
        st, t1, C, events_t = fn(
            x2d, U32(self.n), U32(self._t0),
            *(jnp.asarray(a) for a in self._state), jnp.asarray(self._C))
        may_drop = jnp.asarray(self._never_emitted)
        pcnt_total = int(compaction.payload_layout_t(
            events_t, may_drop=may_drop)[4])
        from cpprcoder_tpu.utils.shapes import bucket

        payload, sizes, emitted = _chunk_mat_fn(
            events_t.shape[0], self.k, bucket(pcnt_total + 8))(
            events_t, may_drop)
        self._frag_payload.append(
            np.asarray(jax.device_get(payload))[:pcnt_total].tobytes())
        self._frag_sizes.append(
            np.asarray(jax.device_get(sizes), dtype=np.int64))
        self._never_emitted &= ~np.asarray(jax.device_get(emitted))
        self._state = tuple(np.asarray(jax.device_get(a)) for a in st)
        self._C = np.asarray(jax.device_get(C))
        self._t0 = int(t1)

    # -------------------------------------------------- checkpoint/resume
    def checkpoint(self) -> dict:
        """Plain-numpy snapshot (picklable); resume() restores it."""
        return {
            "n": self.n, "k": self.k, "inc": self.inc, "cl": self.cl,
            "chunk_steps": self.chunk_steps, "t0": self._t0,
            "fed": self._fed, "buf": bytes(self._buf),
            "state": [a.copy() for a in self._state], "C": self._C.copy(),
            "never_emitted": self._never_emitted.copy(),
            "frag_payload": list(self._frag_payload),
            "frag_sizes": [s.copy() for s in self._frag_sizes],
        }

    @classmethod
    def resume(cls, ckpt: dict) -> "RCQResumableEncoder":
        enc = cls(ckpt["n"], lanes=ckpt["k"], inc=ckpt["inc"],
                  climit_log2=ckpt["cl"], chunk_steps=ckpt["chunk_steps"])
        enc._t0 = ckpt["t0"]
        enc._fed = ckpt["fed"]
        enc._buf = bytearray(ckpt["buf"])
        enc._state = tuple(np.asarray(a) for a in ckpt["state"])
        enc._C = np.asarray(ckpt["C"])
        enc._frag_payload = list(ckpt["frag_payload"])
        enc._frag_sizes = [np.asarray(s) for s in ckpt["frag_sizes"]]
        enc._never_emitted = np.asarray(ckpt["never_emitted"])
        return enc

    # ------------------------------------------------------------ finish
    def finish(self) -> bytes:
        if self._fed != self.n:
            raise ValueError(f"fed {self._fed} of {self.n} bytes")
        from cpprcoder_tpu.utils.shapes import bucket

        if self.n == 0:
            return (ByteWriter().u32(0).u8(_lane_desc(self.k, False))
                    .u8(self.inc).u8(self.cl).u8(QBITS).getvalue())
        # the one-shot encoder pads steps to the bucket grid; replay the
        # remaining (tail + padding) steps so the flush state matches
        total_steps = bucket(-(-self.n // self.k))
        rem = total_steps - self._t0
        if rem:
            self._run_chunk(bytes(self._buf), rem)
            self._buf.clear()
        fl = _flush_fn(self.k)(*(jnp.asarray(a) for a in self._state))
        may_drop = jnp.asarray(self._never_emitted)
        ftotal = int(compaction.payload_layout_t(fl, may_drop=may_drop)[4])
        fpay, fsizes, _ = _chunk_mat_fn(2, self.k, bucket(4 * self.k))(
            fl, may_drop)
        self._frag_payload.append(
            np.asarray(jax.device_get(fpay))[:ftotal].tobytes())
        self._frag_sizes.append(
            np.asarray(jax.device_get(fsizes), dtype=np.int64))
        # stitch per-lane streams: lane l = concat of its fragment slices
        sizes = np.stack(self._frag_sizes)          # [chunks, k]
        lane_sizes = sizes.sum(axis=0)
        lanes_bytes = [bytearray() for _ in range(self.k)]
        for ci, frag in enumerate(self._frag_payload):
            offs = np.concatenate(([0], np.cumsum(sizes[ci])))
            for l in range(self.k):
                lanes_bytes[l].extend(frag[offs[l]: offs[l + 1]])
        wide = bool(lane_sizes.max() >= 1 << 16)
        w = (ByteWriter().u32(self.n).u8(_lane_desc(self.k, wide))
             .u8(self.inc).u8(self.cl).u8(QBITS))
        _write_sizes(w, lane_sizes.tolist(), wide)
        for lb in lanes_bytes:
            w.raw(bytes(lb))
        return w.getvalue()
