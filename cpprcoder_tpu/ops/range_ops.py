"""JAX K-lane range coder: CT-RC1 (static) and CT-RC2 (adaptive).

Lane-parallel design (SURVEY.md §7 phases 1-2): the per-byte sequential loop of the
reference (cpprcoder.h:400-436, 697-742) becomes a lax.scan over `steps`
time-steps whose carry is the vector state of K interleaved lanes. Step t
processes input slice x[tK : tK+K] (round-robin lanes → pure reshape).
Encoding emits packed events (ops.rc_common) compacted outside the scan
(ops.compaction); decoding gathers payload bytes at per-lane cursors with
zero-padding past each lane's end.

The adaptive variant keeps ONE shared model for all lanes: every lane codes
its step-t symbol against the same table, then the table takes a batched
histogram update (order-independent, so encoder == decoder), generalizing
the per-symbol update of cpprcoder.h:1134-1177 to K symbols per step.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.config import (
    STATIC_TOTAL,
    STATIC_TOTAL_BITS,
    adaptive_params_for,
    pick_lanes,
)
from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.models import freq_header
from cpprcoder_tpu.ops import compaction, rc_common
from cpprcoder_tpu.reference.rc_ref import _lane_desc, _parse_lane_desc, _write_sizes
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32


def _pad2d(x: np.ndarray, steps: int, k: int) -> np.ndarray:
    out = np.zeros(steps * k, dtype=np.uint8)
    out[: len(x)] = x
    return out.reshape(steps, k)


# ------------------------------------------------------------------ encode

@lru_cache(maxsize=64)
def _static_encode_fn(steps: int, k: int):
    n_slots = 2  # total = 2^16 → t ≥ 2^8 → ≤ 2 renorms/symbol

    @jax.jit
    def run(x2d, n):
        from cpprcoder_tpu.models.table_jax import (
            histogram_masked,
            normalize_freqs_jnp,
        )
        from cpprcoder_tpu.ops.lookup import bulk_lookup256

        counts = histogram_masked(x2d.reshape(-1), n)
        freqs = normalize_freqs_jnp(counts, n, STATIC_TOTAL_BITS)
        cums = jnp.concatenate([jnp.zeros(1, U32), jnp.cumsum(freqs[:255])])
        # static model → per-symbol (freq, cum) precomputed OUTSIDE the scan
        # (no in-scan gathers; see ops.lookup)
        fc = bulk_lookup256(jnp.stack([freqs, cums], axis=1),
                            x2d.reshape(-1)).reshape(steps, k, 2)
        st = rc_common.make_state(k)
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry, fct):
            st, t_idx = carry
            f = fct[:, 0]
            c = fct[:, 1]
            active = (t_idx * k + lane_ids) < n
            t = st[2] >> STATIC_TOTAL_BITS
            is_top = (c + f) == U32(STATIC_TOTAL)
            st, evs = rc_common.encode_symbol(st, t, c, f, is_top, active, n_slots)
            return (st, t_idx + 1), evs

        (st, _), evs = lax.scan(step, (st, U32(0)), fc)
        flush_evs = rc_common.flush(st)                      # [2, k]
        events = jnp.concatenate(
            [jnp.transpose(evs, (2, 0, 1)).reshape(k, -1),
             jnp.transpose(flush_evs, (1, 0))], axis=1)      # [k, E]
        _, _, lane_sizes, _, total = compaction.lane_layout(events)
        return events, lane_sizes, total, freqs

    return run


@lru_cache(maxsize=64)
def _adaptive_encode_fn(steps: int, k: int, inc: int, limit_log2: int):
    limit = 1 << limit_log2
    n_slots = 2 if limit_log2 <= 16 else 3

    @jax.jit
    def run(x2d, n):
        st = rc_common.make_state(k)
        lane_ids = jnp.arange(k, dtype=U32)
        freqs0 = jnp.ones(256, U32)

        from cpprcoder_tpu.ops.lookup import coder_step_lookups2

        def step(carry, xt):
            st, t_idx, freqs, total = carry
            resc = total >= U32(limit)
            f_resc = (freqs >> 1) | 1
            freqs = jnp.where(resc, f_resc, freqs)
            total = jnp.where(resc, f_resc.sum(), total)
            cum_incl = jnp.cumsum(freqs)
            syms = xt.astype(jnp.int32)
            active = (t_idx * k + lane_ids) < n
            f, c, upd = coder_step_lookups2(freqs, cum_incl, syms, active, inc)
            t = st[2] // total
            is_top = (c + f) == total
            st, evs = rc_common.encode_symbol(st, t, c, f, is_top, active, n_slots)
            freqs = freqs + upd
            total = total + U32(inc) * active.sum().astype(U32)
            return (st, t_idx + 1, freqs, total), evs

        (st, _, _, _), evs = lax.scan(step, (st, U32(0), freqs0, U32(256)), x2d)
        flush_evs = rc_common.flush(st)
        events = jnp.concatenate(
            [jnp.transpose(evs, (2, 0, 1)).reshape(k, -1),
             jnp.transpose(flush_evs, (1, 0))], axis=1)
        _, _, lane_sizes, _, total_b = compaction.lane_layout(events)
        return events, lane_sizes, total_b

    return run


@lru_cache(maxsize=64)
def _materialize_fn(k: int, e: int, out_cap: int):
    @jax.jit
    def run(events):
        return compaction.materialize(events, out_cap)

    return run


def _encode_container(x, k, phase1, header_fn):
    from cpprcoder_tpu.utils import profiling

    n = len(x)
    steps = bucket(-(-n // k)) if n else 1
    assert steps * 3 + 2 < (1 << rc_common.EV_RUN_BITS), "superblock too large"
    x2d = _pad2d(x, steps, k)
    with profiling.phase("enc.scan", n):
        events, lane_sizes, total, *extra = phase1(x2d)
        total = int(total)
    out_cap = bucket(total)
    with profiling.phase("enc.materialize", total):
        payload, lane_sizes = _materialize_fn(
            k, events.shape[1], out_cap)(events)
        sizes = np.asarray(jax.device_get(lane_sizes), dtype=np.int64)
        payload_np = np.asarray(jax.device_get(payload))[:total]
    with profiling.phase("enc.assemble", total):
        wide = bool(sizes.max() >= 1 << 16) if len(sizes) else False
        w = header_fn(wide, *[np.asarray(jax.device_get(e)) for e in extra])
        _write_sizes(w, sizes.tolist(), wide)
        w.raw(payload_np.tobytes())
        return w.getvalue()


def static_encode_jax(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    if n == 0:
        return ByteWriter().u32(0).u8(_lane_desc(k, False)).getvalue()
    steps = bucket(-(-n // k))
    fn = _static_encode_fn(steps, k)
    phase1 = lambda x2d: fn(x2d, U32(n))

    def header(wide, freqs):
        return (ByteWriter().u32(n).u8(_lane_desc(k, wide))
                .raw(freq_header.pack_freqs(freqs)))

    return _encode_container(x, k, phase1, header)


def adaptive_encode_jax(data, lanes: int | None = None, inc: int | None = None,
                        limit_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc0, limit0 = adaptive_params_for(k)
    inc = inc if inc is not None else inc0
    limit_log2 = limit_log2 if limit_log2 is not None else limit0
    if n == 0:
        return (ByteWriter().u32(0).u8(_lane_desc(k, False))
                .u8(inc).u8(limit_log2).getvalue())
    steps = bucket(-(-n // k))
    fn = _adaptive_encode_fn(steps, k, inc, limit_log2)
    phase1 = lambda x2d: fn(x2d, U32(n))

    def header(wide):
        return (ByteWriter().u32(n).u8(_lane_desc(k, wide))
                .u8(inc).u8(limit_log2))

    return _encode_container(x, k, phase1, header)


# ------------------------------------------------------------------ decode

def _be_words(payload, p_cap: int):
    """S[i] = bytes i..i+3 of payload, big-endian packed (zero past end).

    One u32 array so a per-lane refill needs a SINGLE gather for 4 bytes."""
    b = jnp.concatenate([payload.astype(U32), jnp.zeros(4, U32)])
    return (b[:p_cap] << 24) | (b[1:p_cap + 1] << 16) | \
        (b[2:p_cap + 2] << 8) | b[3:p_cap + 3]


def _queue_refill(S, q, occ, cur, ends, slots: int, p_cap: int):
    """Top up per-lane 4-byte queues to occ=4 where occ < slots.

    q: u32 MSB-aligned queue; occ bytes valid; cur = next unbuffered byte
    (absolute). Bytes past the lane end read as zero (FORMATS.md)."""
    need = occ < slots
    word = S[jnp.minimum(cur, p_cap - 1)]
    keep = jnp.clip(ends - cur, 0, 4).astype(U32)
    word = jnp.where(keep == 0, U32(0),
                     word & (U32(0xFFFFFFFF) << ((U32(4) - keep) * 8 % 32)))
    q2 = q | (word >> (occ * 8))
    cur2 = cur + (4 - occ).astype(cur.dtype)
    return (jnp.where(need, q2, q), jnp.where(need, U32(4), occ),
            jnp.where(need, cur2, cur))


def _queue_read(q, occ, do):
    """Consume one byte where `do`; returns (byte u32, q, occ)."""
    byte = q >> 24
    q = jnp.where(do, q << 8, q)
    occ = occ - do.astype(U32)
    return byte, q, occ


@lru_cache(maxsize=64)
def _static_decode_fn(steps: int, k: int, p_cap: int):
    @jax.jit
    def run(payload, sizes, freqs):
        from cpprcoder_tpu.ops.lookup import find_symbol2

        cum_incl = jnp.cumsum(freqs.astype(U32))
        offsets = (jnp.cumsum(sizes) - sizes).astype(jnp.int32)
        ends = offsets + sizes.astype(jnp.int32)
        S = _be_words(payload, p_cap)
        rng = jnp.full(k, 0xFFFFFFFF, U32)
        # preload: code = first 4 bytes (one gather), queue starts empty
        keep = jnp.clip(sizes.astype(jnp.int32), 0, 4).astype(U32)
        first = S[jnp.minimum(offsets, p_cap - 1)]
        code = jnp.where(keep == 0, U32(0),
                         first & (U32(0xFFFFFFFF) << ((U32(4) - keep) * 8 % 32)))
        cur = offsets + 4
        q = jnp.zeros(k, U32)
        occ = jnp.zeros(k, U32)

        def step(carry, _):
            rng, code, q, occ, cur = carry
            q, occ, cur = _queue_refill(S, q, occ, cur, ends, 2, p_cap)
            t = rng >> STATIC_TOTAL_BITS
            v = jnp.minimum(code // t, U32(STATIC_TOTAL - 1))
            s, c, f, _ = find_symbol2(cum_incl, v)
            code = code - t * c
            rng = jnp.where((c + f) == U32(STATIC_TOTAL), rng - t * c, t * f)
            for _ in range(2):
                do = rng < U32(rc_common.RC_TOP)
                b, q, occ = _queue_read(q, occ, do)
                code = jnp.where(do, (code << 8) | b, code)
                rng = jnp.where(do, rng << 8, rng)
            return (rng, code, q, occ, cur), s.astype(jnp.uint8)

        _, out = lax.scan(step, (rng, code, q, occ, cur), None, length=steps)
        return out  # [steps, k]

    return run


@lru_cache(maxsize=64)
def _adaptive_decode_fn(steps: int, k: int, inc: int, limit_log2: int, p_cap: int):
    limit = 1 << limit_log2
    n_renorm = 2 if limit_log2 <= 16 else 3

    @jax.jit
    def run(payload, sizes, n):
        from cpprcoder_tpu.ops.lookup import find_symbol2, hist_from_onehots

        offsets = (jnp.cumsum(sizes) - sizes).astype(jnp.int32)
        ends = offsets + sizes.astype(jnp.int32)
        S = _be_words(payload, p_cap)
        rng = jnp.full(k, 0xFFFFFFFF, U32)
        lane_ids = jnp.arange(k, dtype=U32)
        freqs0 = jnp.ones(256, U32)
        keep = jnp.clip(sizes.astype(jnp.int32), 0, 4).astype(U32)
        first = S[jnp.minimum(offsets, p_cap - 1)]
        code = jnp.where(keep == 0, U32(0),
                         first & (U32(0xFFFFFFFF) << ((U32(4) - keep) * 8 % 32)))
        cur = offsets + 4
        q = jnp.zeros(k, U32)
        occ = jnp.zeros(k, U32)

        def step(carry, _):
            rng, code, q, occ, cur, t_idx, freqs, total = carry
            q, occ, cur = _queue_refill(S, q, occ, cur, ends, n_renorm, p_cap)
            resc = total >= U32(limit)
            f_resc = (freqs >> 1) | 1
            freqs = jnp.where(resc, f_resc, freqs)
            total = jnp.where(resc, f_resc.sum(), total)
            cum_incl = jnp.cumsum(freqs)
            active = (t_idx * k + lane_ids) < n
            t = rng // total
            v = jnp.minimum(code // t, total - 1)
            s, c, f, ohs = find_symbol2(cum_incl, v, active)
            code = code - t * c
            rng = jnp.where((c + f) == total, rng - t * c, t * f)
            for _ in range(n_renorm):
                do = rng < U32(rc_common.RC_TOP)
                b, q2, occ2 = _queue_read(q, occ, do)
                q, occ = q2, occ2
                code = jnp.where(do, (code << 8) | b, code)
                rng = jnp.where(do, rng << 8, rng)
            freqs = freqs + hist_from_onehots(*ohs, inc)
            total = total + U32(inc) * active.sum().astype(U32)
            return (rng, code, q, occ, cur, t_idx + 1, freqs, total), \
                s.astype(jnp.uint8)

        _, out = lax.scan(
            step, (rng, code, q, occ, cur, U32(0), freqs0, U32(256)),
            None, length=steps)
        return out

    return run


def _decode_payload_setup(r: ByteReader, k: int, wide: bool):
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int32)
    payload = r.rest()
    p_cap = bucket(max(len(payload), 1))
    padded = np.zeros(p_cap, dtype=np.uint8)
    padded[: len(payload)] = payload
    return padded, sizes, p_cap


def static_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return b""
    freqs = freq_header.read_freqs(r, STATIC_TOTAL)
    payload, sizes, p_cap = _decode_payload_setup(r, k, wide)
    steps = bucket(-(-n // k))
    out = _static_decode_fn(steps, k, p_cap)(
        jnp.asarray(payload), jnp.asarray(sizes), jnp.asarray(freqs, U32))
    return np.asarray(jax.device_get(out)).reshape(-1)[:n].tobytes()


def adaptive_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    limit_log2 = r.u8()
    if n == 0:
        return b""
    payload, sizes, p_cap = _decode_payload_setup(r, k, wide)
    steps = bucket(-(-n // k))
    out = _adaptive_decode_fn(steps, k, inc, limit_log2, p_cap)(
        jnp.asarray(payload), jnp.asarray(sizes), U32(n))
    return np.asarray(jax.device_get(out)).reshape(-1)[:n].tobytes()
