"""JAX (XLA scan) backend for CT-RCQ — the quantized-model adaptive range
coder (format spec: reference/rcq_ref.py; model: models/qmodel.py).

Design notes:
  - power-of-two model total -> t = range >> QBITS: NO division anywhere in
    the scan body (the reference divides per symbol, cpprcoder.h:402/701).
  - decode symbol search compares cum[s]*t <= code directly (u32-exact
    products < 2^32), two-level 16x16 like the reference's chunked
    AdaptiveFrequencyTable (cpprcoder.h:262-264) — gather-free.
  - decode byte feed: per-lane payloads are re-struck ONCE into [K, L4]
    big-endian u32 word rows (one bulk gather outside the scan); in-scan
    refills are masked reduces over the small row axis — no in-scan
    gathers at all.
  - encode emits packed events (ops.rc_common, 2 renorm slots) compacted
    outside the scan by ops.compaction, unchanged from CT-RC2.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.models.qmodel import (
    QBITS,
    QTOTAL,
    quantize_jnp,
    rcq_params,
    rescale_jnp,
)
from cpprcoder_tpu.ops import rc_common
from cpprcoder_tpu.ops.lookup import (
    coder_step_lookups2,
    hist_from_onehots,
    _dot_h,
    _iota16,
)
from cpprcoder_tpu.ops.range_ops import _encode_container, _pad2d
from cpprcoder_tpu.reference.rc_ref import (
    _lane_desc,
    _parse_lane_desc,
)
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32

N_SLOTS = 2  # range_new >= t >= 2^(24-QBITS) = 2^9 -> at most 2 renorms


# ------------------------------------------------------------------ encode

@lru_cache(maxsize=64)
def _encode_fn(steps: int, k: int, inc: int, climit_log2: int):
    climit = 1 << climit_log2

    @jax.jit
    def run(x2d, n):
        st = rc_common.make_state(k)
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry, xt):
            st, t_idx, C = carry
            C = rescale_jnp(C, climit)
            q = quantize_jnp(C)
            cum_incl = jnp.cumsum(q)
            syms = xt.astype(I32)
            active = (t_idx * k + lane_ids) < n
            f, c, upd = coder_step_lookups2(q, cum_incl, syms, active, inc)
            t = st[2] >> QBITS
            is_top = (c + f) == U32(QTOTAL)
            st, evs = rc_common.encode_symbol(st, t, c, f, is_top, active,
                                              N_SLOTS)
            return (st, t_idx + 1, C + upd), evs

        (st, _, _), evs = lax.scan(
            step, (st, U32(0), jnp.ones(256, U32)), x2d)
        flush_evs = rc_common.flush(st)
        events = jnp.concatenate(
            [jnp.transpose(evs, (2, 0, 1)).reshape(k, -1),
             jnp.transpose(flush_evs, (1, 0))], axis=1)
        from cpprcoder_tpu.ops import compaction

        _, _, lane_sizes, _, total = compaction.lane_layout(events)
        return events, lane_sizes, total

    return run


def rcq_encode_jax(data, lanes: int | None = None, inc: int | None = None,
                   climit_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k, inc0, cl0 = rcq_params(n, lanes)
    inc = inc if inc is not None else inc0
    climit_log2 = climit_log2 if climit_log2 is not None else cl0
    if n == 0:
        return (ByteWriter().u32(0).u8(_lane_desc(k, False))
                .u8(inc).u8(climit_log2).u8(QBITS).getvalue())
    steps = bucket(-(-n // k))
    fn = _encode_fn(steps, k, inc, climit_log2)
    phase1 = lambda x2d: fn(x2d, U32(n))

    def header(wide):
        return (ByteWriter().u32(n).u8(_lane_desc(k, wide))
                .u8(inc).u8(climit_log2).u8(QBITS))

    return _encode_container(x, k, phase1, header)


# ------------------------------------------------------------------ decode

def _find_symbol_q(q2f, cum2f, chunk_cums, t, code, active):
    """Two-level product search: s = max{s : cums_excl[s]*t <= code}.

    q2f/cum2f: [16,16] f32 tables (values < 2^24, f32-exact);
    chunk_cums: [16] u32 EXCLUSIVE cums at chunk starts (cums_excl[16j]);
    t, code: [K] u32. Returns (s i32, c u32, f u32, (oh_hi, oh_lo))."""
    # level 1: products chunk_cums*t are u32-exact (< 2^32)
    le_hi = chunk_cums[None, :] * t[:, None] <= code[:, None]     # [K,16]
    s_hi = jnp.sum(le_hi, axis=1).astype(I32) - 1
    mask = active[:, None] if active is not None else True
    oh_hi = ((s_hi[:, None] == _iota16()[None, :]) & mask).astype(F32)
    row_c = _dot_h(oh_hi, cum2f)                                   # [K,16]
    row_q = _dot_h(oh_hi, q2f)
    le_lo = row_c.astype(U32) * t[:, None] <= code[:, None]
    s_lo = jnp.sum(le_lo, axis=1).astype(I32) - 1
    oh_lo = (s_lo[:, None] == _iota16()[None, :]).astype(F32)
    c = jnp.sum(row_c * oh_lo, axis=1).astype(U32)
    f = jnp.sum(row_q * oh_lo, axis=1).astype(U32)
    s = (s_hi << 4) | s_lo
    return s, c, f, (oh_hi, oh_lo)


def _row_select(rows, idx):
    """rows [K, L] u32, idx [K] i32 -> rows[i, idx[i]] via masked reduce
    (gather-free; zero where idx is out of range)."""
    L = rows.shape[1]
    cols = jnp.arange(L, dtype=I32)
    return jnp.sum(jnp.where(cols[None, :] == idx[:, None], rows, U32(0)),
                   axis=1, dtype=U32)


@lru_cache(maxsize=64)
def _decode_fn(steps: int, k: int, inc: int, climit_log2: int, l4: int):
    climit = 1 << climit_log2

    @jax.jit
    def run(rows_w, n):
        rng = jnp.full(k, 0xFFFFFFFF, U32)
        code = rows_w[:, 0]
        q0 = jnp.zeros(k, U32)
        q1 = jnp.zeros(k, U32)
        occ = jnp.zeros(k, U32)
        widx = jnp.ones(k, I32)
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry, _):
            rng, code, q0, q1, occ, widx, t_idx, C = carry
            # refill: occ < N_SLOTS (occ in {0,1} here) -> append one word
            need = occ < U32(N_SLOTS)
            word = _row_select(rows_w, jnp.where(need, widx, I32(-1)))
            q0 = q0 | jnp.where(occ == 0, word, word >> 8)
            q1 = q1 | jnp.where(occ == 0, U32(0), word << 24)
            occ = jnp.where(need, occ + 4, occ)
            widx = widx + need.astype(I32)

            C = rescale_jnp(C, climit)
            q = quantize_jnp(C)
            cum_incl = jnp.cumsum(q)
            cums_excl = cum_incl - q
            chunk_cums = cums_excl[0::16]
            q2f = q.reshape(16, 16).astype(F32)
            cum2f = cums_excl.reshape(16, 16).astype(F32)
            active = (t_idx * k + lane_ids) < n
            t = rng >> QBITS
            s, c, f, ohs = _find_symbol_q(q2f, cum2f, chunk_cums, t, code,
                                          active)
            code = code - c * t
            rng = jnp.where((c + f) == U32(QTOTAL), rng - c * t, f * t)
            for _ in range(N_SLOTS):
                do = rng < U32(rc_common.RC_TOP)
                b = q0 >> 24
                q0 = jnp.where(do, (q0 << 8) | (q1 >> 24), q0)
                q1 = jnp.where(do, q1 << 8, q1)
                occ = occ - do.astype(U32)
                code = jnp.where(do, (code << 8) | b, code)
                rng = jnp.where(do, rng << 8, rng)
            C = C + hist_from_onehots(*ohs, inc)
            return (rng, code, q0, q1, occ, widx, t_idx + 1, C), \
                s.astype(jnp.uint8)

        _, out = lax.scan(
            step,
            (rng, code, q0, q1, occ, widx, U32(0), jnp.ones(256, U32)),
            None, length=steps)
        return out  # [steps, k]

    return run


@lru_cache(maxsize=64)
def _rows_fn(k: int, l4: int, p_cap: int):
    """Re-strike the flat payload into [K, L4] big-endian u32 word rows
    (word j of lane i = payload bytes off[i]+4j .. +3, zero past the lane
    end). ONE bulk gather, outside the scan."""

    @jax.jit
    def run(payload, sizes):
        from cpprcoder_tpu.ops.range_ops import _be_words

        S = _be_words(payload, p_cap)
        offsets = (jnp.cumsum(sizes) - sizes).astype(I32)
        ends = offsets + sizes.astype(I32)
        pos = offsets[:, None] + 4 * jnp.arange(l4, dtype=I32)[None, :]
        words = S[jnp.clip(pos, 0, p_cap - 1)]
        keep = jnp.clip(ends[:, None] - pos, 0, 4).astype(U32)
        shift = (U32(4) - keep) * 8 % 32
        words = jnp.where(keep == 0, U32(0),
                          words & (U32(0xFFFFFFFF) << shift))
        return words

    return run


def rcq_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit_log2 = r.u8()
    qbits = r.u8()
    if qbits != QBITS:
        from cpprcoder_tpu.core.bytesutil import CorruptContainerError

        raise CorruptContainerError(
            f"container qbits {qbits} != build {QBITS}")
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int32)
    payload = r.rest()
    if int(sizes.sum()) > len(payload):
        from cpprcoder_tpu.core.bytesutil import CorruptContainerError

        raise CorruptContainerError(
            f"size table claims {int(sizes.sum())} payload bytes, "
            f"container has {len(payload)}")
    from cpprcoder_tpu.utils import profiling

    p_cap = bucket(max(len(payload), 1))
    padded = np.zeros(p_cap, dtype=np.uint8)
    padded[: len(payload)] = payload
    l4 = bucket(-(-int(sizes.max()) // 4) + 1)
    with profiling.phase("dec.rows", len(payload)):
        rows_w = _rows_fn(k, l4, p_cap)(jnp.asarray(padded),
                                        jnp.asarray(sizes))
    steps = bucket(-(-n // k))
    with profiling.phase("dec.scan", n):
        out = _decode_fn(steps, k, inc, climit_log2, l4)(rows_w, U32(n))
    with profiling.phase("dec.fetch", n):
        return np.asarray(jax.device_get(out)).reshape(-1)[:n].tobytes()
