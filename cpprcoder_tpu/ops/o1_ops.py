"""JAX order-1 blended adaptive range coder: CT-RC3.

All model access is one-hot algebra (no gathers, no scatters):
  row extraction   M1 = onehot(ctx) @ T1          (f32 matmul, exact —
                                                   all counts < 2^24)
  (f, c) pick      masked reduces over M1 / row-cumsum
  model update     T1 += inc · onehot(ctx)ᵀ @ onehot(sym)
Byte feeding uses the single-gather queue reader from range_ops.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.config import pick_lanes
from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.ops import compaction, rc_common
from cpprcoder_tpu.ops.range_ops import (
    _be_words,
    _materialize_fn,
    _queue_read,
    _queue_refill,
)
from cpprcoder_tpu.reference.o1_ref import (
    BLEND_LOG2,
    LIMIT0_LOG2,
    LIMIT1_LOG2,
    _chunk_layout,
    pick_inc,
)
from cpprcoder_tpu.reference.rc_ref import (
    _lane_desc,
    _parse_lane_desc,
    _write_sizes,
)
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32

N_SLOTS = 3  # total_eff can exceed 2^16 → up to 3 renorms/symbol


def _iota():
    return jnp.arange(256, dtype=I32)


def _model_step(t1, rowtot, t0, tot0, ctx, syms, active, inc, limit1, limit0,
                a):
    """Shared per-step model math. Returns per-lane blended inclusive-cum
    rows + tot_eff (computed BEFORE the update) plus rescaled model state.

    Hot-path structure (the step dominates CT-RC3 throughput):
      - the order-1 row cumsum runs on the TABLE [256,256], not on the
        extracted rows [K,256] (K/256× fewer elements, K in the thousands);
        extraction of the cum row is then a single matmul, exact by
        linearity.
      - the extraction matmul runs at DEFAULT precision on byte-split
        pieces: C1 < 2^14 (rowtot < 2^11 + k·inc ≤ 2^11 + 2^13, see
        pick_inc) is packed as [C1 >> 8, C1 & 255]; one-hot × piece < 2^8
        operands are exact in TF32 and bf16 and the dot accumulates in
        f32 (exactness argument: ops/lookup.py) — one [K,256]×[256,514]
        default-precision pass instead of a HIGHEST one."""
    resc1 = rowtot >= U32(limit1)
    t1 = jnp.where(resc1[:, None], (t1 >> 1) | 1, t1)
    rowtot = jnp.where(resc1, t1.sum(axis=1), rowtot)
    resc0 = tot0 >= U32(limit0)
    t0 = jnp.where(resc0, (t0 >> 1) | 1, t0)
    tot0 = jnp.where(resc0, t0.sum(), tot0)

    c1 = jnp.cumsum(t1, axis=1)                          # [256,256] u32
    packed = jnp.concatenate(
        [c1 >> 8, c1 & 255,
         (rowtot >> 8)[:, None], (rowtot & 255)[:, None]],
        axis=1).astype(F32)                              # [256,514]
    oh_ctx = (ctx[:, None] == _iota()[None, :]).astype(F32)
    ext = jnp.dot(oh_ctx, packed, preferred_element_type=F32)
    cum1 = ext[:, :256].astype(U32) * 256 + ext[:, 256:512].astype(U32)
    row_tot = ext[:, 512].astype(U32) * 256 + ext[:, 513].astype(U32)
    c0_incl = jnp.cumsum(t0)
    cum_eff_incl = U32(a) * cum1 + c0_incl[None, :]
    tot_eff = U32(a) * row_tot + tot0
    return (t1, rowtot, t0, tot0, oh_ctx, cum_eff_incl, tot_eff)


def _model_update(t1, rowtot, t0, tot0, ctx, syms, active, inc, oh_ctx=None):
    if oh_ctx is None:
        oh_ctx = (ctx[:, None] == _iota()[None, :]).astype(F32)
    oh_ctx = oh_ctx * active[:, None]
    oh_sym = ((syms[:, None] == _iota()[None, :]) & active[:, None]).astype(F32)
    upd = jnp.dot(oh_ctx.T, oh_sym, preferred_element_type=F32)  # 0/1 operands: exact at DEFAULT precision (ops/lookup.py)
    t1 = t1 + upd.astype(U32) * U32(inc)
    rowtot = rowtot + oh_ctx.sum(axis=0).astype(U32) * U32(inc)
    t0 = t0 + oh_sym.sum(axis=0).astype(U32) * U32(inc)
    tot0 = tot0 + U32(inc) * active.sum().astype(U32)
    ctx = jnp.where(active, syms, ctx)
    return t1, rowtot, t0, tot0, ctx


def _pick_fc(cum_eff_incl, syms):
    """(f, c) at syms from inclusive-cum rows: two one-hot picks (oh and
    its left-shift select cum[s] and cum[s-1]; s = 0 → c = 0 via the
    all-zero shifted row)."""
    oh = (syms[:, None] == _iota()[None, :]).astype(F32)
    cf = cum_eff_incl.astype(F32)
    ci = jnp.sum(cf * oh, axis=1).astype(U32)
    c = jnp.sum(cf * jnp.concatenate(
        [oh[:, 1:], jnp.zeros((oh.shape[0], 1), F32)], axis=1),
        axis=1).astype(U32)
    return ci - c, c


def _find_in_rows(cum_eff_incl, v):
    """Decode search: s = #{cum ≤ v} per row, then (f, c) via _pick_fc."""
    s = jnp.sum(cum_eff_incl <= v[:, None], axis=1).astype(I32)
    f, c = _pick_fc(cum_eff_incl, s)
    return s, c, f


def _init_model(k):
    return (jnp.ones((256, 256), U32), jnp.full(256, 256, U32),
            jnp.ones(256, U32), U32(256), jnp.zeros(k, I32))


@lru_cache(maxsize=32)
def _encode_fn(steps: int, k: int, inc: int, limit1_log2: int,
               limit0_log2: int, blend_log2: int):
    limit1, limit0, a = 1 << limit1_log2, 1 << limit0_log2, 1 << blend_log2

    @jax.jit
    def run(x2d, lens):  # x2d [steps, k] (chunked layout), lens [k]
        st = rc_common.make_state(k)
        t1, rowtot, t0, tot0, ctx = _init_model(k)

        def step(carry, xt):
            st, t_idx, t1, rowtot, t0, tot0, ctx = carry
            active = t_idx < lens
            syms = xt.astype(I32)
            (t1, rowtot, t0, tot0, oh_ctx, cum_eff, tot_eff) = _model_step(
                t1, rowtot, t0, tot0, ctx, syms, active, inc, limit1, limit0, a)
            f, c = _pick_fc(cum_eff, syms)
            t = st[2] // tot_eff
            is_top = (c + f) == tot_eff
            st, evs = rc_common.encode_symbol(st, t, c, f, is_top, active,
                                              N_SLOTS)
            t1, rowtot, t0, tot0, ctx = _model_update(
                t1, rowtot, t0, tot0, ctx, syms, active, inc, oh_ctx)
            return (st, t_idx + 1, t1, rowtot, t0, tot0, ctx), evs

        (st, *_), evs = lax.scan(
            step, (st, I32(0), t1, rowtot, t0, tot0, ctx), x2d)
        flush_evs = rc_common.flush(st)
        events = jnp.concatenate(
            [jnp.transpose(evs, (2, 0, 1)).reshape(k, -1),
             jnp.transpose(flush_evs, (1, 0))], axis=1)
        _, _, lane_sizes, _, total = compaction.lane_layout(events)
        return events, lane_sizes, total

    return run


@lru_cache(maxsize=32)
def _decode_fn(steps: int, k: int, inc: int, limit1_log2: int,
               limit0_log2: int, blend_log2: int, p_cap: int):
    limit1, limit0, a = 1 << limit1_log2, 1 << limit0_log2, 1 << blend_log2

    @jax.jit
    def run(payload, sizes, lens):
        offsets = (jnp.cumsum(sizes) - sizes).astype(I32)
        ends = offsets + sizes.astype(I32)
        S = _be_words(payload, p_cap)
        rng = jnp.full(k, 0xFFFFFFFF, U32)
        keep = jnp.clip(sizes.astype(I32), 0, 4).astype(U32)
        first = S[jnp.minimum(offsets, p_cap - 1)]
        code = jnp.where(keep == 0, U32(0),
                         first & (U32(0xFFFFFFFF) << ((U32(4) - keep) * 8 % 32)))
        cur = offsets + 4
        q = jnp.zeros(k, U32)
        occ = jnp.zeros(k, U32)
        t1, rowtot, t0, tot0, ctx = _init_model(k)

        def step(carry, _):
            (rng, code, q, occ, cur, t_idx, t1, rowtot, t0, tot0, ctx) = carry
            q, occ, cur = _queue_refill(S, q, occ, cur, ends, N_SLOTS, p_cap)
            active = t_idx < lens
            (t1, rowtot, t0, tot0, oh_ctx, cum_eff, tot_eff) = _model_step(
                t1, rowtot, t0, tot0, ctx, None, active, inc, limit1, limit0, a)
            t = rng // tot_eff
            v = jnp.minimum(code // t, tot_eff - 1)
            s, c, f = _find_in_rows(cum_eff, v)
            code = code - t * c
            rng = jnp.where((c + f) == tot_eff, rng - t * c, t * f)
            for _ in range(N_SLOTS):
                do = rng < U32(rc_common.RC_TOP)
                b, q, occ = _queue_read(q, occ, do)
                code = jnp.where(do, (code << 8) | b, code)
                rng = jnp.where(do, rng << 8, rng)
            t1, rowtot, t0, tot0, ctx = _model_update(
                t1, rowtot, t0, tot0, ctx, s, active, inc, oh_ctx)
            return (rng, code, q, occ, cur, t_idx + 1,
                    t1, rowtot, t0, tot0, ctx), s.astype(jnp.uint8)

        _, out = lax.scan(
            step, (rng, code, q, occ, cur, I32(0), t1, rowtot, t0, tot0, ctx),
            None, length=steps)
        return out  # [steps, k] — chunked layout: out.T.reshape(-1)[:n]

    return run


# ------------------------------------------------------------------ wrappers

def _pad_chunked(x: np.ndarray, steps: int, k: int, L: int) -> np.ndarray:
    out = np.zeros((k, steps), np.uint8)
    padded = np.zeros(k * L, np.uint8)
    padded[: len(x)] = x
    out[:, :L] = padded.reshape(k, L)
    return np.ascontiguousarray(out.T)  # [steps, k]


def o1_encode_jax(data, lanes: int | None = None, inc: int | None = None,
                  limit1_log2: int = LIMIT1_LOG2,
                  limit0_log2: int = LIMIT0_LOG2,
                  blend_log2: int = BLEND_LOG2) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc = inc if inc is not None else pick_inc(k)
    if n == 0:
        return (ByteWriter().u32(0).u8(_lane_desc(k, False)).u8(inc)
                .u8(limit1_log2).u8(limit0_log2).u8(blend_log2).getvalue())
    L, lens = _chunk_layout(n, k)
    steps = bucket(L)
    fn = _encode_fn(steps, k, inc, limit1_log2, limit0_log2, blend_log2)
    events, lane_sizes, total = fn(
        jnp.asarray(_pad_chunked(x, steps, k, L)), jnp.asarray(lens, I32))
    total = int(total)
    out_cap = bucket(total)
    payload, lane_sizes = _materialize_fn(k, events.shape[1], out_cap)(events)
    sizes = np.asarray(jax.device_get(lane_sizes), dtype=np.int64)
    payload_np = np.asarray(jax.device_get(payload))[:total]
    wide = bool(sizes.max() >= 1 << 16)
    w = (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
         .u8(limit1_log2).u8(limit0_log2).u8(blend_log2))
    _write_sizes(w, sizes.tolist(), wide)
    w.raw(payload_np.tobytes())
    return w.getvalue()


def o1_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    limit1_log2 = r.u8()
    limit0_log2 = r.u8()
    blend_log2 = r.u8()
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int32)
    payload = r.rest()
    p_cap = bucket(max(len(payload), 1))
    padded = np.zeros(p_cap, np.uint8)
    padded[: len(payload)] = payload
    L, lens = _chunk_layout(n, k)
    steps = bucket(L)
    out = _decode_fn(steps, k, inc, limit1_log2, limit0_log2, blend_log2,
                     p_cap)(jnp.asarray(padded), jnp.asarray(sizes),
                            jnp.asarray(lens, I32))
    out2 = np.asarray(jax.device_get(out)).T.reshape(-1)  # [k*steps]
    L_cols = out2.reshape(k, steps)[:, :L].reshape(-1)
    return L_cols[:n].tobytes()
