"""JAX K-lane adaptive interleaved rANS: CT-ANS2 (see reference/ans2_ref.py
for the format spec).

Design: classic adaptive rANS is encode-hostile (model forward, coding
backward). The deferred-summation model makes both directions batched:

  encode (one jit, no host round-trips):
    pass A  model windows → normalized snapshots [n_snap, 256]
            (normalize_freqs_jnp, the device twin of the host spec);
            the doubling warmup windows (1,1,2,4,…,R/2 steps) are a small
            unrolled prefix, the R-step main windows one lax.scan
    pass B  per-position (f, c) via one one-hot matmul per window
            (lax.map; Precision.HIGHEST — DEFAULT may round to TF32/bf16)
    pass C  the CT-ANS1 reverse interleaved coding scan, unchanged

  decode: outer loop over windows (rescale + renormalize the snapshot
  once — unrolled warmup prefix + scan over main windows), inner scan over
  the window's steps (division-free rANS step + batched histogram model
  update shared by all K lanes).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.config import ANS_LOW, ANS_PROB_BITS, pick_lanes
from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.reference.ans2_ref import (
    ANS2_INC_DEFAULT,
    ANS2_LIMIT_LOG2_DEFAULT,
    _lane_desc,
    default_refresh_log2,
)
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32
MASK = (1 << ANS_PROB_BITS) - 1


def _pad2d(x: np.ndarray, steps: int, k: int) -> np.ndarray:
    out = np.zeros(steps * k, dtype=np.uint8)
    out[: len(x)] = x
    return out.reshape(steps, k)


def _warm_lens(r_log2: int) -> list[int]:
    """Doubling warmup window lengths: 1,1,2,4,…,R/2 (sum = R)."""
    return [1] + [1 << i for i in range(r_log2)]


def _layout(steps: int, r_log2: int) -> tuple[int, int]:
    """(steps_pad, n_main) — warmup covers [0, R), main windows cover the
    rest in R-step strides."""
    r_steps = 1 << r_log2
    steps_pad = max(r_steps, -(-steps // r_steps) * r_steps)
    return steps_pad, steps_pad // r_steps - 1


def _window_model(counts, total, limit: int):
    """Window-start model refresh: rescale-if + snapshot normalize."""
    from cpprcoder_tpu.models.table_jax import normalize_freqs_jnp

    resc = total >= U32(limit)
    counts = jnp.where(resc, (counts >> 1) | 1, counts)
    total = jnp.where(resc, counts.sum().astype(U32), total)
    freqs = normalize_freqs_jnp(counts.astype(I32), total, ANS_PROB_BITS)
    return counts, total, freqs


def _fc_lookup(tbl_f32, syms_u8):
    iota = jnp.arange(256, dtype=I32)
    oh = (syms_u8.astype(I32)[:, None] == iota[None, :]).astype(F32)
    # HIGHEST: a DEFAULT-precision dot may round operands to TF32 or bf16
    return jnp.dot(oh, tbl_f32, preferred_element_type=F32,
                   precision=lax.Precision.HIGHEST)


@lru_cache(maxsize=32)
def _encode_fn(steps: int, k: int, inc: int, limit_log2: int, r_log2: int):
    limit = 1 << limit_log2
    r_steps = 1 << r_log2
    steps_pad, n_main = _layout(steps, r_log2)
    warm = _warm_lens(r_log2)

    @jax.jit
    def run(x2d, n):
        from cpprcoder_tpu.models.table_jax import histogram_masked

        x_pad = jnp.concatenate(
            [x2d, jnp.zeros((steps_pad - steps, k), jnp.uint8)])

        # ---- pass A: model windows → snapshots
        counts, total = jnp.ones(256, U32), U32(256)
        warm_snaps = []
        off = 0
        for length in warm:
            counts, total, freqs = _window_model(counts, total, limit)
            warm_snaps.append(freqs)
            xw = x_pad[off:off + length].reshape(-1)
            n_rem = jnp.clip(n.astype(I32) - off * k, 0, length * k)
            counts = counts + histogram_masked(xw, n_rem).astype(U32) * U32(inc)
            total = total + U32(inc) * n_rem.astype(U32)
            off += length

        x_main = x_pad[r_steps:].reshape(n_main, r_steps * k) if n_main \
            else jnp.zeros((0, r_steps * k), jnp.uint8)

        def window(carry, xw):
            counts, total, w_idx = carry
            counts, total, freqs = _window_model(counts, total, limit)
            n_rem = jnp.clip(
                n.astype(I32) - (r_steps + w_idx * r_steps) * k,
                0, r_steps * k)
            hist = histogram_masked(xw, n_rem).astype(U32)
            counts = counts + hist * U32(inc)
            total = total + U32(inc) * n_rem.astype(U32)
            return (counts, total, w_idx + 1), freqs

        (_, _, _), main_snaps = lax.scan(window, (counts, total, I32(0)),
                                         x_main)

        def with_cum(freqs2d):
            cums = jnp.concatenate(
                [jnp.zeros((freqs2d.shape[0], 1), U32),
                 jnp.cumsum(freqs2d[:, :255], axis=1)], axis=1)
            return jnp.stack([freqs2d, cums], axis=2).astype(F32)

        warm_tables = with_cum(jnp.stack(warm_snaps))        # [n_warm,256,2]
        main_tables = with_cum(main_snaps) if n_main else \
            jnp.zeros((0, 256, 2), F32)

        # ---- pass B: per-position (f, c) from the owning snapshot
        fc_parts = []
        off = 0
        for i, length in enumerate(warm):
            fc_parts.append(_fc_lookup(warm_tables[i],
                                       x_pad[off:off + length].reshape(-1)))
            off += length
        fc = jnp.concatenate(fc_parts)                        # [R*k, 2]
        if n_main:
            fc_main = lax.map(lambda a: _fc_lookup(a[0], a[1]),
                              (main_tables, x_main))
            fc = jnp.concatenate([fc, fc_main.reshape(-1, 2)])
        fc = fc.astype(U32).reshape(steps_pad, k, 2)[:steps]

        # ---- pass C: CT-ANS1 reverse interleaved coding scan
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry, fct):
            states, rt = carry
            orig_t = U32(steps - 1) - rt
            active = (orig_t * k + lane_ids) < n
            f = fct[:, 0]
            c = fct[:, 1]
            emit = active & (states >= (f << 18))
            word = (states & U32(0xFFFF)).astype(jnp.uint16)
            st = jnp.where(emit, states >> 16, states)
            q = st // f
            r = st - q * f
            st_new = (q << ANS_PROB_BITS) | (r + c)
            states = jnp.where(active, st_new, states)
            return (states, rt + 1), (emit, word)

        init = jnp.full(k, ANS_LOW, U32)
        (states, _), (emits, words) = lax.scan(step, (init, U32(0)), fc[::-1])
        emits = emits[::-1].reshape(-1)
        words = words[::-1].reshape(-1)
        cnt = emits.astype(I32)
        pstart = jnp.cumsum(cnt) - cnt
        return states, words, pstart, cnt.sum()

    return run


@lru_cache(maxsize=32)
def _decode_fn(steps: int, k: int, w_cap: int, inc: int, limit_log2: int,
               r_log2: int):
    limit = 1 << limit_log2
    r_steps = 1 << r_log2
    steps_pad, n_main = _layout(steps, r_log2)
    warm = _warm_lens(r_log2)

    @jax.jit
    def run(stream, states, n):
        from cpprcoder_tpu.ops.lookup import find_symbol2, hist_from_onehots

        lane_ids = jnp.arange(k, dtype=U32)

        def make_step(cum_incl):
            def step(c2, _):
                states, base, counts, total, t_idx = c2
                active = (t_idx * k + lane_ids) < n
                slot = states & U32(MASK)
                s, c, f, ohs = find_symbol2(cum_incl, slot, active)
                st = f * (states >> ANS_PROB_BITS) + slot - c
                need = active & (st < U32(ANS_LOW))
                offs = jnp.cumsum(need.astype(I32)) - 1
                idx = jnp.minimum(base + offs, w_cap - 1)
                w = stream[idx].astype(U32)
                st = jnp.where(need, (st << 16) | w, st)
                states = jnp.where(active, st, states)
                base = base + need.sum().astype(I32)
                counts = counts + hist_from_onehots(*ohs, inc)
                total = total + U32(inc) * active.sum().astype(U32)
                return (states, base, counts, total, t_idx + 1), \
                    s.astype(jnp.uint8)
            return step

        def run_window(carry, length):
            states, base, counts, total, t0 = carry
            counts, total, freqs = _window_model(counts, total, limit)
            cum_incl = jnp.cumsum(freqs.astype(U32))
            (states, base, counts, total, t0), out = lax.scan(
                make_step(cum_incl), (states, base, counts, total, t0),
                None, length=length)
            return (states, base, counts, total, t0), out

        carry = (states, jnp.zeros((), I32), jnp.ones(256, U32), U32(256),
                 U32(0))
        outs = []
        for length in warm:
            carry, out = run_window(carry, length)
            outs.append(out)

        def window(carry, _):
            return run_window(carry, r_steps)

        if n_main:
            carry, main_out = lax.scan(window, carry, None, length=n_main)
            outs.append(main_out.reshape(-1, k))
        return jnp.concatenate(outs)[:steps]

    return run


# ------------------------------------------------------------------ wrappers

def ans2_encode_jax(data, lanes: int | None = None,
                    inc: int = ANS2_INC_DEFAULT,
                    limit_log2: int = ANS2_LIMIT_LOG2_DEFAULT,
                    refresh_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    r_log2 = (refresh_log2 if refresh_log2 is not None
              else default_refresh_log2(k, n))
    w = (ByteWriter().u32(n).u8(_lane_desc(k)).u8(inc).u8(limit_log2)
         .u8(r_log2))
    if n == 0:
        return w.getvalue()
    steps = bucket(-(-n // k))
    states, words, pstart, n_words = _encode_fn(
        steps, k, inc, limit_log2, r_log2)(jnp.asarray(_pad2d(x, steps, k)),
                                           U32(n))
    from cpprcoder_tpu.ops.rans_ops import _stream_fn

    nw = int(n_words)
    cap = bucket(max(nw, 1))
    stream = _stream_fn(steps * k, cap)(words, pstart, n_words)
    w.u32s(np.asarray(jax.device_get(states)))
    w.u32(nw)
    w.u16s(np.asarray(jax.device_get(stream))[:nw])
    return w.getvalue()


def ans2_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    inc = r.u8()
    limit_log2 = r.u8()
    r_log2 = r.u8()
    if n == 0:
        return b""
    states = r.u32s(k)
    n_words = r.u32()
    words = r.u16s(n_words).astype(np.uint16)
    steps = bucket(-(-n // k))
    w_cap = bucket(max(n_words, 1))
    padded = np.zeros(w_cap, np.uint16)
    padded[:n_words] = words
    out = _decode_fn(steps, k, w_cap, inc, limit_log2, r_log2)(
        jnp.asarray(padded), jnp.asarray(states, U32), U32(n))
    return np.asarray(jax.device_get(out)).reshape(-1)[:n].tobytes()
