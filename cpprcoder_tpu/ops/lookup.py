"""Gather-free table lookups.

Every in-scan table access of the XLA coders is written as one-hot algebra
(compares, masked reduces and small matmuls) instead of a dynamic gather —
a choice made for a machine on which gathers inside a scan were slow.
Whether a gather is the faster form on the GPU is not measured yet
(ROADMAP S4):

  - bulk_lookup256: lookup for a whole [n] symbol array via chunked one-hot
    f32 matmuls (values must fit f32 exactly, < 2^24 — all CT tables do)
  - coder_step_lookups2 / find_symbol2: the IN-SCAN hot paths. Two-level
    16×16 table decomposition (the analogue of the reference's chunked
    AdaptiveFrequencyTable, cpprcoder.h:262-264): [K,16] one-hot compares +
    tiny exact f32 matmuls replace [K,256] elementwise passes.
  - find_symbol / find_symbol_of / histogram256: flat [K,256] one-pass
    forms, kept as the readable correctness spec for the two-level paths
    (tests/test_lookup.py) and for callers outside scan hot loops
  - onehot_lookup: in-scan per-lane lookup from an evolving [256] table
    via compare + masked reduce

Exactness of the float dots (here, ops/o1_ops.py, models/table_jax.py).
Containers are compared byte for byte, so every dot must be exact. A dot at
DEFAULT precision may round its float32 operands: to TF32 (11 significant
bits) on an NVIDIA GPU's tensor cores, to bf16 (8 bits) on other
accelerators. So a DEFAULT-precision dot only ever multiplies a 0/1 one-hot
by a 0/1 one-hot or by a byte piece (an integer below 2^8, split from a
wider table value as [v >> 8, v & 255]); such operands are exact in both
formats. Accumulation is float32, exact while every partial sum stays below
2^24 (callers bound counts and tables so). Dots whose operands are wider
table values run at Precision.HIGHEST.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32

def _iota256():
    return jnp.arange(256, dtype=I32)


def bulk_lookup256(tables_u32, syms_u8, chunk: int = 1 << 15):
    """tables_u32 [256, M] (values < 2^24), syms_u8 [n] → [n, M] u32.

    Chunked one-hot f32 matmul: ~n·256·M MACs instead of n·M gathers."""
    import jax.lax as lax

    n = syms_u8.shape[0]
    m = tables_u32.shape[1]
    tf = tables_u32.astype(F32)
    pad = (-n) % chunk
    syms = jnp.concatenate([syms_u8.reshape(-1),
                            jnp.zeros(pad, jnp.uint8)]) if pad else syms_u8
    syms = syms.reshape(-1, chunk)

    def one(carry, row):
        oh = (row.astype(I32)[:, None] == _iota256()[None, :]).astype(F32)
        # HIGHEST precision is required: table values reach 2^24, beyond
        # what a DEFAULT-precision (TF32 or bf16) operand holds exactly
        return carry, jnp.dot(oh, tf, preferred_element_type=F32,
                              precision=lax.Precision.HIGHEST)

    _, out = lax.scan(one, 0, syms)
    return out.reshape(-1, m)[:n].astype(U32)


def find_symbol(cum_incl_u32, v_u32):
    """cum_incl [256] u32 (inclusive cumsum, total = cum_incl[255]),
    v [K] u32 → (sym i32, cum_lo u32, freq u32).

    sym = #{j : cum_incl[j] ≤ v}; cum_lo = max masked; freq = boundary diff.
    Works for evolving tables too (no precomputation)."""
    le = cum_incl_u32[None, :] <= v_u32[:, None]          # [K, 256]
    sym = jnp.sum(le, axis=1).astype(I32)
    cum_lo = jnp.max(jnp.where(le, cum_incl_u32[None, :], U32(0)), axis=1)
    hi = jnp.min(jnp.where(le, U32(0xFFFFFFFF), cum_incl_u32[None, :]), axis=1)
    return sym, cum_lo, hi - cum_lo


def onehot_lookup(table_u32, syms_i32):
    """table [256] u32, syms [K] i32 → [K] u32 via compare + masked reduce."""
    eq = syms_i32[:, None] == _iota256()[None, :]
    return jnp.max(jnp.where(eq, table_u32[None, :], U32(0)), axis=1)


def find_symbol_of(freqs_u32, cum_incl_u32, syms_i32):
    """Encoder-side lookup: (freq[s], cum_excl[s]) via one compare."""
    eq = syms_i32[:, None] == _iota256()[None, :]
    f = jnp.max(jnp.where(eq, freqs_u32[None, :], U32(0)), axis=1)
    ci = jnp.max(jnp.where(eq, cum_incl_u32[None, :], U32(0)), axis=1)
    return f, ci - f


def histogram256(syms_i32, weight: int, active):
    """Batched histogram: Σ over lanes of onehot(sym)·weight, masked.

    syms [K] i32, active [K] bool → [256] u32."""
    eq = (syms_i32[:, None] == _iota256()[None, :]) & active[:, None]
    return eq.sum(axis=0).astype(U32) * U32(weight)


def _dot_h(a, b):
    """Small matmul with integer-exact precision (HIGHEST keeps ints < 2^24
    exact; a DEFAULT-precision operand may be rounded to TF32 or bf16)."""
    import jax.lax as lax

    return jnp.dot(a, b, preferred_element_type=F32,
                   precision=lax.Precision.HIGHEST)


def _iota16():
    return jnp.arange(16, dtype=I32)


def coder_step_lookups2(freqs_u32, cum_incl_u32, syms_i32, active, inc: int):
    """Two-level (16×16) per-step adaptive-coder lookups — the reference's
    chunked AdaptiveFrequencyTable structure (CHUNK_SIZE=16,
    cpprcoder.h:262-264, find at 1220-1242): every [K,256] one-hot pass
    becomes [K,16] work plus tiny matmuls.

    Returns (f, cum_excl, hist·inc); inactive lanes get f = c = 0.
    Requires table values < 2^24 (f32-exact); callers keep totals ≤ 2^23."""
    f2 = freqs_u32.reshape(16, 16).astype(F32)
    c2 = cum_incl_u32.reshape(16, 16).astype(F32)
    hi = syms_i32 >> 4
    lo = syms_i32 & 15
    oh_hi = ((hi[:, None] == _iota16()[None, :])
             & active[:, None]).astype(F32)           # [K,16], masked
    oh_lo = (lo[:, None] == _iota16()[None, :]).astype(F32)
    row_f = _dot_h(oh_hi, f2)                          # [K,16]
    row_c = _dot_h(oh_hi, c2)
    f = jnp.sum(row_f * oh_lo, axis=1).astype(U32)
    ci = jnp.sum(row_c * oh_lo, axis=1).astype(U32)
    # batched model update: hist[h,l] = Σ_j oh_hi[j,h]·oh_lo[j,l]
    hist = jnp.dot(oh_hi.T, oh_lo, preferred_element_type=F32)  # 0/1: exact
    return f, ci - f, hist.reshape(256).astype(U32) * U32(inc)


def find_symbol2(cum_incl_u32, v_u32, active=None):
    """Two-level decode-side symbol find (see coder_step_lookups2):
    s = #{cum_incl ≤ v} via a 16-wide chunk search then an in-chunk search
    on the gathered row. Returns (sym i32, cum_lo u32, freq u32,
    onehot pair for the model update). Table values must be < 2^24."""
    c2 = cum_incl_u32.reshape(16, 16).astype(F32)
    chunk_cum = cum_incl_u32[15::16]                   # [16] inclusive
    s_hi = jnp.sum(chunk_cum[None, :] <= v_u32[:, None], axis=1).astype(I32)
    mask = active[:, None] if active is not None else True
    oh_hi = ((s_hi[:, None] == _iota16()[None, :]) & mask).astype(F32)
    row_c = _dot_h(oh_hi, c2)                          # [K,16] inclusive cums
    s_lo = jnp.sum(row_c.astype(U32) <= v_u32[:, None], axis=1).astype(I32)
    oh_lo = (s_lo[:, None] == _iota16()[None, :]).astype(F32)
    ci = jnp.sum(row_c * oh_lo, axis=1).astype(U32)
    # freq = ci - previous inclusive cum (cum_excl); prev = entry s_lo-1 of
    # the row, or the previous chunk's total for s_lo == 0
    prev_in_row = jnp.sum(row_c * jnp.concatenate(
        [oh_lo[:, 1:], jnp.zeros((oh_lo.shape[0], 1), F32)], axis=1),
        axis=1).astype(U32)
    prev_chunk = jnp.where(
        s_hi > 0,
        jnp.sum((s_hi[:, None] - 1 == _iota16()[None, :]).astype(U32)
                * chunk_cum[None, :].astype(U32), axis=1),
        U32(0))
    c = jnp.where(s_lo > 0, prev_in_row, prev_chunk)
    s = (s_hi << 4) | s_lo
    return s, c, ci - c, (oh_hi, oh_lo)


def hist_from_onehots(oh_hi, oh_lo, inc: int):
    """Model-update histogram from the find's one-hot pair (masked side:
    oh_hi)."""
    hist = jnp.dot(oh_hi.T, oh_lo, preferred_element_type=F32)
    return hist.reshape(256).astype(U32) * U32(inc)


