"""Context-conditioned quantized windowed adaptive model (CT-RCX).

CT-RCQ (models/qmodel.py) codes every lane against ONE shared order-0
table. CT-RCX conditions the table on a per-lane context: the top CBITS
bits of the lane's PREVIOUS symbol (time-major layout, so the previous
symbol is one window step earlier in the SAME lane — available to encoder
and decoder alike; first step uses context 0). This is an order-1 model
family the reference does not have at all (its AdaptiveFrequencyTable is
order-0, cpprcoder.h:256-298); simulated on Canterbury it beats the
reference adaptive coder's ratio on every file.

Counts live in C[2^CBITS, 256]; each context row updates per K-symbol
window and rescales independently:

    rescale:  row r halves ((c >> 1) | 1) when sum(C[r]) >= climit
    quantize: per row, q = max(C * (QTOTAL - QRESERVE) // tot, 1),
              remainder to the row's FIRST argmax  ->  sum(q[r]) == QTOTAL

Same u32-exactness invariants as qmodel (only symbols whose context is r
add to row r, so per-row totals obey the same bound):
  - row tot < climit + K*inc;  climit = 2^16, K*inc <= 49152  ->  < 2^17
  - max C * (QTOTAL - QRESERVE) < 2^17 * 2^15 = 2^32  (u32-exact)
  - q < 2^15, row cumsum <= QTOTAL = 2^15 (i32/f32-exact, 2 byte pieces)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu.models.qmodel import (  # noqa: F401  (shared constants)
    CLIMIT_LOG2,
    MAX_K_TIMES_INC,
    QBITS,
    QRESERVE,
    QTOTAL,
)

# CT-RCX v2 (round 5): requantization happens once per WINDOW of
# W = 2^wlog steps (wlog a header byte, 0..3), not per step — the dominant
# per-step kernel cost (rescale + 15-round division + cumsum) amortizes
# over W steps (~1.9x kernel at W=4). Counts still update every step; the
# coder uses the tables frozen at the window start. Ratio cost measured
# (numpy sim, Canterbury): W=2 <= 0.9% relative, W=4 <= 2.7% (ptt5 worst),
# still below the reference adaptive coder on every file. wlog=0
# reproduces the per-step schedule bit-for-bit.
#
# Rescale at a window boundary uses up to THREE conditional halvings:
# between requants a row can grow by W*K*inc <= 8*49152 on top of
# climit-1 (= 458,749 max), and halving maps tot -> <= tot/2 + 256, so
# three rounds always land below climit (2^16). For wlog=0 the extra
# rounds are provably no-ops (tot < 2*climit pre-halving), so the SAME
# rescale is used for every wlog — and post-rescale tot < climit keeps
# the quantizer's u32 exactness bound (max C * (QTOTAL-QRESERVE) <
# 2^16 * 2^15 = 2^31) unchanged.
WLOG_DEFAULT = 2
RESCALE_ROUNDS = 3

# context-width policy (numpy ratio sweep over Canterbury): wider contexts
# always compress better but cost O(2^CBITS * 256) work per symbol in the
# one-hot kernel algebra of an earlier accelerator's kernels; these cutoffs
# keep every file below the reference adaptive ratio. This policy, the lane
# target (models/qmodel.rcq_params) and WLOG_DEFAULT were tuned to that
# kernel cost and are to be re-decided by measurement on the GPU (ROADMAP).
CBITS_SMALL, CBITS_MID, CBITS_BIG = 6, 5, 4
N_SMALL, N_MID = 1 << 16, 1 << 18


def rcx_params(n: int, lanes: int | None = None, inc: int | None = None,
               cbits: int | None = None,
               mode: str = "balanced") -> tuple[int, int, int, int]:
    """(k, inc, climit_log2, cbits) for an n-byte input.

    mode "balanced" (default) is throughput-optimal; mode "ratio" applies
    the round-4 autotune result (full-corpus sweep: cbits=6 with half the
    lanes beats the balanced ratio on EVERY Canterbury file — weighted
    0.392 vs 0.422 — at ~2-3x the wall time; e.g. kennedy 0.4042 vs
    0.4357, plrabn12 0.4766 vs 0.5168, ptt5 0.1236 vs 0.1336)."""
    from cpprcoder_tpu.models.qmodel import rcq_params

    k, _, cl = rcq_params(n, lanes)
    if mode == "ratio" and lanes is None:
        k = max(8, k // 2)
    if cbits is None:
        cbits = 6 if mode == "ratio" else (
            CBITS_SMALL if n <= N_SMALL
            else CBITS_MID if n <= N_MID else CBITS_BIG)
    if inc is None:
        inc = min(32 if n <= N_SMALL else 16, max(1, MAX_K_TIMES_INC // k))
    assert k * inc <= MAX_K_TIMES_INC and 0 <= cbits <= 8
    return k, inc, cl, cbits


def ctx_of(prev: np.ndarray, cbits: int):
    """Context id of each lane from its previous symbol (numpy or jnp)."""
    return (prev >> (8 - cbits)) if cbits else prev * 0


# ------------------------------------------------------------------ numpy

def rescale_rows_np(C: np.ndarray, climit: int) -> np.ndarray:
    for _ in range(RESCALE_ROUNDS):
        tot = C.sum(axis=1, dtype=np.uint32)
        hot = tot >= climit
        if not hot.any():
            break
        C = C.copy()
        C[hot] = (C[hot] >> 1) | 1
    return C


def quantize_rows_np(C: np.ndarray) -> np.ndarray:
    """C [B,256] u32 -> Q [B,256] with every row summing to QTOTAL."""
    C64 = C.astype(np.uint64)
    tot = C64.sum(axis=1, keepdims=True)
    q = np.maximum((C64 * (QTOTAL - QRESERVE)) // tot, 1).astype(np.uint32)
    rem = QTOTAL - q.sum(axis=1)
    am = np.argmax(q, axis=1)            # first argmax per row
    q[np.arange(len(q)), am] += rem.astype(np.uint32)
    return q


def update_rows_np(C: np.ndarray, ctx: np.ndarray, syms: np.ndarray,
                   inc: int) -> np.ndarray:
    C = C.copy()
    np.add.at(C, (ctx, syms), np.uint32(inc))
    return C


# ------------------------------------------------------------------ jnp

def rescale_rows_jnp(C, climit: int):
    import jax.numpy as jnp

    for _ in range(RESCALE_ROUNDS):
        tot = jnp.sum(C, axis=1, keepdims=True, dtype=jnp.uint32)
        C = jnp.where(tot >= jnp.uint32(climit), (C >> 1) | 1, C)
    return C


def quantize_rows_jnp(C):
    import jax.numpy as jnp

    tot = jnp.sum(C, axis=1, keepdims=True, dtype=jnp.uint32)
    q = jnp.maximum((C * jnp.uint32(QTOTAL - QRESERVE)) // tot, 1)
    rem = jnp.uint32(QTOTAL) - jnp.sum(q, axis=1, keepdims=True,
                                       dtype=jnp.uint32)
    am = jnp.argmax(q, axis=1, keepdims=True).astype(jnp.int32)
    onehot = (jnp.arange(256, dtype=jnp.int32)[None, :] == am)
    return q + rem * onehot.astype(jnp.uint32)
