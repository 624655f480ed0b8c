"""JAX K-lane interleaved rANS: CT-ANS1 v2.

Lane-parallel design (SURVEY.md §7 phase 3): the 8-state SIMD interleave of
cppans.h:567-649 generalized to K lanes with PER-LANE u16-word streams
(v2 — see reference/rans_ref.py for why the v1 shared stream had to go).
Division-free decode; at most one renorm word per symbol per direction.
Encode scans the input in reverse step order (the rANS backwards-encoding
trick, cppans.h:497-530); emitted word slots are compacted lane-major with
the same single-sort pass as the Huffman streams. Decode refills from a
per-lane cursor into the concatenated streams (one k-gather per step).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.config import ANS_LOW, ANS_PROB_BITS, ANS_TOTAL, pick_lanes
from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.models import freq_header
from cpprcoder_tpu.reference.rans_ref import _lane_desc, _parse_lane_desc
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32
MASK = ANS_TOTAL - 1


def _pad2d(x: np.ndarray, steps: int, k: int) -> np.ndarray:
    out = np.zeros(steps * k, dtype=np.uint8)
    out[: len(x)] = x
    return out.reshape(steps, k)


@lru_cache(maxsize=64)
def _encode_fn(steps: int, k: int):
    @jax.jit
    def run(x2d, n):
        from cpprcoder_tpu.models.table_jax import (
            histogram_masked,
            normalize_freqs_jnp,
        )
        from cpprcoder_tpu.ops.lookup import bulk_lookup256

        counts = histogram_masked(x2d.reshape(-1), n)
        freqs = normalize_freqs_jnp(counts, n, ANS_PROB_BITS)
        cums = jnp.concatenate([jnp.zeros(1, U32), jnp.cumsum(freqs[:255])])
        fc = bulk_lookup256(jnp.stack([freqs, cums], axis=1),
                            x2d.reshape(-1)).reshape(steps, k, 2)
        lane_ids = jnp.arange(k, dtype=U32)
        xs_rev = fc[::-1]

        def step(carry, fct):
            states, rt = carry
            orig_t = U32(steps - 1) - rt
            active = (orig_t * k + lane_ids) < n
            f = fct[:, 0]
            c = fct[:, 1]
            # (st >> 18) >= f  ⟺  st >= f << 18, without the u32 wrap
            # that f == 16384 (single-symbol input) hits in `f << 18`
            emit = active & ((states >> 18) >= f)
            word = (states & U32(0xFFFF)).astype(jnp.uint16)
            st = jnp.where(emit, states >> 16, states)
            q = st // f
            r = st - q * f
            st_new = (q << ANS_PROB_BITS) | (r + c)
            states = jnp.where(active, st_new, states)
            return (states, rt + 1), (emit, word)

        init = jnp.full(k, ANS_LOW, U32)
        (states, _), (emits, words) = lax.scan(step, (init, U32(0)), xs_rev)
        # scan emitted in reverse-step order; flip to original t order (per
        # lane, that IS the lane's read order), then flatten LANE-MAJOR so
        # the compacted stream is lane 0's words, lane 1's, ...
        emits = emits[::-1].T.reshape(-1)
        words = words[::-1].T.reshape(-1)
        cnt = emits.astype(I32)
        pstart = jnp.cumsum(cnt) - cnt
        lane_counts = cnt.reshape(k, steps).sum(axis=1)
        n_words = cnt.sum()
        return states, words, pstart, n_words, lane_counts, freqs

    return run


@lru_cache(maxsize=64)
def _stream_fn(slots: int, cap: int):
    """Compact emitted u16 words into the stream.

    One stable-by-unique-key sort (emitting slots keyed by their stream
    rank, the rest pushed to the tail) in place of a searchsorted + gather
    per output slot."""

    @jax.jit
    def run(words, pstart, n_words):
        # pstart is the exclusive cumsum of emit flags; a slot emits iff
        # the next slot's pstart advanced (reconstruct without the flags)
        nxt = jnp.concatenate([pstart[1:], n_words[None].astype(pstart.dtype)])
        emits = nxt > pstart
        keys = jnp.where(emits, pstart.astype(jnp.uint32),
                         jnp.uint32(0xFFFFFFFF))
        _, out = jax.lax.sort((keys, words), num_keys=1)
        positions = jnp.arange(cap, dtype=I32)
        padded = jnp.concatenate(
            [out, jnp.zeros(max(cap - len(pstart), 0), jnp.uint16)])[:cap]
        return jnp.where(positions < n_words, padded, jnp.uint16(0))

    return run


@lru_cache(maxsize=64)
def _decode_fn(steps: int, k: int, w_cap: int):
    @jax.jit
    def run(stream, states, bases, freqs, n):
        from cpprcoder_tpu.ops.lookup import find_symbol2

        cum_incl = jnp.cumsum(freqs.astype(U32))
        lane_ids = jnp.arange(k, dtype=U32)

        def step(carry, _):
            states, widx, t_idx = carry
            active = (t_idx * k + lane_ids) < n
            slot = states & U32(MASK)
            s, c, f, _ = find_symbol2(cum_incl, slot)
            st = f * (states >> ANS_PROB_BITS) + slot - c
            need = active & (st < U32(ANS_LOW))
            idx = jnp.minimum(bases + widx, w_cap - 1)
            w = stream[idx].astype(U32)
            st = jnp.where(need, (st << 16) | w, st)
            states = jnp.where(active, st, states)
            widx = widx + need.astype(I32)
            return (states, widx, t_idx + 1), s.astype(jnp.uint8)

        init = (states, jnp.zeros(k, I32), U32(0))
        _, out = lax.scan(step, init, None, length=steps)
        return out

    return run


# ------------------------------------------------------------------ wrappers

def rans_encode_jax(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    if n == 0:
        return ByteWriter().u32(0).u8(_lane_desc(k)).getvalue()
    steps = bucket(-(-n // k))
    fn = _encode_fn(steps, k)
    states, words, pstart, n_words, lane_counts, freqs = fn(
        jnp.asarray(_pad2d(x, steps, k)), U32(n))
    nw = int(n_words)
    cap = bucket(max(nw, 1))
    stream = _stream_fn(steps * k, cap)(words, pstart, n_words)
    cnts = np.asarray(jax.device_get(lane_counts))
    wide = bool(cnts.max() > 0xFFFF)
    w = ByteWriter().u32(n).u8(_lane_desc(k, wide))
    w.raw(freq_header.pack_freqs(np.asarray(jax.device_get(freqs))))
    w.u32s(np.asarray(jax.device_get(states)))
    w.u32s(cnts) if wide else w.u16s(cnts)
    w.u16s(np.asarray(jax.device_get(stream))[:nw])
    return w.getvalue()


def rans_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return b""
    freqs = freq_header.read_freqs(r, 1 << ANS_PROB_BITS)
    states = r.u32s(k)
    cnts = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    n_words = int(cnts.sum())
    words = r.u16s(n_words).astype(np.uint16)
    bases = np.concatenate(([0], np.cumsum(cnts)))[:-1].astype(np.int32)
    steps = bucket(-(-n // k))
    w_cap = bucket(max(n_words, 1))
    padded = np.zeros(w_cap, np.uint16)
    padded[:n_words] = words
    out = _decode_fn(steps, k, w_cap)(
        jnp.asarray(padded), jnp.asarray(states, U32), jnp.asarray(bases),
        jnp.asarray(freqs, U32), U32(n))
    return np.asarray(jax.device_get(out)).reshape(-1)[:n].tobytes()
