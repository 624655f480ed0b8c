"""Ragged byte-stream compaction for event-based coder output.

Events (see ops.rc_common for the packed u32 layout) are produced densely at
[K, E]; each emitting event contributes `1 + run_len` bytes (a "first" byte
followed by run_len identical run bytes). Per lane, events tile the lane's
byte stream contiguously, lanes tile the payload in order, and the first
emitted byte of every lane (the dummy) is dropped (FORMATS.md).

Materialization is scatter-free: every output byte position finds its
owning event by sorting position records among event records (or, above the
sort's capacity, one vectorized binary search over the event start offsets)
— the SURVEY.md §7 'ragged compaction' pattern.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cpprcoder_tpu.ops.rc_common import EV_RUN_MASK

U32 = jnp.uint32
I32 = jnp.int32


def event_fields(events):
    emit = (events >> 31) > 0
    first = ((events >> 23) & U32(0xFF)).astype(jnp.uint8)
    run_byte = jnp.where((events >> 22) & 1, jnp.uint8(0x00), jnp.uint8(0xFF))
    run_len = (events & U32(EV_RUN_MASK)).astype(I32)
    return emit, first, run_byte, run_len


def payload_layout(events, may_drop=True):
    """events [K, E] → (pcnt, pstart, dropped, lane_sizes, total).

    pcnt: payload bytes per event (dummy byte removed from each lane's first
    emitting event); pstart: exclusive cumsum over the flattened (lane-major)
    event grid — i.e. each event's start offset in the final payload.

    may_drop: True (one-shot encode), or a [K] bool mask for CONTINUATION
    chunks of a resumable encode (see payload_layout_t)."""
    emit, _, _, run_len = event_fields(events)
    cnt = jnp.where(emit, 1 + run_len, 0).astype(I32)
    cum_lane = jnp.cumsum(cnt, axis=1)
    # the lane's first emitting event is the one with zero emitted before it
    prior = cum_lane - cnt
    first_emit = emit & (prior == 0)
    if isinstance(may_drop, bool):
        dropped = first_emit if may_drop else jnp.zeros_like(emit)
    else:
        dropped = first_emit & may_drop[:, None]
    pcnt = cnt - dropped.astype(I32)
    flat = pcnt.reshape(-1)
    cum = jnp.cumsum(flat)
    pstart = (cum - flat)
    lane_sizes = cum_lane[:, -1] - dropped.sum(axis=1, dtype=I32)
    total = cum[-1]
    return pcnt.reshape(-1), pstart, dropped.reshape(-1), lane_sizes, total


def _expand_sort(first, run_byte, pcnt, pstart, dropped, total, out_cap: int):
    """Shared sort-based expansion over FLAT event fields [M].

    Two SINGLE-u32-array sorts (key and payload packed into one word — a
    tuple sort moves twice the bytes per pass):

      1. merge-sort event records (key pstart<<10 | byte9) with position
         records (key p<<10 | 1<<9): each position lands after its owning
         event (the last contributing event with pstart <= p; contributing
         events have UNIQUE pstart, and bit 9 orders events before their
         first position);
      2. forward-fill the owner's 9 payload bits with one cummax of
         (sorted_index << 10 | bits) — monotone by construction;
      3. a position's byte = owner's offset-0 byte if it directly follows
         its event record, else the owner's run byte. The dropped-dummy
         case needs no flag: a dropped event's offset-0 byte IS its run
         byte, pre-substituted before packing;
      4. a second single-u32 sort by (p<<8 | byte) extracts the payload.

    Capacity: the cummax packs a record index with 9 payload bits, so
    R = M + out_cap <= 2^22 (callers fall back to the searchsorted path
    above this; superblock framing keeps real containers below it)."""
    M = first.size
    BIG = jnp.uint32(0xFFFFFFFF)
    first_eff = jnp.where(dropped, run_byte, first).astype(U32)
    val9 = first_eff | (run_byte.astype(U32) == 0).astype(U32) << 8
    ev_keys = jnp.where(pcnt > 0, (pstart.astype(U32) << 10) | val9, BIG)
    positions = jnp.arange(out_cap, dtype=U32)
    keys = jnp.concatenate([ev_keys, (positions << 10) | U32(1 << 9)])
    s = jax.lax.sort(keys)
    is_ev = ((s >> 9) & 1) == 0          # excluded events (BIG) sort as
    iota = jnp.arange(M + out_cap, dtype=U32)   # positions past the tail
    fill = jax.lax.cummax(
        jnp.where(is_ev, (iota << 10) | (s & U32(0x3FF)), U32(0)))
    bits = fill & U32(0x1FF)
    after_ev = jnp.concatenate([jnp.zeros(1, jnp.bool_), is_ev[:-1]])
    byte = jnp.where(after_ev, bits & U32(0xFF),
                     jnp.where((bits >> 8) & 1 > 0, U32(0x00), U32(0xFF)))
    # positions to the front in p order; events (BIG) and the BIG records'
    # p-field (2^22-1 > any real p, since out_cap <= 2^22 - M) to the tail
    key2 = jnp.where(is_ev, BIG, ((s >> 10) << 8) | byte)
    s2 = jax.lax.sort(key2)
    out = jnp.where(positions < total.astype(U32),
                    (s2 & U32(0xFF))[:out_cap], 0)
    return out.astype(jnp.uint8)


# ------------------------------------------------- bitonic merge expansion
#
# _expand_sort pays two full lax.sort passes (log^2 N compare-exchange
# stages) over M events + out_cap positions. But BOTH record streams are
# already sorted by key: event pstarts are non-decreasing in lane-major
# order (within a lane pstart grows with time; lane i's payload region
# precedes lane i+1's), and positions are an iota. Expansion is therefore a
# MERGE of two sorted sequences — log N bitonic-merge stages — and the
# "extract positions in p order" step (the second sort) is free: replaying
# the recorded compare-exchange decisions BACKWARDS returns every record to
# its pre-merge slot, carrying the assigned byte. ~20x fewer passes than
# two sorts.

def _bitonic_merge(keys):
    """Sort a bitonic (ascending-then-descending) power-of-2 u32 array.

    Returns (sorted_keys, swap_masks); masks replay the permutation."""
    R2 = keys.shape[0]
    swaps = []
    d = R2 // 2
    while d >= 1:
        k2 = keys.reshape(-1, 2, d)
        a, b = k2[:, 0], k2[:, 1]
        sw = a > b
        swaps.append(sw)
        keys = jnp.stack([jnp.where(sw, b, a), jnp.where(sw, a, b)],
                         axis=1).reshape(R2)
        d //= 2
    return keys, swaps


def _bitonic_unmerge(vals, swaps):
    """Replay recorded swaps in reverse: vals return to pre-merge slots."""
    R2 = vals.shape[0]
    d = 1
    for sw in reversed(swaps):
        v2 = vals.reshape(-1, 2, d)
        a, b = v2[:, 0], v2[:, 1]
        vals = jnp.stack([jnp.where(sw, b, a), jnp.where(sw, a, b)],
                         axis=1).reshape(R2)
        d *= 2
    return vals


def _expand_merge(first, run_byte, pcnt, pstart, dropped, total,
                  out_cap: int):
    """Merge-based expansion over FLAT LANE-MAJOR event fields [M].

    PRECONDITION: pstart is non-decreasing over the flat order (lane-major
    flattening gives this; the time-major twins transpose first).

    Record key: pstart<<10 | tag, with tag 0 = non-contributing event,
    1..512 = contributing event (tag = val9+1, val9 = runflag<<8 | first
    byte — unique per pstart since contributing pstarts are unique),
    1023 = position p (key p<<10|1023 sorts after the owning event).
    Owner forward-fill = cummax over contributing keys (monotone).
    Capacity: pstart < 2^22, same bound as _expand_sort."""
    M = first.size
    first_eff = jnp.where(dropped, run_byte, first).astype(U32)
    val9 = first_eff | ((run_byte.astype(U32) == 0).astype(U32) << 8)
    contrib = pcnt > 0
    ev_keys = (pstart.astype(U32) << 10) | jnp.where(contrib, val9 + 1,
                                                     U32(0))
    R2 = 1 << (M + out_cap - 1).bit_length()
    positions = jnp.arange(out_cap, dtype=U32)
    pos_keys = (positions << 10) | U32(1023)
    pad = jnp.full(R2 - M - out_cap, 0xFFFFFFFF, U32)
    arr = jnp.concatenate([ev_keys, jnp.concatenate([pos_keys, pad])[::-1]])
    s, swaps = _bitonic_merge(arr)

    tag = s & U32(1023)
    is_contrib = (tag >= 1) & (tag <= 512)
    fill = jax.lax.cummax(jnp.where(is_contrib, s, U32(0)))
    p = s >> 10
    v9 = (fill & U32(1023)) - 1  # val9 of the owner (runflag<<8 | first)
    byte = jnp.where(p == (fill >> 10), v9 & U32(0xFF),
                     jnp.where((v9 >> 8) & 1 > 0, U32(0x00), U32(0xFF)))
    byte = jnp.where(p < total.astype(U32), byte, U32(0))
    back = _bitonic_unmerge(jnp.where(tag == 1023, byte, U32(0)), swaps)
    out = back[M:][::-1][:out_cap]
    return out.astype(jnp.uint8)


def materialize(events, out_cap: int):
    """Build the concatenated payload (static size out_cap ≥ total).

    Returns (payload u8 [out_cap], lane_sizes i32 [K]). Expansion is the
    two-sort _expand_sort; the merge-based _expand_merge is its tested
    alternative (tests/test_compaction.py). Which is faster on the GPU is
    not measured yet."""
    M = events.size
    if M + out_cap > (1 << 22):
        return _materialize_searchsorted(events, out_cap)
    _, first, run_byte, _ = event_fields(events)
    pcnt, pstart, dropped, lane_sizes, total = payload_layout(events)
    out = _expand_sort(first.reshape(-1), run_byte.reshape(-1), pcnt,
                       pstart, dropped, total, out_cap)
    return out, lane_sizes


def _materialize_searchsorted(events, out_cap: int, may_drop=True):
    """Original gather-based expansion (fallback above the sort-capacity
    bound; also the readable spec the sort path is tested against)."""
    emit, first, run_byte, _ = event_fields(events)
    pcnt, pstart, dropped, lane_sizes, total = payload_layout(events, may_drop)
    # event start positions: non-contributing events share the next event's
    # start; searchsorted(side='right')-1 then picks the last (the owner).
    positions = jnp.arange(out_cap, dtype=I32)
    eid = jnp.searchsorted(pstart, positions, side="right") - 1
    eid = jnp.clip(eid, 0)
    is_first_byte = (positions == pstart[eid]) & ~dropped[eid]
    byte = jnp.where(is_first_byte, first.reshape(-1)[eid],
                     run_byte.reshape(-1)[eid])
    byte = jnp.where(positions < total, byte, 0)
    return byte, lane_sizes


def lane_layout(events):
    """Back-compat summary: (None, None, lane_sizes, lane_offsets, total)."""
    _, _, _, lane_sizes, total = payload_layout(events)
    lane_offsets = jnp.cumsum(lane_sizes) - lane_sizes
    return None, None, lane_sizes, lane_offsets, total


# ----------------------------------------------------- transposed variants
#
# The GPU encode kernels produce events time-major ([E, K]); these twins
# consume that layout directly, saving an 8-byte-per-symbol device
# transpose. Record ORDER inside the sort is irrelevant (the sort
# re-orders anyway) — only the pstart VALUES must reflect the lane-major
# payload layout, which the column-wise cumsums below compute.

CUMSUM_DOT_MAX_E = 4096


def _cumsum_rows_dot(cnt):
    """Inclusive per-COLUMN cumsum of cnt [E, K] as one triangular dot.

    tri @ cnt is one [E,E]@[E,K] matmul. Exact: cnt and all partial sums
    stay < 2^24 (pstart capacity is 2^22), f32-representable; HIGHEST
    precision keeps the dot in full f32 (no bf16 or TF32 operand rounding).

    The [E,E] triangle is O(E^2) memory — above CUMSUM_DOT_MAX_E (16 M
    entries = 64 MB f32) it would dominate or run out of memory
    (single-shot encodes of tens of MB reach E~2^16), so fall back to
    jnp.cumsum, which is O(E*K). Whether the dot or jnp.cumsum is faster
    on the GPU is not measured yet."""
    E = cnt.shape[0]
    if E > CUMSUM_DOT_MAX_E:
        return jnp.cumsum(cnt.astype(I32), axis=0)
    tri = (jax.lax.broadcasted_iota(I32, (E, E), 0)
           >= jax.lax.broadcasted_iota(I32, (E, E), 1)).astype(jnp.float32)
    out = jax.lax.dot_general(tri, cnt.astype(jnp.float32),
                              (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
    return out.astype(I32)


def payload_layout_t(events_t, may_drop=True):
    """events_t [E, K] -> (pcnt [E,K], pstart [E,K], dropped [E,K],
    lane_sizes [K], total).

    may_drop: True (one-shot encode: each lane's first emitting event
    loses its dummy byte), or a [K] bool mask for CONTINUATION chunks of a
    resumable encode — only lanes that have NEVER emitted in an earlier
    chunk may still drop (codecs/resume.py)."""
    emit, _, _, run_len = event_fields(events_t)
    cnt = jnp.where(emit, 1 + run_len, 0).astype(I32)
    cum_lane = _cumsum_rows_dot(cnt)                # per-lane inclusive
    prior = cum_lane - cnt
    first_emit = emit & (prior == 0)
    if isinstance(may_drop, bool):
        dropped = first_emit if may_drop else jnp.zeros_like(emit)
    else:
        dropped = first_emit & may_drop[None, :]
    dcnt = dropped.astype(I32)
    pcnt = cnt - dcnt
    # exclusive cumsum of pcnt = (inclusive cnt) - (inclusive dropped) - pcnt
    pin_lane = cum_lane - _cumsum_rows_dot(dcnt) - pcnt
    lane_sizes = cum_lane[-1, :] - dropped.sum(axis=0, dtype=I32)
    lane_offsets = jnp.cumsum(lane_sizes) - lane_sizes
    pstart = pin_lane + lane_offsets[None, :]
    total = lane_sizes.sum()
    return pcnt, pstart, dropped, lane_sizes, total


# ------------------------------------------------- per-lane merge expansion
#
# The flat two-sort expansion pays two full lax.sort passes over
# M + out_cap ≈ 3M u32. But per LANE the two record streams are each
# already sorted: event pin offsets are nondecreasing in time, positions
# are an iota. Expansion per lane is therefore a bitonic MERGE — log2(R2)
# roll-based compare-exchange stages along the MINOR axis of a [K, R2]
# tile (R2 ≈ E + l2), plus a reversed swap-replay to return position
# records to their slots: ~22 elementwise stages instead of ~2·log^2
# sort stages.

def _merge_stages(arr):
    """Sort a per-row bitonic (asc-then-desc) [K, R2] u32 array ascending.

    Returns (sorted, swap_masks) where each mask holds the LOWER-index
    swap decisions of one compare-exchange stage (partner = i ^ d)."""
    R2 = arr.shape[1]
    iota = jax.lax.broadcasted_iota(I32, (1, R2), 1)
    swaps = []
    d = R2 // 2
    while d >= 1:
        up = jnp.roll(arr, -d, axis=1)
        dn = jnp.roll(arr, d, axis=1)
        lower = (iota & d) == 0
        sw_low = lower & (arr > up)
        arr = jnp.where(lower,
                        jnp.where(sw_low, up, arr),
                        jnp.where(jnp.roll(sw_low, d, axis=1), dn, arr))
        swaps.append(sw_low)
        d //= 2
    return arr, swaps


def _unmerge_stages(vals, swaps):
    """Replay recorded swaps in reverse: vals return to pre-merge slots."""
    R2 = vals.shape[1]
    iota = jax.lax.broadcasted_iota(I32, (1, R2), 1)
    d = 1
    for sw_low in reversed(swaps):
        up = jnp.roll(vals, -d, axis=1)
        dn = jnp.roll(vals, d, axis=1)
        lower = (iota & d) == 0
        vals = jnp.where(lower,
                         jnp.where(sw_low, up, vals),
                         jnp.where(jnp.roll(sw_low, d, axis=1), dn, vals))
        d *= 2
    return vals


def _expand_rows(first_T, run_T, pcnt_T, pin_T, dropped_T, lane_sizes,
                 l2: int):
    """Per-lane expansion to padded byte rows [K, l2].

    Operands are LANE-MAJOR [K, E]; pin_T is the PER-LANE exclusive byte
    cumsum (no lane offsets — capacity bound pin < 2^22 is per lane and
    always holds). Record scheme of _expand_merge (tag 0 non-contributing,
    1..512 contributing = val9+1, 1023 position), laid out
    [events | 0xFFFFFFFF pad | positions reversed] so each row is bitonic."""
    K_, E = first_T.shape
    first_eff = jnp.where(dropped_T, run_T, first_T).astype(U32)
    val9 = first_eff | ((run_T.astype(U32) == 0).astype(U32) << 8)
    contrib = pcnt_T > 0
    ev_keys = (pin_T.astype(U32) << 10) | jnp.where(contrib, val9 + 1,
                                                    U32(0))
    R2 = 1 << (E + l2 - 1).bit_length()
    pad = jnp.full((K_, R2 - E - l2), 0xFFFFFFFF, U32)
    pos_rev = jnp.broadcast_to(
        (jnp.arange(l2 - 1, -1, -1, dtype=U32) << 10) | U32(1023),
        (K_, l2))
    arr = jnp.concatenate([ev_keys, pad, pos_rev], axis=1)
    s, swaps = _merge_stages(arr)
    tag = s & U32(1023)
    is_contrib = (tag >= 1) & (tag <= 512)
    fill = jax.lax.cummax(jnp.where(is_contrib, s, U32(0)), axis=1)
    p = s >> 10
    v9 = (fill & U32(1023)) - 1
    byte = jnp.where(p == (fill >> 10), v9 & U32(0xFF),
                     jnp.where((v9 >> 8) & 1 > 0, U32(0x00), U32(0xFF)))
    byte = jnp.where(p < lane_sizes[:, None].astype(U32), byte, U32(0))
    back = _unmerge_stages(jnp.where(tag == U32(1023), byte, U32(0)), swaps)
    return back[:, R2 - l2:][:, ::-1].astype(jnp.uint8)


def materialize_rows_t(events_t, l2: int, may_drop=True):
    """Padded per-lane payload rows for time-major [E, K] event grids.

    Returns (rows [K, l2] u8, lane_sizes [K]): row i holds lane i's payload
    bytes 0..lane_sizes[i] (zero beyond); the container's flat lane-major
    payload is row slicing. Requires l2 >= max lane size."""
    emit, first, run_byte, run_len = event_fields(events_t)
    cnt = jnp.where(emit, 1 + run_len, 0).astype(I32)
    cum_lane = _cumsum_rows_dot(cnt)
    prior = cum_lane - cnt
    first_emit = emit & (prior == 0)
    if isinstance(may_drop, bool):
        dropped = first_emit if may_drop else jnp.zeros_like(emit)
    else:
        dropped = first_emit & may_drop[None, :]
    dcnt = dropped.astype(I32)
    pcnt = cnt - dcnt
    pin_lane = cum_lane - _cumsum_rows_dot(dcnt) - pcnt
    lane_sizes = cum_lane[-1, :] - dropped.sum(axis=0, dtype=I32)
    rows = _expand_rows(first.T, run_byte.T, pcnt.T, pin_lane.T, dropped.T,
                        lane_sizes, l2)
    return rows, lane_sizes


def materialize_t(events_t, out_cap: int, may_drop=True):
    """materialize() twin for time-major [E, K] event grids.

    Uses the two-sort expansion (see materialize()). Sort order is layout-independent; only the
    pstart VALUES encode the lane-major payload layout."""
    M = events_t.size
    if M + out_cap > (1 << 22):
        # above the sort path's pstart<<10 key-packing capacity; the
        # searchsorted fallback covers every may_drop flavor (bool or mask)
        return _materialize_searchsorted(events_t.T, out_cap, may_drop)
    _, first, run_byte, _ = event_fields(events_t)
    pcnt, pstart, dropped, lane_sizes, total = payload_layout_t(
        events_t, may_drop)
    out = _expand_sort(first.T.reshape(-1), run_byte.T.reshape(-1),
                       pcnt.T.reshape(-1), pstart.T.reshape(-1),
                       dropped.T.reshape(-1), total, out_cap)
    return out, lane_sizes
