"""Sort-based materialize == searchsorted spec (ops/compaction.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cpprcoder_tpu.ops import compaction


def _random_events(rng, k, e):
    """Random-but-plausible event grids: emit flag, byte, carry, run."""
    emit = rng.random((k, e)) < 0.6
    first = rng.integers(0, 256, (k, e)).astype(np.uint32)
    carry = rng.integers(0, 2, (k, e)).astype(np.uint32)
    run = rng.integers(0, 5, (k, e)).astype(np.uint32)
    ev = (emit.astype(np.uint32) << 31) | (first << 23) | (carry << 22) | run
    ev[~emit] = 0
    # every lane needs at least one emitting event (the dropped dummy)
    ev[:, 0] = (1 << 31) | (first[:, 0] << 23)
    return jnp.asarray(ev)


def test_sort_path_matches_searchsorted_spec():
    rng = np.random.default_rng(42)
    for k, e in ((4, 16), (16, 33), (64, 65)):
        events = _random_events(rng, k, e)
        total = int(compaction.payload_layout(events)[4])
        out_cap = max(16, total + 7)
        a, sa = compaction.materialize(events, out_cap)
        b, sb = compaction._materialize_searchsorted(events, out_cap)
        assert (np.asarray(sa) == np.asarray(sb)).all()
        assert (np.asarray(a) == np.asarray(b)).all(), (k, e)


def test_fallback_above_capacity(monkeypatch):
    rng = np.random.default_rng(1)
    events = _random_events(rng, 4, 8)
    total = int(compaction.payload_layout(events)[4])
    # force the fallback by shrinking the bound
    a, _ = compaction.materialize(events, total + 2)
    b, _ = compaction._materialize_searchsorted(events, total + 2)
    assert (np.asarray(a) == np.asarray(b)).all()


def test_merge_path_matches_sort_and_spec():
    """_expand_merge == _expand_sort == searchsorted on randomized grids,
    including empty lanes, run-heavy events, and all-emitting lanes."""
    rng = np.random.default_rng(7)
    for k, e in ((4, 16), (16, 33), (64, 65), (128, 40)):
        events = np.array(_random_events(rng, k, e))
        events[1, :] = 0                      # a lane that emits nothing
        events[2, :] = (1 << 31) | (0xAB << 23) | 3   # run-heavy lane
        events = jnp.asarray(events)
        pl = compaction.payload_layout(events)
        total = int(pl[4])
        out_cap = max(16, total + 5)
        _, first, run_byte, _ = compaction.event_fields(events)
        args = (first.reshape(-1), run_byte.reshape(-1), pl[0], pl[1],
                pl[2], pl[4], out_cap)
        a = np.asarray(compaction._expand_merge(*args))
        b = np.asarray(compaction._expand_sort(*args))
        c, _ = compaction._materialize_searchsorted(events, out_cap)
        assert (a == b).all(), (k, e)
        assert (a == np.asarray(c)).all(), (k, e)


def test_materialize_t_merge_matches_lane_major():
    rng = np.random.default_rng(9)
    for k, e in ((8, 24), (32, 17)):
        events = _random_events(rng, k, e)
        total = int(compaction.payload_layout(events)[4])
        out_cap = max(16, total + 9)
        a, sa = compaction.materialize(events, out_cap)
        b, sb = compaction.materialize_t(events.T, out_cap)
        assert (np.asarray(sa) == np.asarray(sb)).all()
        assert (np.asarray(a) == np.asarray(b)).all()


def test_materialize_t_mask_above_capacity():
    """A may_drop MASK above the merge capacity bound must take the
    searchsorted fallback and stay correct (ADVICE r2 finding 1)."""
    rng = np.random.default_rng(3)
    k, e = 8, 16
    events = _random_events(rng, k, e)
    mask = np.zeros(k, bool)
    mask[::2] = True
    total = int(compaction.payload_layout_t(events.T, jnp.asarray(mask))[4])
    out_cap = max(16, total + 3)
    want, sw = compaction.materialize_t(events.T, out_cap,
                                        jnp.asarray(mask))
    # the searchsorted fallback (taken above the capacity bound) must agree
    # with the merge path for a masked may_drop too
    got, sg = compaction._materialize_searchsorted(
        events, out_cap, jnp.asarray(mask))
    assert (np.asarray(sw) == np.asarray(sg)).all()
    assert (np.asarray(want) == np.asarray(got)).all()


def test_materialize_rows_t_matches_flat():
    # padded per-lane rows, concatenated by true sizes, must equal the
    # flat lane-major payload byte for byte (merge expansion vs two-sort)
    import numpy as np

    from cpprcoder_tpu.models.cxmodel import rcx_params
    from cpprcoder_tpu.ops import rcx_ops
    from cpprcoder_tpu.utils.shapes import bucket

    data = (b"the quick brown fox jumps over the lazy dog " * 200
            + bytes(range(256)) * 8)
    x = np.frombuffer(data, np.uint8)
    n = len(x)
    k, inc, cl, cbits = rcx_params(n)
    stride = -(-n // k)
    steps = bucket(stride)
    x2d = jnp.asarray(rcx_ops._pad2d_chunked(x, steps, k, stride))
    ev, ls, tot = rcx_ops._encode_fn(steps, k, inc, cl, cbits)(
        x2d, jnp.uint32(n))
    ev_t = ev.T
    cap = bucket(int(tot) + 8)
    ref_payload, ref_sizes = compaction.materialize_t(ev_t, cap)
    l2 = bucket(int(np.asarray(ref_sizes).max()) + 1)
    rows, sizes = compaction.materialize_rows_t(ev_t, l2)
    assert (np.asarray(ref_sizes) == np.asarray(sizes)).all()
    rn, sz = np.asarray(rows), np.asarray(sizes)
    flat = np.concatenate([rn[i, : sz[i]] for i in range(k)])
    assert (flat == np.asarray(ref_payload)[: int(tot)]).all()


# --------------------------------------------- rows expansion vs numpy


def _rand_events(e, k, seed, p_emit=0.5, run_max=3):
    rng = np.random.default_rng(seed)
    emit = rng.random((e, k)) < p_emit
    first = rng.integers(0, 256, (e, k), dtype=np.uint32)
    carry = rng.integers(0, 2, (e, k), dtype=np.uint32)
    run = rng.integers(0, run_max + 1, (e, k), dtype=np.uint32)
    ev = (np.uint32(1) << 31) | (first << 23) | (carry << 22) | run
    return np.where(emit, ev, 0).astype(np.uint32)


def _decode_lanes(events_t, may_drop=None):
    """Plain per-lane event decoder (FORMATS.md): each emitting event is
    its first byte then `run` copies of 0xFF (0x00 when the carry bit is
    set); a lane's first emitted byte (the dummy) is dropped where allowed."""
    e, k = events_t.shape
    lanes = []
    for i in range(k):
        out = bytearray()
        for ev in events_t[:, i].tolist():
            if ev >> 31:
                run_byte = 0x00 if (ev >> 22) & 1 else 0xFF
                out.append((ev >> 23) & 0xFF)
                out.extend([run_byte] * (ev & ((1 << 22) - 1)))
        if out and (may_drop is None or may_drop[i]):
            out = out[1:]
        lanes.append(bytes(out))
    return lanes


def _check_rows(events, may_drop=None):
    want = _decode_lanes(events, may_drop)
    l2 = 8
    while l2 < max(len(w) for w in want):
        l2 *= 2
    md = True if may_drop is None else jnp.asarray(may_drop)
    rows, sizes = compaction.materialize_rows_t(jnp.asarray(events), l2, md)
    rows, sizes = np.asarray(rows), np.asarray(sizes)
    assert sizes.tolist() == [len(w) for w in want]
    for i, w in enumerate(want):
        assert rows[i, : len(w)].tobytes() == w
        assert not rows[i, len(w):].any()


@pytest.mark.parametrize("e,k,seed", [
    (18, 8, 0), (34, 128, 1), (130, 200, 2), (257, 64, 3)])
def test_materialize_rows_t_matches_numpy(e, k, seed):
    _check_rows(_rand_events(e, k, seed))


def test_materialize_rows_t_may_drop_mask():
    md = np.zeros(16, bool)
    md[::2] = True
    _check_rows(_rand_events(40, 16, 7), md)


def test_materialize_rows_t_empty_and_sparse_lanes():
    ev = _rand_events(24, 12, 9, p_emit=0.15)
    ev[:, 3] = 0                     # lane with no events at all
    _check_rows(ev)
