"""CT-RCX — the context-conditioned quantized adaptive range coder (format
spec: reference/rcx_ref.py; model: models/cxmodel.py): the XLA scans and
the host container framing every device route shares.

Same coder core as CT-RCQ (ops/rcq_ops.py), two differences:

  - CHUNKED lane layout: lane i owns contiguous bytes
    x[i*stride:(i+1)*stride], stride = ceil(n/K) — so each lane's previous
    window symbol is the true previous byte, the order-1 context. stride is
    a pure function of (n, K): containers never depend on step bucketing.
  - model = C[2^cbits, 256] context rows; rescale/quantize vectorized over
    rows; ctx = prev >> (8 - cbits) carried per lane through the scan.

The scans are the plain XLA twin of the GPU kernels (ops/rcx_cuda.py): the
route on the CPU, the reference on the card, and the route for shapes the
kernels do not take. encode_many/decode_many frame the containers for both;
the route passes in the coder loop. Byte-identical containers across
oracle/jax are asserted in tests/test_rcx.py.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu.models.cxmodel import (
    QBITS,
    QTOTAL,
    WLOG_DEFAULT,
    quantize_rows_jnp,
    rcx_params,
    rescale_rows_jnp,
)
from cpprcoder_tpu.ops import rc_common
from cpprcoder_tpu.ops.rcq_ops import _rows_fn, _row_select
from cpprcoder_tpu.reference.rc_ref import (
    _lane_desc,
    _parse_lane_desc,
    _write_sizes,
)
from cpprcoder_tpu.utils.shapes import bucket

U32 = jnp.uint32
I32 = jnp.int32

N_SLOTS = 2  # same bound as CT-RCQ: range_new >= t >= 2^(24-QBITS) = 2^9


def _pad2d_chunked(x: np.ndarray, steps: int, k: int,
                   stride: int) -> np.ndarray:
    """x2d [steps, k] with x2d[j, i] = x[i*stride + j] (zero past ends)."""
    buf = np.zeros(k * stride, np.uint8)
    buf[: len(x)] = x
    out = np.zeros((steps, k), np.uint8)
    out[:stride] = buf.reshape(k, stride).T
    return out


# ------------------------------------------------------------------ encode

@lru_cache(maxsize=64)
def _encode_fn(steps: int, k: int, inc: int, climit_log2: int, cbits: int,
               wlog: int = 0):
    """run(x2d [steps, k] u8, n u32) -> (events [k, 2*steps+2], lane_sizes,
    total). The lane stride ceil(n/k) is derived from n inside, so one
    compiled program serves every n with the same step bucket (and the
    function vmaps over containers).

    v2 window schedule (wlog > 0): the scan runs over WINDOW chunks of
    W = 2^wlog steps; the model requantizes once per chunk (up to 3
    conditional halvings + quantize, models/cxmodel.py) and the W steps
    inside code against the frozen tables while counts keep updating.
    wlog=0 is bit-identical to the round-4 per-step schedule."""
    climit = 1 << climit_log2
    W = 1 << wlog
    steps_w = -(-steps // W) * W

    @jax.jit
    def run(x2d, n):
        stride = (n + U32(k - 1)) // U32(k)
        st = rc_common.make_state(k)
        lane_ids = jnp.arange(k, dtype=U32)
        C0 = jnp.ones((1 << cbits, 256), U32)
        pad = steps_w - x2d.shape[0]
        xp = jnp.concatenate(
            [x2d, jnp.zeros((pad, k), x2d.dtype)]) if pad else x2d
        xw = xp.reshape(steps_w // W, W, k)

        def window(carry, xchunk):
            st, t_idx, C, prev = carry
            C = rescale_rows_jnp(C, climit)
            q = quantize_rows_jnp(C)
            cums_excl = jnp.cumsum(q, axis=1, dtype=U32) - q
            evs_w = []
            for w in range(W):
                xt = xchunk[w]
                syms = xt.astype(I32)
                ctx = (prev >> (8 - cbits)).astype(I32) if cbits \
                    else jnp.zeros(k, I32)
                active = (t_idx < stride) & (lane_ids * stride + t_idx < n)
                c = cums_excl[ctx, syms]
                f = q[ctx, syms]
                t = st[2] >> QBITS
                is_top = (c + f) == U32(QTOTAL)
                st, evs = rc_common.encode_symbol(st, t, c, f, is_top,
                                                  active, N_SLOTS)
                C = C + jnp.zeros_like(C).at[ctx, syms].add(
                    jnp.where(active, U32(inc), U32(0)))
                prev = jnp.where(active, xt, prev)
                t_idx = t_idx + 1
                evs_w.append(evs)
            return (st, t_idx, C, prev), jnp.stack(evs_w)

        (st, _, _, _), evs = lax.scan(
            window, (st, U32(0), C0, jnp.zeros(k, jnp.uint8)), xw)
        # evs [nw, W, N_SLOTS, k] -> lane-major [k, 2*steps_w], trimmed
        flush_evs = rc_common.flush(st)
        events = jnp.concatenate(
            [jnp.transpose(evs, (3, 0, 1, 2)).reshape(k, -1)[:, :2 * steps],
             jnp.transpose(flush_evs, (1, 0))], axis=1)
        from cpprcoder_tpu.ops import compaction

        _, _, lane_sizes, _, total = compaction.lane_layout(events)
        return events, lane_sizes, total

    return run


def rcx_header(n: int, k: int, wide: bool, inc: int, climit_log2: int,
               cbits: int, wlog: int) -> ByteWriter:
    """Container header up to the size table (reference/rcx_ref.py)."""
    return (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
            .u8(climit_log2).u8(QBITS).u8(cbits).u8(wlog))


# ------------------------------------------------------------------ decode

@lru_cache(maxsize=64)
def _decode_fn(steps: int, k: int, inc: int, climit_log2: int, cbits: int,
               l4: int, wlog: int = 0):
    """run(rows_w [k, l4] u32, n u32) -> symbols [steps, k] u8 (the lane
    stride is derived from n, as in _encode_fn)."""
    climit = 1 << climit_log2
    W = 1 << wlog
    steps_w = -(-steps // W) * W

    @jax.jit
    def run(rows_w, n):
        stride = (n + U32(k - 1)) // U32(k)
        rng = jnp.full(k, 0xFFFFFFFF, U32)
        code = rows_w[:, 0]
        q0 = jnp.zeros(k, U32)
        q1 = jnp.zeros(k, U32)
        occ = jnp.zeros(k, U32)
        widx = jnp.ones(k, I32)
        lane_ids = jnp.arange(k, dtype=U32)
        C0 = jnp.ones((1 << cbits, 256), U32)

        def window(carry, _):
            rng, code, q0, q1, occ, widx, t_idx, C, prev = carry
            C = rescale_rows_jnp(C, climit)
            q = quantize_rows_jnp(C)
            cums_excl = jnp.cumsum(q, axis=1, dtype=U32) - q
            outs = []
            for _w in range(W):
                need = occ < U32(N_SLOTS)
                word = _row_select(rows_w, jnp.where(need, widx, I32(-1)))
                q0 = q0 | jnp.where(occ == 0, word, word >> 8)
                q1 = q1 | jnp.where(occ == 0, U32(0), word << 24)
                occ = jnp.where(need, occ + 4, occ)
                widx = widx + need.astype(I32)

                ctx = (prev >> (8 - cbits)).astype(I32) if cbits \
                    else jnp.zeros(k, I32)
                active = (t_idx < stride) & (lane_ids * stride + t_idx < n)
                row_c = cums_excl[ctx]                 # [K, 256]
                row_q = q[ctx]
                t = rng >> QBITS
                le = row_c * t[:, None] <= code[:, None]
                s = jnp.sum(le, axis=1).astype(I32) - 1
                c = jnp.take_along_axis(row_c, s[:, None], axis=1)[:, 0]
                f = jnp.take_along_axis(row_q, s[:, None], axis=1)[:, 0]
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
                C = C + jnp.zeros_like(C).at[ctx, s].add(
                    jnp.where(active, U32(inc), U32(0)))
                prev = jnp.where(active, s.astype(jnp.uint8), prev)
                t_idx = t_idx + 1
                outs.append(s.astype(jnp.uint8))
            return (rng, code, q0, q1, occ, widx, t_idx, C, prev), \
                jnp.stack(outs)

        _, out = lax.scan(
            window,
            (rng, code, q0, q1, occ, widx, U32(0), C0,
             jnp.zeros(k, jnp.uint8)),
            None, length=steps_w // W)
        # [nw, W, k] -> [steps, k]; byte j of lane i = x[i*stride + j]
        return out.reshape(steps_w, k)[:steps]

    return run


def _parse_rcx_header(r: ByteReader):
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit_log2 = r.u8()
    qbits = r.u8()
    cbits = r.u8()
    wlog = r.u8()
    if qbits != QBITS:
        raise CorruptContainerError(
            f"container qbits {qbits} != build {QBITS}")
    if cbits > 8:
        raise CorruptContainerError(f"bad cbits {cbits}")
    if wlog > 3:
        raise CorruptContainerError(f"bad wlog {wlog}")
    return n, k, wide, inc, climit_log2, cbits, wlog




# ------------------------------------------------- the kernels' XLA twins

def xla_events(x3d, n_vec, *, inc, climit_log2, cbits, wlog):
    """x [nc, steps, K] u8, n [nc] i32 -> events [nc, 2*steps+2, K] u32:
    the XLA scan vmapped over containers (twin of rcx_cuda.kernel_events)."""
    _, steps, k = x3d.shape
    fn = _encode_fn(steps, k, inc, climit_log2, cbits, wlog)
    return jax.vmap(lambda x2d, n: fn(x2d, n)[0].T)(
        x3d, n_vec.astype(U32))


def xla_symbols(rows_w, n_vec, steps, *, inc, climit_log2, cbits, wlog):
    """word rows [nc, K, L4] u32, n [nc] i32 -> symbols [nc, steps, K] u8
    (twin of rcx_cuda.kernel_symbols)."""
    _, k, l4 = rows_w.shape
    fn = _decode_fn(steps, k, inc, climit_log2, cbits, l4, wlog)
    return jax.vmap(fn)(rows_w, n_vec.astype(U32))


# ------------------------------------------------------------ containers
#
# One host framing path builds CT-RCX containers for every device route;
# the route only picks the coder loop (events_fn / symbols_fn: the XLA twins
# above or the CUDA kernels of ops/rcx_cuda.py). Containers sharing (K, inc,
# climit, cbits, wlog, steps) run as one launch of up to LAUNCH_BYTES of
# padded input, so device memory is bounded however many containers a call
# holds:
#
#   encode: host pad -> x [nc, steps, K] -> events_fn -> events [nc, E, K]
#           -> compaction.materialize_t per container -> header+sizes+payload
#   decode: header -> word rows [nc, K, L4] -> symbols_fn -> [nc, steps, K]

LAUNCH_BYTES = 128 << 20  # 128 one-MiB superblocks: ~1 GiB of events
MAT_BATCH = 32            # containers expanded per dispatch (bounds memory)


def _launches(idx: list[int], steps: int, k: int) -> list[list[int]]:
    per = max(1, LAUNCH_BYTES // (steps * k))
    return [idx[i:i + per] for i in range(0, len(idx), per)]


@lru_cache(maxsize=64)
def _events_fn(events_fn, inc, climit_log2, cbits, wlog):
    """One dispatch: events [nc, E, K] and the payload bytes per lane
    [nc, K] (every emitting event's 1 + run bytes, less the lane's dropped
    dummy byte)."""
    from cpprcoder_tpu.ops.compaction import event_fields

    @jax.jit
    def run(x3d, n_vec):
        events = events_fn(x3d, n_vec, inc=inc, climit_log2=climit_log2,
                           cbits=cbits, wlog=wlog)
        emit, _, _, run_len = event_fields(events)
        cnt = jnp.where(emit, 1 + run_len, 0).sum(axis=1, dtype=I32)
        return events, cnt - jnp.any(emit, axis=1).astype(I32)

    return run


@lru_cache(maxsize=64)
def _payloads_fn(out_cap: int):
    from cpprcoder_tpu.ops.compaction import materialize_t

    return jax.jit(jax.vmap(lambda ev: materialize_t(ev, out_cap)[0]))


def _encode_group(chunks, k, inc, climit_log2, cbits, wlog, steps,
                  events_fn):
    from cpprcoder_tpu.utils import profiling

    n_vec = np.asarray([len(x) for x in chunks], np.int32)
    x3d = np.stack([_pad2d_chunked(x, steps, k, -(-len(x) // k))
                    for x in chunks])
    with profiling.phase("enc.scan", int(n_vec.sum())):
        events, sizes = _events_fn(events_fn, inc, climit_log2, cbits,
                                   wlog)(x3d, n_vec)
        sizes = np.asarray(jax.device_get(sizes), np.int64)
    totals = sizes.sum(axis=1)
    mat = _payloads_fn(bucket(int(totals.max())))
    with profiling.phase("enc.materialize", int(totals.sum())):
        payloads = np.concatenate(jax.device_get(
            [mat(events[i:i + MAT_BATCH])
             for i in range(0, len(chunks), MAT_BATCH)]))
    blobs = []
    for i, x in enumerate(chunks):
        wide = bool(sizes[i].max() >= 1 << 16)
        w = rcx_header(len(x), k, wide, inc, climit_log2, cbits, wlog)
        _write_sizes(w, sizes[i].tolist(), wide)
        w.raw(payloads[i, : totals[i]].tobytes())
        blobs.append(w.getvalue())
    return blobs


def encode_many(chunks, params=None, events_fn=xla_events) -> list[bytes]:
    """Encode each chunk to its CT-RCX container (== rcx_ref.rcx_encode).

    params: one dict per chunk of the rcx_encode options (lanes, inc,
    cbits, wlog); None takes the defaults (models/cxmodel.rcx_params)."""
    xs = [as_u8(c) for c in chunks]
    params = params or [{}] * len(xs)
    blobs: list[bytes | None] = [None] * len(xs)
    groups: dict[tuple, list[int]] = {}
    for i, (x, p) in enumerate(zip(xs, params)):
        k, inc, cl, cbits = rcx_params(len(x), p.get("lanes"), p.get("inc"),
                                       p.get("cbits"))
        wlog = WLOG_DEFAULT if p.get("wlog") is None else p["wlog"]
        if len(x) == 0:
            blobs[i] = rcx_header(0, k, False, inc, cl, cbits,
                                  wlog).getvalue()
            continue
        steps = bucket(-(-len(x) // k))
        assert steps * 3 + 2 < (1 << rc_common.EV_RUN_BITS), \
            "superblock too large"
        groups.setdefault((k, inc, cl, cbits, wlog, steps), []).append(i)
    for key, idx in groups.items():
        for launch in _launches(idx, key[-1], key[0]):
            for i, b in zip(launch, _encode_group([xs[i] for i in launch],
                                                  *key, events_fn)):
                blobs[i] = b
    return blobs


def _parse(blob):
    r = ByteReader(blob)
    n, k, wide, inc, cl, cbits, wlog = _parse_rcx_header(r)
    sizes = payload = None
    if n:
        sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int32)
        payload = r.rest()
        if int(sizes.sum()) > len(payload):
            raise CorruptContainerError(
                f"size table claims {int(sizes.sum())} payload bytes, "
                f"container has {len(payload)}")
    return n, k, inc, cl, cbits, wlog, sizes, payload


def header_shape(blob) -> tuple[int, int]:
    """(K, cbits) of a CT-RCX container, for the route rule."""
    _, k, _, _, _, cbits, _ = _parse_rcx_header(ByteReader(blob))
    return k, cbits


@lru_cache(maxsize=64)
def _symbols_fn(symbols_fn, steps, k, inc, climit_log2, cbits, wlog, l4,
                p_cap):
    """One dispatch: payloads [nc, p_cap] -> word rows [nc, K, L4] ->
    symbols [nc, steps, K]."""
    rows_fn = jax.vmap(_rows_fn(k, l4, p_cap))

    @jax.jit
    def run(payloads, sizes, n_vec):
        return symbols_fn(rows_fn(payloads, sizes), n_vec, steps, inc=inc,
                          climit_log2=climit_log2, cbits=cbits, wlog=wlog)

    return run


def _decode_group(parsed, k, inc, climit_log2, cbits, wlog, steps,
                  symbols_fn):
    from cpprcoder_tpu.utils import profiling

    l4 = bucket(-(-max(int(p[6].max()) for p in parsed) // 4) + 1)
    p_cap = bucket(max(max(len(p[7]) for p in parsed), 1))
    payloads = np.zeros((len(parsed), p_cap), np.uint8)
    for i, p in enumerate(parsed):
        payloads[i, : len(p[7])] = p[7]
    sizes = np.stack([p[6] for p in parsed])
    n_vec = np.asarray([p[0] for p in parsed], np.int32)
    with profiling.phase("dec.scan", int(n_vec.sum())):
        syms = _symbols_fn(symbols_fn, steps, k, inc, climit_log2, cbits,
                           wlog, l4, p_cap)(payloads, sizes, n_vec)
        arr = np.asarray(jax.device_get(syms))
    out = []
    for i, n in enumerate(n_vec.tolist()):
        stride = -(-n // k)
        out.append(arr[i, :stride].T.reshape(-1)[:n].tobytes())
    return out


def decode_many(blobs, symbols_fn=xla_symbols) -> list[bytes]:
    parsed = [_parse(b) for b in blobs]
    out: list[bytes | None] = [None] * len(blobs)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(parsed):
        n, k, inc, cl, cbits, wlog = p[:6]
        if n == 0:
            out[i] = b""
            continue
        groups.setdefault((k, inc, cl, cbits, wlog, bucket(-(-n // k))),
                          []).append(i)
    for key, idx in groups.items():
        for launch in _launches(idx, key[-1], key[0]):
            for i, b in zip(launch, _decode_group([parsed[i] for i in launch],
                                                  *key, symbols_fn)):
                out[i] = b
    return out
