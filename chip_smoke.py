"""Smoke check of the codec library on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: phases (a)-(e) below
    python chip_smoke.py --four   # four GPUs: the sharded CT-RCX path only

Phases on one GPU, all through the public API:
  (a) CT-RCX on all 11 Canterbury files, on the platform's route (the CUDA
      kernels) and on the XLA twin: container == host oracle, decode == input;
  (b) every registered codec plus the blocksort|mtf1|rle0|adaptive_range
      pipeline on alice29.txt and kennedy.xls: XLA container == host oracle;
  (c) a 256 MiB seeded synth stream through CT-SB with CT-RCX in 1 MiB
      superblocks: full round trip, oracle identity on three superblocks;
      walls of the first call (compiles included) and of a second call;
  (d) CT-RCX kernel route against the XLA twin: median host-clock time of
      calls that return bytes, after a warm-up;
  (e) the card-only checks (CARD_CHECKS, shared with tests/test_chip_smoke.py).

With --four: a 64 MiB synth stream on a 4-GPU ('data', 'lane') mesh
(parallel/sharded_rcx.py), checked against the host oracle on sampled blocks,
against the input after the mesh decode, and against the one-GPU kernel route
on every block.

Exits nonzero, printing no ok line, when JAX finds no GPU or any phase fails;
no phase's error is caught. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from cpprcoder_tpu import compress, decompress, get_codec, list_codecs
from cpprcoder_tpu.bench.synth import synth_stream
from cpprcoder_tpu.reference import rcx_ref

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CANTERBURY = [
    "alice29.txt", "asyoulik.txt", "cp.html", "fields.c", "grammar.lsp",
    "kennedy.xls", "lcet10.txt", "plrabn12.txt", "ptt5", "sum", "xargs.1",
]
PIPELINE = ["blocksort", "mtf1", "rle0", "adaptive_range"]
SLZ4_MAX = 1 << 20      # SLZ4 encode is only right up to here (ROADMAP R2)
ROUTES = (None, "jax")  # the platform's route, the XLA twin


def log(**row) -> None:
    print(json.dumps(row), flush=True)


def corpus(names=CANTERBURY) -> dict[str, bytes]:
    out = {}
    for name in names:
        with open(os.path.join(DATA_DIR, name), "rb") as f:
            out[name] = f.read()
    return out


def route_name(route) -> str:
    return route or "default"


def expect_equal(what: str, got: bytes, want: bytes) -> None:
    if got != want:
        n = min(len(got), len(want))
        diff = next((i for i in range(n) if got[i] != want[i]), n)
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} bytes, "
                             f"first difference at byte {diff}")


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _in_threads(fn, items) -> list:
    """fn over items in a thread pool: XLA compiles release the GIL, so the
    many first-call compilations of a phase overlap. Errors propagate."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(fn, items))


def _roundtrip(job):
    data, codec, route = job
    blob = compress(data, codec=codec, backend=route)
    return blob, decompress(blob, codec=codec, backend=route)


def _ref_encode(job):
    data, codec = job
    return compress(data, codec=codec, backend="ref")


def _host_pool() -> ProcessPoolExecutor:
    """Worker processes for the host oracles (pure numpy, GIL-bound). They
    are spawned with JAX held to the CPU, so only this process opens the
    card; call inside `with`, which stops them."""
    os.environ["JAX_PLATFORMS"], old = "cpu", os.environ.get("JAX_PLATFORMS")
    try:
        pool = ProcessPoolExecutor(
            max_workers=max(1, (os.cpu_count() or 2) // 2),
            mp_context=multiprocessing.get_context("spawn"))
        pool.submit(int).result()        # spawn the workers now
    finally:
        if old is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = old
    return pool


# ------------------------------------------------------------- phase (a)

def phase_corpus(files: dict[str, bytes], routes=ROUTES) -> None:
    """Compiles every shape first (in threads); the walls are warm calls."""
    _in_threads(_roundtrip, [(data, "rcx", route) for data in files.values()
                             for route in routes])
    for name, data in files.items():
        ref = rcx_ref.rcx_encode(data)
        for route in routes:
            blob, t_enc = _timed(compress, data, codec="rcx", backend=route)
            out, t_dec = _timed(decompress, blob, codec="rcx", backend=route)
            expect_equal(f"rcx {name} route={route_name(route)} container",
                         blob, ref)
            expect_equal(f"rcx {name} route={route_name(route)} decode",
                         out, data)
            log(phase="a", file=name, route=route_name(route),
                bytes=len(data), ratio=len(blob) / len(data),
                enc_s=t_enc, dec_s=t_dec)


# ------------------------------------------------------------- phase (b)

def phase_codecs(files: dict[str, bytes]) -> None:
    from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode

    assert all(len(d) <= SLZ4_MAX for d in files.values()), "SLZ4 > 1 MiB"
    jobs = [(name, codec) for name in files for codec in list_codecs()]
    with _host_pool() as pool:
        refs = [pool.submit(_ref_encode, (files[name], codec))
                for name, codec in jobs]
        done = _in_threads(_roundtrip, [(files[name], codec, "jax")
                                        for name, codec in jobs])
        refs = [f.result() for f in refs]
    for (name, codec), (jx, out), rf in zip(jobs, done, refs):
        data = files[name]
        expect_equal(f"{codec} {name} jax vs ref container", jx, rf)
        expect_equal(f"{codec} {name} decode", out, data)
        log(phase="b", codec=codec, file=name, ratio=len(jx) / len(data))
    for name, data in files.items():
        jx = pipeline_encode(data, stages=PIPELINE, backend="jax")
        expect_equal(f"pipeline {name} jax vs ref container", jx,
                     pipeline_encode(data, stages=PIPELINE, backend="ref"))
        expect_equal(f"pipeline {name} decode",
                     pipeline_decode(jx, backend="jax"), data)
        log(phase="b", codec="|".join(PIPELINE), file=name,
            ratio=len(jx) / len(data))


# ------------------------------------------------------------- phase (c)

def stream_containers(blob: bytes) -> list[bytes]:
    """The per-superblock containers of a CT-SB stream (codecs/stream.py)."""
    from cpprcoder_tpu.core.bytesutil import ByteReader

    r = ByteReader(blob)
    r.u8()
    r.u8()
    sizes = r.u32s(r.u32())
    return [r.raw(int(s)).tobytes() for s in sizes]


def phase_stream(total_bytes: int = 256 << 20, sb_log2: int = 20,
                 seed: int = 0) -> None:
    import jax

    from cpprcoder_tpu.codecs.stream import stream_decode, stream_encode

    x = synth_stream(total_bytes, seed=seed)
    blob, t_enc_first = _timed(stream_encode, x, codec="rcx",
                               sb_log2=sb_log2)
    out, t_dec_first = _timed(stream_decode, blob)
    expect_equal("stream round trip", out, x.tobytes())
    again, t_enc = _timed(stream_encode, x, codec="rcx", sb_log2=sb_log2)
    expect_equal("stream encode, second call", again, blob)
    out, t_dec = _timed(stream_decode, blob)
    expect_equal("stream round trip, second call", out, x.tobytes())
    blobs = stream_containers(blob)
    sb = 1 << sb_log2
    for i in sorted({0, len(blobs) // 2, len(blobs) - 1}):
        expect_equal(f"stream superblock {i} vs oracle", blobs[i],
                     rcx_ref.rcx_encode(x[i * sb:(i + 1) * sb]))
    stats = jax.devices()[0].memory_stats() or {}
    log(phase="c", bytes=total_bytes, superblocks=len(blobs),
        ratio=len(blob) / total_bytes, enc_first_s=t_enc_first,
        dec_first_s=t_dec_first, enc_s=t_enc, dec_s=t_dec,
        enc_MBps=total_bytes / t_enc / 1e6, dec_MBps=total_bytes / t_dec / 1e6,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"))


# ------------------------------------------------------------- phase (d)

def _median_time(fn, reps: int) -> float:
    fn()                                   # warm-up: compiles every shape
    times = []
    for _ in range(reps):
        _, t = _timed(fn)
        times.append(t)
    return statistics.median(times)


def phase_timing(inputs: dict[str, list[bytes]], reps: int = 5) -> list:
    """Per input (a list of files, coded one call each), per route: median
    encode and decode wall seconds, plus the payload expansion's share of
    the kernel route's encode (profiling phase enc.materialize)."""
    from cpprcoder_tpu.utils import profiling

    rows = []
    for name, files in inputs.items():
        nbytes = sum(len(f) for f in files)
        row = {"phase": "d", "input": name, "bytes": nbytes}
        for route in ROUTES:
            blobs = [compress(f, codec="rcx", backend=route) for f in files]
            enc = _median_time(lambda: [compress(f, codec="rcx",
                                                 backend=route)
                                        for f in files], reps)
            dec = _median_time(lambda: [decompress(b, codec="rcx",
                                                   backend=route)
                                        for b in blobs], reps)
            key = "default" if route is None else "xla"
            row[f"{key}_enc_s"] = enc
            row[f"{key}_dec_s"] = dec
            row[f"{key}_enc_MBps"] = nbytes / enc / 1e6
            row[f"{key}_dec_MBps"] = nbytes / dec / 1e6
        profiling.reset()
        profiling.enable()
        try:
            for f in files:
                compress(f, codec="rcx")
        finally:
            profiling.disable()
        rep = profiling.report()
        enc_total = sum(rep[p]["wall_s"] for p in ("enc.scan",
                                                   "enc.materialize"))
        row["default_expansion_share"] = (rep["enc.materialize"]["wall_s"]
                                         / enc_total)
        row["enc_speedup"] = row["xla_enc_s"] / row["default_enc_s"]
        row["dec_speedup"] = row["xla_dec_s"] / row["default_dec_s"]
        log(**row)
        rows.append(row)
    return rows


# ------------------------------------------------------------- phase (e)

def _textish(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(97, 123, n // 2, dtype=np.uint8),
                           rng.integers(0, 256, n - n // 2, dtype=np.uint8)
                           ]).tobytes()


def _on_gpu() -> None:
    from cpprcoder_tpu.codecs.base import platform

    assert platform() == "gpu", "card-only check run without a GPU"


def card_encode_identity():
    _on_gpu()
    for n in (1500, 4096):
        data = _textish(n, 5)
        expect_equal(f"kernel encode n={n}",
                     compress(data, codec="rcx", lanes=128),
                     rcx_ref.rcx_encode(data, lanes=128))


def card_decode_roundtrip():
    _on_gpu()
    for n in (1500, 4096):
        data = _textish(n, 6)
        blob = rcx_ref.rcx_encode(data, lanes=128)
        expect_equal(f"kernel decode n={n}",
                     decompress(blob, codec="rcx"), data)


def card_defaults_small_lanes():
    _on_gpu()
    data = corpus(["grammar.lsp"])["grammar.lsp"]     # K=32, cbits 6
    blob = compress(data, codec="rcx")
    expect_equal("kernel grammar.lsp", blob, rcx_ref.rcx_encode(data))
    expect_equal("kernel grammar.lsp decode",
                 decompress(blob, codec="rcx"), data)


def card_cbits_and_wlog():
    _on_gpu()
    data = _textish(3000, 7)
    for opts in ({"cbits": 0}, {"cbits": 4}, {"cbits": 6},
                 {"wlog": 0}, {"wlog": 1}, {"wlog": 3}):
        blob = compress(data, codec="rcx", **opts)
        expect_equal(f"kernel {opts}", blob, rcx_ref.rcx_encode(data, **opts))
        expect_equal(f"kernel {opts} decode",
                     decompress(blob, codec="rcx"), data)


def card_route_rule():
    """cbits 7 needs more shared memory than a block has: the explicit rule
    sends it to the XLA twin; the same input at cbits 6 takes the kernel."""
    from cpprcoder_tpu.ops import rcx_cuda

    _on_gpu()
    data = _textish(3000, 8)
    assert not rcx_cuda.takes(32, 7) and rcx_cuda.takes(32, 6)
    for cbits in (6, 7):
        blob = compress(data, codec="rcx", cbits=cbits)
        expect_equal(f"route cbits={cbits}", blob,
                     rcx_ref.rcx_encode(data, cbits=cbits))
        expect_equal(f"route cbits={cbits} decode",
                     decompress(blob, codec="rcx"), data)


def card_batch_matches_solo():
    _on_gpu()
    codec = get_codec("rcx")
    chunks = [_textish(n, n) for n in (1021, 2311, 3500, 0, 3500)]
    batch = codec.encode_many(chunks)
    for c, b in zip(chunks, batch):
        expect_equal(f"batch vs solo n={len(c)}", b, codec.encode(c))
    for c, d in zip(chunks, codec.decode_many(batch)):
        expect_equal(f"batch decode n={len(c)}", d, c)


def card_kernels_match_xla_twins():
    """Raw event and symbol grids of the kernels == the XLA scans', on one
    1 MiB superblock (K=2048, cbits 4) and at K=8192 (16 lanes a thread)."""
    import jax.numpy as jnp

    from cpprcoder_tpu.models.cxmodel import WLOG_DEFAULT, rcx_params
    from cpprcoder_tpu.ops import rcx_cuda, rcx_ops
    from cpprcoder_tpu.ops.rcq_ops import _rows_fn
    from cpprcoder_tpu.utils.shapes import bucket

    _on_gpu()
    for data, lanes in ((synth_stream(1 << 20, seed=3).tobytes(), None),
                        (_textish(300_000, 9), 8192)):
        x = np.frombuffer(data, np.uint8)
        k, inc, cl, cbits = rcx_params(len(x), lanes)
        stride = -(-len(x) // k)
        steps = bucket(stride)
        kw = dict(inc=inc, climit_log2=cl, cbits=cbits, wlog=WLOG_DEFAULT)
        x3d = jnp.asarray(rcx_ops._pad2d_chunked(x, steps, k, stride)[None])
        n = jnp.asarray([len(x)], jnp.int32)
        ev = rcx_cuda.kernel_events(x3d, n, **kw)
        assert (np.asarray(ev) == np.asarray(
            rcx_ops.xla_events(x3d, n, **kw))).all(), f"events K={k}"
        blob = compress(data, codec="rcx", lanes=lanes)
        _, _, _, _, _, _, sizes, payload = rcx_ops._parse(blob)
        l4 = bucket(-(-int(sizes.max()) // 4) + 1)
        p_cap = bucket(len(payload))
        padded = np.zeros(p_cap, np.uint8)
        padded[: len(payload)] = payload
        rows = _rows_fn(k, l4, p_cap)(jnp.asarray(padded),
                                      jnp.asarray(sizes))[None]
        # positions past a lane's end hold no symbol: compare the bytes
        for fn in (rcx_cuda.kernel_symbols, rcx_ops.xla_symbols):
            grid = np.asarray(fn(rows, n, steps, **kw))[0, :stride]
            expect_equal(f"{fn.__name__} K={k}",
                         grid.T.reshape(-1)[: len(x)].tobytes(), data)


CARD_CHECKS = [card_encode_identity, card_decode_roundtrip,
               card_defaults_small_lanes, card_cbits_and_wlog,
               card_route_rule, card_batch_matches_solo,
               card_kernels_match_xla_twins]


def phase_card() -> None:
    for check in CARD_CHECKS:
        _, t = _timed(check)
        log(phase="e", check=check.__name__, ok=True, s=t)


# ------------------------------------------------------------- --four

def phase_four(total_bytes: int = 64 << 20, block_bytes: int = 1 << 20,
               lanes: int = 2048, inc: int = 16, cbits: int = 4,
               seed: int = 0) -> None:
    """The sharded CT-RCX path on a 2x2 ('data', 'lane') mesh of 4 devices
    (per-step requant, wlog=0): every block's container == the one-device
    route's, sampled blocks == the host oracle, mesh decode == input."""
    import jax
    import jax.numpy as jnp

    from cpprcoder_tpu.ops.range_ops import _materialize_fn
    from cpprcoder_tpu.ops.rcq_ops import _rows_fn
    from cpprcoder_tpu.ops.rcx_ops import rcx_header
    from cpprcoder_tpu.parallel.mesh import make_mesh
    from cpprcoder_tpu.parallel.sharded_rcx import (
        sharded_rcx_decode,
        sharded_rcx_encode,
    )
    from cpprcoder_tpu.reference.rc_ref import _write_sizes
    from cpprcoder_tpu.utils.shapes import bucket

    devices = jax.devices()[:4]
    assert len(devices) == 4, "the sharded path needs four devices"
    mesh = make_mesh(data=2, lane=2, devices=devices)
    x = synth_stream(total_bytes, seed=seed)
    blocks = -(-total_bytes // (2 * block_bytes)) * 2   # whole 'data' rows
    def encode():
        enc_out, layout = sharded_rcx_encode(x, mesh, blocks=blocks,
                                             k_global=lanes, inc=inc,
                                             cbits=cbits)
        return np.asarray(jax.device_get(enc_out[0])), layout

    (events, layout), t_enc = _timed(encode)              # [B, K, E]
    _, n_vec, stride_vec, steps = layout
    emit = (events >> 31) > 0
    run = (events & np.uint32((1 << 22) - 1)).astype(np.int64)
    sizes = (np.where(emit, 1 + run, 0).sum(axis=2)
             - emit.any(axis=2)).astype(np.int64)         # [B, K]
    totals = sizes.sum(axis=1)
    mat = _materialize_fn(lanes, events.shape[2], bucket(int(totals.max())))
    per_block = -(-len(x) // blocks)
    pieces = [x[b * per_block: b * per_block + int(n_vec[b])].tobytes()
              for b in range(blocks)]
    containers = []
    for b in range(blocks):
        payload = np.asarray(mat(jnp.asarray(events[b]))[0])[: totals[b]]
        wide = bool(sizes[b].max() >= 1 << 16)
        w = rcx_header(int(n_vec[b]), lanes, wide, inc, 16, cbits, 0)
        _write_sizes(w, sizes[b].tolist(), wide)
        w.raw(payload.tobytes())
        containers.append(w.getvalue())
    codec = get_codec("rcx")
    solo, t_solo = _timed(codec.encode_many, pieces, lanes=lanes, inc=inc,
                          cbits=cbits, wlog=0)
    for b in range(blocks):
        expect_equal(f"mesh block {b} vs one-device route", containers[b],
                     solo[b])
    for b in sorted({0, blocks - 1}):
        expect_equal(f"mesh block {b} vs oracle", containers[b],
                     rcx_ref.rcx_encode(pieces[b], lanes=lanes, inc=inc,
                                        cbits=cbits, wlog=0))
    # mesh decode from the payload word rows
    l4 = bucket(-(-int(sizes.max()) // 4) + 1)
    p_cap = bucket(int(totals.max()))
    rows_fn = _rows_fn(lanes, l4, p_cap)
    rows = []
    for b in range(blocks):
        padded = np.zeros(p_cap, np.uint8)
        body = containers[b][-int(totals[b]):] if totals[b] else b""
        padded[: len(body)] = np.frombuffer(body, np.uint8)
        rows.append(np.asarray(rows_fn(jnp.asarray(padded),
                                       jnp.asarray(sizes[b], jnp.int32))))
    out, t_dec = _timed(sharded_rcx_decode, np.stack(rows), n_vec,
                        stride_vec, mesh, steps, k_global=lanes, inc=inc,
                        cbits=cbits)
    for b in range(blocks):
        st = int(stride_vec[b])
        got = out[b][:st].T.reshape(-1)[: int(n_vec[b])].tobytes()
        expect_equal(f"mesh decode block {b}", got, pieces[b])
    back, t_solo_dec = _timed(codec.decode_many, solo)
    expect_equal("one-device decode", b"".join(back), x.tobytes())
    log(phase="four", bytes=total_bytes, blocks=blocks, lanes=lanes,
        mesh=dict(mesh.shape), ratio=sum(map(len, containers)) / total_bytes,
        mesh_enc_s=t_enc, mesh_dec_s=t_dec, one_device_enc_s=t_solo,
        one_device_dec_s=t_solo_dec)


# ------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from cpprcoder_tpu.utils.cache import enable_compilation_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices only",
              file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print(f"--four needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 1
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    log(devices=len(devices), kind=devices[0].device_kind,
        jax=jax.__version__, compile_cache=cache)

    if args.four:
        phase_four()
    else:
        from cpprcoder_tpu.ops import rcx_cuda

        rcx_cuda.library()
        log(cuda_build_s=rcx_cuda.build_seconds)
        files = corpus()
        phases = [
            ("a", phase_corpus, (files,)),
            ("b", phase_codecs,
             ({n: files[n] for n in ("alice29.txt", "kennedy.xls")},)),
            ("c", phase_stream, ()),
            ("d", phase_timing, ({
                "kennedy.xls": [files["kennedy.xls"]],
                "plrabn12.txt": [files["plrabn12.txt"]],
                "synth_1MiB": [synth_stream(1 << 20, seed=1).tobytes()],
                "corpus": list(files.values()),
            },)),
            ("e", phase_card, ()),
        ]
        for name, fn, args in phases:
            _, t = _timed(fn, *args)
            log(phase=name, passed=True, phase_s=t)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
