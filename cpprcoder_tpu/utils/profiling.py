"""Per-phase profiling counters + optional device traces.

Reference parity: blksort accumulates per-phase wall-clock doubles
(encode_setup/encode_sort/encode_finalize/decode_* — blksort.h:132-143,
filled under BLOCKSORT_PERF=1) but never prints them; the harness Timer
(test/main.cpp:67-98) only times whole encode/decode calls. Here the same
idea is a first-class subsystem: named phase counters accumulated at the
host dispatch level (scan launch, payload materialization, container
assembly, device fetch), a printable report, and a `jax.profiler` trace
hook for full device timelines.

Phases are host-side wall clock: under jit, XLA fuses the in-kernel work,
so the meaningful host-visible boundaries are the dispatch sites — the
same granularity the reference's counters had. Enable with
CT_PROFILE=1 (env) or profiling.enable(); overhead when disabled is one
falsy check per phase.

Usage:
    from cpprcoder_tpu.utils import profiling
    profiling.enable()
    ... encode/decode ...
    print(profiling.format_report())

Device timeline (TensorBoard/XProf trace):
    with profiling.device_trace("/tmp/ct-trace"):
        ... jitted work ...
"""

from __future__ import annotations

import contextlib
import os
import time

_ENABLED = os.environ.get("CT_PROFILE", "") not in ("", "0")
# name -> [calls, wall_seconds, bytes]
_COUNTERS: dict[str, list] = {}


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    _COUNTERS.clear()


@contextlib.contextmanager
def phase(name: str, nbytes: int = 0):
    """Accumulate wall time (and optionally a byte count) under `name`."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        row = _COUNTERS.setdefault(name, [0, 0.0, 0])
        row[0] += 1
        row[1] += dt
        row[2] += nbytes


def add(name: str, seconds: float, nbytes: int = 0) -> None:
    """Record an externally-measured duration (e.g. a kernel time read from a device trace)."""
    if not _ENABLED:
        return
    row = _COUNTERS.setdefault(name, [0, 0.0, 0])
    row[0] += 1
    row[1] += seconds
    row[2] += nbytes


def report() -> dict[str, dict]:
    """{phase: {calls, wall_s, bytes, MBps}} — MBps only where bytes>0."""
    out = {}
    for name, (calls, wall, nbytes) in sorted(_COUNTERS.items()):
        row = {"calls": calls, "wall_s": wall, "bytes": nbytes}
        if nbytes and wall > 0:
            row["MBps"] = nbytes / wall / 1e6
        out[name] = row
    return out


def format_report() -> str:
    """Markdown table (the report blksort.h:132-143 accumulated but never
    printed)."""
    lines = ["| phase | calls | wall s | bytes | MB/s |",
             "|---|---|---|---|---|"]
    for name, row in report().items():
        mbps = f"{row['MBps']:.1f}" if "MBps" in row else "-"
        lines.append(f"| {name} | {row['calls']} | {row['wall_s']:.4f} "
                     f"| {row['bytes']} | {mbps} |")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a block (TensorBoard-viewable); the device
    equivalent of reading the reference's phase accumulators off a
    debugger."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
