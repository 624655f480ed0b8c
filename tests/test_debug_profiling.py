"""Tests for the debug (shadow divergence detection) and profiling
subsystems (SURVEY §5: tracing/profiling + divergence checks)."""

import numpy as np
import pytest

from cpprcoder_tpu import debug
from cpprcoder_tpu.codecs import get_codec
from cpprcoder_tpu.utils import profiling


@pytest.fixture(autouse=True)
def _clean():
    yield
    debug.set_shadow(False)
    profiling.disable()
    profiling.reset()


def test_shadow_passes_on_correct_codec():
    debug.set_shadow(True)
    data = bytes(np.random.default_rng(0).integers(0, 256, 5000, np.uint8))
    c = get_codec("rcq")
    blob = c.encode(data, backend="jax")
    assert c.decode(blob) == data


def test_shadow_catches_divergence():
    debug.set_shadow(True)
    c = get_codec("rcq")
    good = c._encode(b"hello shadow world " * 50, backend="ref")

    class Broken:
        name = "rcq"
        _decode = staticmethod(c._decode)

    # corrupt one payload byte (last byte of the container)
    bad = good[:-1] + bytes([good[-1] ^ 0xFF])
    with pytest.raises(debug.DivergenceError) as ei:
        debug.check_roundtrip(Broken(), b"hello shadow world " * 50, bad,
                              {"backend": "ref"})
    assert ei.value.total == 19 * 50


def test_shadow_catches_length_divergence():
    debug.set_shadow(True)
    c = get_codec("rcq")
    blob = c._encode(b"abc" * 100, backend="ref")
    with pytest.raises(debug.DivergenceError):
        debug.check_roundtrip(c, b"abc" * 101, blob, {"backend": "ref"})


def test_shadow_via_codec_encode_hook():
    debug.set_shadow(True)
    c = get_codec("adaptive_range")
    data = b"the hook should run the shadow decode transparently" * 20
    blob = c.encode(data, backend="jax")  # shadow-decodes with oracle
    assert c.decode(blob, backend="ref") == data


def test_profiling_counters_accumulate():
    profiling.enable()
    profiling.reset()
    c = get_codec("rcq")
    data = bytes(np.random.default_rng(1).integers(0, 256, 4096, np.uint8))
    blob = c.encode(data, backend="jax")
    assert c.decode(blob, backend="jax") == data
    rep = profiling.report()
    for name in ("enc.scan", "enc.materialize", "enc.assemble",
                 "dec.rows", "dec.scan", "dec.fetch"):
        assert name in rep, f"missing phase {name}: {sorted(rep)}"
        assert rep[name]["calls"] >= 1
        assert rep[name]["wall_s"] > 0
    assert rep["enc.scan"]["bytes"] == 4096
    table = profiling.format_report()
    assert "enc.scan" in table and "| phase |" in table


def test_profiling_disabled_is_noop():
    profiling.disable()
    profiling.reset()
    c = get_codec("rcq")
    c.encode(b"x" * 500, backend="ref")
    assert profiling.report() == {}


def test_profiling_add_and_mbps():
    profiling.enable()
    profiling.reset()
    profiling.add("kernel.trace", 0.5, 50_000_000)
    rep = profiling.report()["kernel.trace"]
    assert rep["MBps"] == pytest.approx(100.0)
