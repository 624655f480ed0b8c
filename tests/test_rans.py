"""CT-ANS1 rANS: oracle round-trip + JAX container identity."""

import numpy as np
import pytest

from cpprcoder_tpu.ops import rans_ops
from cpprcoder_tpu.reference import rans_ref
from conftest import std_cases


def _case(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


def _skewed(n, seed=2):
    # long codes / near-zero probabilities next to dominant symbols
    rng = np.random.default_rng(seed)
    probs = np.array([2.0 ** -min(i // 16 + 1, 14) for i in range(256)])
    probs /= probs.sum()
    return rng.choice(256, n, p=probs).astype(np.uint8).tobytes()


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_oracle_roundtrip(lanes):
    for data in std_cases():
        blob = rans_ref.rans_encode(data, lanes=lanes)
        assert rans_ref.rans_decode(blob) == data


@pytest.mark.parametrize("lanes", [1, 8])
def test_jax_container_identity(lanes):
    for data in [c for c in std_cases() if c][:6]:
        ref = rans_ref.rans_encode(data, lanes=lanes)
        jx = rans_ops.rans_encode_jax(data, lanes=lanes)
        assert jx == ref
        assert rans_ops.rans_decode_jax(jx) == data


def test_corpus_file(grammar):
    blob = rans_ops.rans_encode_jax(grammar)
    assert blob == rans_ref.rans_encode(grammar)
    assert rans_ops.rans_decode_jax(blob) == grammar


@pytest.mark.parametrize("n", [1500, 4096])
def test_jax_identity_128_lanes(n):
    data = _case(n)
    blob = rans_ops.rans_encode_jax(data, lanes=128)
    assert blob == rans_ref.rans_encode(data, lanes=128)
    assert rans_ops.rans_decode_jax(blob) == data


def test_jax_single_symbol_run():
    # f == 16384 for the single symbol: the renorm test must not u32-wrap
    data = b"\x42" * 2000
    blob = rans_ops.rans_encode_jax(data, lanes=64)
    assert blob == rans_ref.rans_encode(data, lanes=64)
    assert rans_ops.rans_decode_jax(blob) == data


def test_jax_skewed_symbols():
    data = _skewed(3000)
    blob = rans_ops.rans_encode_jax(data, lanes=64)
    assert blob == rans_ref.rans_encode(data, lanes=64)
    assert rans_ops.rans_decode_jax(blob) == data


def test_wide_word_counts_single_lane():
    # >65535 words in one lane forces the u32 per-lane-count path: the
    # wide bit (lane_desc bit 7) must be set and all backends must agree
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    ref = rans_ref.rans_encode(data, lanes=1)
    assert ref[4] & 0x80, "wide bit expected for 200 KB random at lanes=1"
    jx = rans_ops.rans_encode_jax(data, lanes=1)
    assert jx == ref
    assert rans_ref.rans_decode(ref) == data
    assert rans_ops.rans_decode_jax(jx) == data
