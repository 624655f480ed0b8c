"""CT-HUF1 canonical Huffman tests."""

import numpy as np
import pytest

from cpprcoder_tpu.models.huffman import package_merge_lengths
from cpprcoder_tpu.ops import huffman_ops
from cpprcoder_tpu.reference import huffman_ref
from conftest import std_cases


def test_package_merge_optimality_and_kraft():
    rng = np.random.default_rng(1)
    for _ in range(15):
        m = int(rng.integers(1, 257))
        counts = np.zeros(256, np.int64)
        syms = rng.choice(256, m, replace=False)
        counts[syms] = rng.zipf(1.5, m).clip(1, 10 ** 6)
        lengths = package_merge_lengths(counts)
        assert lengths.max() <= 15
        n = counts.sum()
        if m > 1:
            h = -(counts[syms] / n * np.log2(counts[syms] / n)).sum()
            cost = (counts * lengths).sum() / n
            assert cost <= h + 1 + 1e-9


@pytest.mark.parametrize("lanes", [1, 8])
def test_oracle_roundtrip(lanes):
    for data in std_cases():
        blob = huffman_ref.huffman_encode(data, lanes=lanes)
        assert huffman_ref.huffman_decode(blob) == data


@pytest.mark.parametrize("lanes", [1, 8])
def test_jax_container_identity(lanes):
    for data in [c for c in std_cases() if c][:6]:
        ref = huffman_ref.huffman_encode(data, lanes=lanes)
        jx = huffman_ops.huffman_encode_jax(data, lanes=lanes)
        assert jx == ref
        assert huffman_ops.huffman_decode_jax(jx) == data


def test_corpus_file(grammar):
    blob = huffman_ops.huffman_encode_jax(grammar)
    assert blob == huffman_ref.huffman_encode(grammar)
    assert huffman_ops.huffman_decode_jax(blob) == grammar


def _case(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


@pytest.mark.parametrize("n", [1500, 4096])
def test_jax_identity_128_lanes(n):
    data = _case(n)
    blob = huffman_ops.huffman_encode_jax(data, lanes=128)
    assert blob == huffman_ref.huffman_encode(data, lanes=128)
    assert huffman_ops.huffman_decode_jax(blob) == data


def test_jax_skewed_symbols():
    # long codes (near max length) + single-symbol runs
    rng = np.random.default_rng(2)
    probs = np.array([2.0 ** -min(i // 16 + 1, 14) for i in range(256)])
    probs /= probs.sum()
    data = rng.choice(256, 3000, p=probs).astype(np.uint8).tobytes()
    blob = huffman_ops.huffman_encode_jax(data, lanes=64)
    assert blob == huffman_ref.huffman_encode(data, lanes=64)
    assert huffman_ops.huffman_decode_jax(blob) == data
