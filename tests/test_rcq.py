"""CT-RCQ: jax == oracle container identity + round-trips + model twins."""

import numpy as np
import pytest

from conftest import corpus_file, std_cases

from cpprcoder_tpu.models import qmodel
from cpprcoder_tpu.ops import rcq_ops
from cpprcoder_tpu.reference import rcq_ref


def test_quantize_twins():
    rng = np.random.default_rng(7)
    for _ in range(20):
        C = rng.integers(1, 500, 256).astype(np.uint32)
        qn = qmodel.quantize_np(C)
        qj = np.asarray(qmodel.quantize_jnp(C.copy()))
        assert (qn == qj).all()
        assert qn.sum() == qmodel.QTOTAL and qn.min() >= 1


def test_quantize_uniform_and_skewed():
    qn = qmodel.quantize_np(np.ones(256, np.uint32))
    assert qn.sum() == qmodel.QTOTAL and qn.min() >= 1
    C = np.ones(256, np.uint32)
    C[0] = 100000  # near the u32-exactness bound
    qn = qmodel.quantize_np(C)
    assert qn.sum() == qmodel.QTOTAL and qn.min() >= 1


@pytest.mark.parametrize("i, data", list(enumerate(std_cases())))
def test_roundtrip_oracle(i, data):
    blob = rcq_ref.rcq_encode(data)
    assert rcq_ref.rcq_decode(blob) == bytes(data)


@pytest.mark.parametrize("i, data", list(enumerate(std_cases())))
def test_jax_identity_and_roundtrip(i, data):
    blob_j = rcq_ops.rcq_encode_jax(data)
    blob_r = rcq_ref.rcq_encode(data)
    assert blob_j == blob_r
    assert rcq_ops.rcq_decode_jax(blob_j) == bytes(data)
    assert rcq_ref.rcq_decode(blob_j) == bytes(data)


def test_corpus_file_roundtrip(grammar):
    blob = rcq_ops.rcq_encode_jax(grammar)
    assert rcq_ops.rcq_decode_jax(blob) == grammar
    assert rcq_ref.rcq_encode(grammar) == blob


def test_corpus_medium_lanes():
    data = corpus_file("fields.c")
    blob = rcq_ops.rcq_encode_jax(data, lanes=64)
    assert blob == rcq_ref.rcq_encode(data, lanes=64)
    assert rcq_ops.rcq_decode_jax(blob) == data


def test_registry_roundtrip():
    from cpprcoder_tpu.codecs import compress, decompress

    data = b"the quick brown fox " * 100
    blob = compress(data, "rcq")
    assert decompress(blob, "rcq") == data
    assert decompress(blob, "rcq", backend="ref") == data


def _case(n, seed=0):
    # mixed entropy: text-ish low values + random tail
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


@pytest.mark.parametrize("n", [1500, 4096])
def test_jax_identity_128_lanes(n):
    data = _case(n)
    blob = rcq_ops.rcq_encode_jax(data, lanes=128)
    assert blob == rcq_ref.rcq_encode(data, lanes=128)
    assert rcq_ops.rcq_decode_jax(blob) == data


def test_jax_small_input_default_lanes():
    data = b"tiny tiny tiny tiny " * 12
    blob = rcq_ops.rcq_encode_jax(data)
    assert blob == rcq_ref.rcq_encode(data)
    assert rcq_ops.rcq_decode_jax(blob) == data


@pytest.mark.parametrize("lanes", [32, 64])
def test_jax_identity_lane_counts(lanes):
    data = _case(3000, seed=2)
    blob = rcq_ops.rcq_encode_jax(data, lanes=lanes)
    assert blob == rcq_ref.rcq_encode(data, lanes=lanes)
    assert rcq_ops.rcq_decode_jax(blob) == data


def test_jax_corpus_file_128_lanes():
    data = corpus_file("fields.c")
    blob = rcq_ops.rcq_encode_jax(data, lanes=128)
    assert blob == rcq_ref.rcq_encode(data, lanes=128)
    assert rcq_ops.rcq_decode_jax(blob) == data
