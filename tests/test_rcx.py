"""CT-RCX (context-conditioned quantized adaptive range coder): container
identity across oracle / XLA backends, round-trips, fuzzed shapes, and the
capability claim — ratio below the reference adaptive coder's published
per-file numbers (BASELINE.md). The GPU kernels' checks are card-only
(chip_smoke.CARD_CHECKS, run by tests/test_chip_smoke.py on a GPU); their
host-side wrapper is tested here on the CPU in tests/test_rcx_cuda.py."""

import numpy as np
import pytest

from conftest import corpus_file

from cpprcoder_tpu.models.cxmodel import (
    QTOTAL,
    quantize_rows_np,
    rcx_params,
    rescale_rows_np,
)
from cpprcoder_tpu.ops import rcx_ops
from cpprcoder_tpu.reference import rcx_ref


def _case(n, seed=0, lo=0, hi=256):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, n, dtype=np.uint8).tobytes()


def _jax_encode(data, **params):
    return rcx_ops.encode_many([data], [params])[0]


def _jax_decode(blob):
    return rcx_ops.decode_many([blob])[0]


def _textish(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


# ------------------------------------------------------------------ model

def test_quantize_rows_sum_exact():
    rng = np.random.default_rng(3)
    C = rng.integers(1, 5000, (16, 256), dtype=np.uint32)
    q = quantize_rows_np(C)
    assert (q.sum(axis=1) == QTOTAL).all()
    assert (q >= 1).all()


def test_rescale_rows_independent():
    C = np.ones((4, 256), np.uint32)
    C[1] = 300          # row total 76800 >= 2^16 -> halves
    C[3] = 2
    out = rescale_rows_np(C, 1 << 16)
    assert (out[0] == 1).all() and (out[3] == 2).all()
    assert (out[1] == 151).all()          # (300 >> 1) | 1


def test_params_policy():
    k, inc, cl, cb = rcx_params(4000)
    assert cb == 6 and inc == 32
    k, inc, cl, cb = rcx_params(150_000)
    assert cb == 5 and inc == 16
    k, inc, cl, cb = rcx_params(1_000_000)
    assert cb == 4 and k * inc <= 49152


# ------------------------------------------------------- oracle <-> XLA

@pytest.mark.parametrize("n,seed", [(0, 0), (1, 0), (200, 1), (5000, 2)])
def test_jax_oracle_identity(n, seed):
    data = _textish(n, seed)
    bo = rcx_ref.rcx_encode(data)
    bj = _jax_encode(data)
    assert bo == bj
    assert _jax_decode(bo) == data
    assert rcx_ref.rcx_decode(bj) == data


def test_jax_oracle_identity_odd_sizes():
    # sizes that force empty trailing lanes ((k-1)*stride >= n)
    for n in (10_241, 65_537):
        data = _case(n, seed=n, lo=0, hi=7)
        bo = rcx_ref.rcx_encode(data)
        bj = _jax_encode(data)
        assert bo == bj
        assert _jax_decode(bo) == data


@pytest.mark.parametrize("cbits", [0, 2, 8])
def test_cbits_variants(cbits):
    data = _textish(3000, seed=cbits)
    bo = rcx_ref.rcx_encode(data, cbits=cbits)
    bj = _jax_encode(data, cbits=cbits)
    assert bo == bj
    assert _jax_decode(bo) == data


def test_corpus_identity():
    data = corpus_file("grammar.lsp")
    bo = rcx_ref.rcx_encode(data)
    assert _jax_encode(data) == bo
    assert _jax_decode(bo) == data


# ------------------------------------------------------------ capability

def test_ratio_beats_reference_adaptive():
    # the headline claim: per-file ratio <= reference adaptive coder
    # (BASELINE.md). CPU-cheap files only; chip_smoke.py phase (a) prints
    # every file's ratio.
    ref = {"grammar.lsp": 0.619457, "fields.c": 0.642511,
           "xargs.1": 0.648924}
    for name, r in ref.items():
        data = corpus_file(name)
        blob = _jax_encode(data)
        assert len(blob) / len(data) < r, name


def test_registry_roundtrip():
    from cpprcoder_tpu import codecs

    data = _textish(2000, seed=9)
    c = codecs.get_codec("rcx")
    blob = c.encode(data)
    assert c.decode(blob) == data


def test_wlog_sweep_identity_all_backends():
    """v2 window schedule: oracle == jax containers for every wlog, and
    wlog is decodable from every backend."""
    data = _textish(3000, seed=3)
    for wlog in (0, 1, 2, 3):
        ref = rcx_ref.rcx_encode(data, wlog=wlog)
        jx = _jax_encode(data, wlog=wlog)
        assert jx == ref, wlog
        assert _jax_decode(ref) == data
        assert rcx_ref.rcx_decode(ref) == data


def test_wlog_containers_differ_and_ratio_close():
    """wlog>0 changes the payload (stale tables) but only slightly hurts
    ratio; wlog must round-trip through the header."""
    data = _textish(20000, seed=4)
    blobs = {w: rcx_ref.rcx_encode(data, wlog=w) for w in (0, 2)}
    assert blobs[0] != blobs[2]
    assert len(blobs[2]) <= len(blobs[0]) * 1.03
