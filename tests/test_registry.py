"""Every registered codec must round-trip every standard case through the
public bytes API (both backends where applicable)."""

import numpy as np
import pytest

from cpprcoder_tpu.codecs import get_codec, list_codecs
from conftest import std_cases

SIMPLE = ["static_range", "adaptive_range", "rans", "huffman", "ase",
          "blocksort", "mtf", "mtf1", "slz4"]


def test_registry_complete():
    names = set(list_codecs())
    assert set(SIMPLE) <= names
    assert {"pipeline", "stream"} <= names


@pytest.mark.parametrize("name", SIMPLE)
def test_roundtrip_all_codecs(name):
    codec = get_codec(name)
    for data in std_cases()[:7]:
        blob = codec.encode(data)
        assert codec.decode(blob) == data, (name, len(data))


@pytest.mark.parametrize("name", ["static_range", "rans", "slz4"])
def test_ref_backend_identity(name):
    codec = get_codec(name)
    rng = np.random.default_rng(11)
    data = bytes(rng.integers(0, 32, 4001, dtype=np.uint8))
    assert codec.encode(data, backend="ref") == codec.encode(data, backend="jax")


def test_stream_roundtrip():
    from cpprcoder_tpu.codecs.stream import stream_decode, stream_encode

    rng = np.random.default_rng(12)
    data = bytes(rng.integers(0, 64, 200000, dtype=np.uint8))
    blob = stream_encode(data, codec="rans", sb_log2=16)
    assert stream_decode(blob) == data


def test_pipeline_variants(grammar):
    from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode

    for stages in (["blocksort", "mtf1", "rans"],
                   ["slz4", "huffman"],
                   ["mtf", "adaptive_range"]):
        blob = pipeline_encode(grammar, stages=stages)
        assert pipeline_decode(blob) == grammar, stages


def test_registry_first_calls_from_threads():
    # a fresh process whose first codec calls come from 8 threads at once:
    # every thread must see the full registry
    import os
    import subprocess
    import sys

    code = (
        "import threading\n"
        "from cpprcoder_tpu.codecs import get_codec\n"
        "errs = []\n"
        "def f():\n"
        "    try:\n"
        "        get_codec('rcx'); get_codec('stream')\n"
        "    except Exception as e:\n"
        "        errs.append(e)\n"
        "ts = [threading.Thread(target=f) for _ in range(8)]\n"
        "[t.start() for t in ts]; [t.join() for t in ts]\n"
        "assert not errs, errs\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
