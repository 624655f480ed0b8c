"""The CT-RCX GPU route on the CPU: everything around the CUDA kernels.

The kernels themselves run only on a GPU (chip_smoke.CARD_CHECKS). Both
device routes frame containers in one place (rcx_ops.encode_many /
decode_many), fed here the XLA twins of the kernels (xla_events /
xla_symbols, the kernels' signatures), so lane layout, padding, grouping,
launch batching, header, size table and payload assembly are checked
against the host oracle; plus the kernels' shape rule, the launch-shape and
shared-memory arithmetic and the route rule of codecs/base.py."""

import numpy as np
import pytest

from conftest import corpus_file

from cpprcoder_tpu import compress, decompress, get_codec
from cpprcoder_tpu.codecs import base
from cpprcoder_tpu.codecs import rcx as rcx_codec
from cpprcoder_tpu.ops import rcx_cuda, rcx_ops
from cpprcoder_tpu.reference import rcx_ref


def _textish(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


def _encode(chunks, params=None):
    return rcx_ops.encode_many(chunks, params, events_fn=rcx_ops.xla_events)


def _decode(blobs):
    return rcx_ops.decode_many(blobs, symbols_fn=rcx_ops.xla_symbols)


# ------------------------------------------------- wrapper vs the oracle

CASES = [
    ("n1500_lanes128", _textish(1500, 5), {"lanes": 128}),
    ("n4096_lanes128", _textish(4096, 5), {"lanes": 128}),
    ("grammar_defaults", corpus_file("grammar.lsp"), {}),
    ("cbits0", _textish(3000, 1), {"cbits": 0}),
    ("cbits6_wlog0", _textish(3000, 2), {"cbits": 6, "wlog": 0}),
    ("wlog3", _textish(3000, 4), {"wlog": 3}),
    ("one_lane", _textish(700, 6), {"lanes": 1}),
    ("empty", b"", {}),
    ("one_byte", b"a", {}),
]


@pytest.mark.parametrize("name,data,params", CASES,
                         ids=[c[0] for c in CASES])
def test_wrapper_matches_oracle(name, data, params):
    blob = _encode([data], [params])[0]
    assert blob == rcx_ref.rcx_encode(data, **params)
    assert _decode([blob]) == [data]


def test_multi_container_grid_matches_solo():
    # five chunks in two parameter groups (K=32 and K=128) plus an empty
    # one: one events call per group, containers equal the solo encodes
    chunks = [_textish(1021, 1), _textish(2311, 2), b"", _textish(3500, 3),
              _textish(1500, 4)]
    params = [{}, {}, {}, {}, {"lanes": 128}]
    batch = _encode(chunks, params)
    for c, p, b in zip(chunks, params, batch):
        assert b == _encode([c], [p])[0] == rcx_ref.rcx_encode(c, **p)
    assert _decode(batch) == chunks


def test_wrapper_rejects_shapes_it_does_not_take(monkeypatch):
    # the shape rule raises before the library is asked for
    monkeypatch.setattr(rcx_cuda, "library", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="XLA twin"):
        rcx_ops.encode_many([_textish(500)], [{"cbits": 7}],
                            events_fn=rcx_cuda.kernel_events)
    with pytest.raises(ValueError, match="XLA twin"):
        rcx_ops.decode_many([rcx_ref.rcx_encode(_textish(500), cbits=7)],
                            symbols_fn=rcx_cuda.kernel_symbols)


# ------------------------------------------------ launch-shape arithmetic

@pytest.mark.parametrize("k,threads,lpt", [
    (1, 128, 1), (32, 128, 1), (128, 128, 1), (256, 256, 1), (512, 512, 1),
    (1024, 512, 2), (2048, 512, 4), (8192, 512, 16)])
def test_launch_shape(k, threads, lpt):
    t, l, smem = rcx_cuda.launch_shape(k, 4)
    assert (t, l) == (threads, lpt)
    assert t % 32 == 0 and t * l >= k and t <= rcx_cuda.MAX_THREADS
    assert l <= rcx_cuda.MAX_LPT and smem == rcx_cuda.smem_bytes(4)


@pytest.mark.parametrize("cbits", range(9))
def test_shared_memory_rule(cbits):
    # C u32 + freq u16 + cum u16 per context row of 256 symbols
    smem = rcx_cuda.smem_bytes(cbits)
    assert smem == (1 << cbits) * 256 * 8
    assert rcx_cuda.takes(2048, cbits) == (cbits <= 6)
    assert rcx_cuda.takes(8192, cbits) == (cbits <= 6)
    assert not rcx_cuda.takes(16384, cbits)


# ------------------------------------------------------------ route rule

@pytest.fixture
def spy(monkeypatch):
    """Pretend the platform is a GPU and record which route ran; the
    'kernel' route runs the XLA twins so the containers stay checkable."""
    calls = []

    def enc(chunks, params):
        calls.append("kernel")
        return _encode(chunks, params)

    def dec(blobs):
        calls.append("kernel")
        return _decode(blobs)

    monkeypatch.setattr(rcx_codec, "_kernel_encode", enc)
    monkeypatch.setattr(rcx_codec, "_kernel_decode", dec)
    monkeypatch.setattr(base, "platform", lambda: "gpu")
    return calls


@pytest.mark.parametrize("opts,backend,route", [
    ({}, None, "kernel"),
    ({"cbits": 6}, None, "kernel"),
    ({"lanes": 8192}, None, "kernel"),
    ({"cbits": 7}, None, "xla"),
    ({"lanes": 16384, "inc": 2}, None, "xla"),
    ({}, "jax", "xla"),
    ({}, "ref", "xla"),
])
def test_route_on_gpu(spy, opts, backend, route):
    data = _textish(2000, 3)
    blob = compress(data, codec="rcx", backend=backend, **opts)
    assert blob == rcx_ref.rcx_encode(data, **opts)
    assert decompress(blob, codec="rcx", backend=backend) == data
    assert spy == (["kernel", "kernel"] if route == "kernel" else [])


def test_route_on_cpu_is_the_xla_twin(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel route taken on the CPU")

    monkeypatch.setattr(rcx_codec, "_kernel_encode", boom)
    monkeypatch.setattr(rcx_codec, "_kernel_decode", boom)
    assert base.platform() == "cpu"
    data = _textish(1200, 8)
    blob = compress(data, codec="rcx")
    assert blob == rcx_ref.rcx_encode(data)
    assert decompress(blob, codec="rcx") == data


def test_gpu_without_library_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(base, "platform", lambda: "gpu")
    monkeypatch.setattr(rcx_cuda, "_LIB", None)
    monkeypatch.setattr(rcx_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(rcx_cuda, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        compress(_textish(900, 1), codec="rcx")
    assert not list(tmp_path.iterdir())


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        compress(b"abc", codec="rcx", backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        compress(b"abc", codec="rans", backend="pallas")


def test_stream_batches_superblocks(spy, monkeypatch):
    """CT-SB hands the whole stream to one encode_many; rcx_ops splits
    each parameter group into launches of at most LAUNCH_BYTES of padded
    input, so device memory stays bounded however long the stream is."""
    from cpprcoder_tpu.codecs.stream import stream_decode, stream_encode
    from cpprcoder_tpu.models.cxmodel import rcx_params
    from cpprcoder_tpu.utils.shapes import bucket

    sb = 4096
    k = rcx_params(sb)[0]
    grid = bucket(-(-sb // k)) * k           # one superblock's padded grid
    monkeypatch.setattr(rcx_ops, "LAUNCH_BYTES", 2 * grid)
    launches = []
    for name in ("_encode_group", "_decode_group"):
        orig = getattr(rcx_ops, name)
        monkeypatch.setattr(rcx_ops, name, lambda items, *a, _o=orig, _n=name:
                            launches.append((_n, len(items))) or _o(items, *a))
    data = _textish(5 * sb + 808, 11)        # five full superblocks + a tail
    blob = stream_encode(data, codec="rcx", sb_log2=12)
    assert spy == ["kernel"]                 # one call for the whole stream
    assert stream_decode(blob) == data
    assert spy == ["kernel", "kernel"]
    for name in ("_encode_group", "_decode_group"):
        assert sorted(n for m, n in launches if m == name) == [1, 1, 2, 2]
    codec = get_codec("rcx")
    assert blob.endswith(b"".join(
        codec.encode(data[i:i + sb], backend="ref")
        for i in range(0, len(data), sb)))


@pytest.mark.parametrize("steps,k,per", [
    (512, 2048, 128), (1024, 2048, 64), (16, 32, 262_144), (1 << 20, 256, 1)])
def test_launch_budget(steps, k, per):
    idx = list(range(300))
    launches = rcx_ops._launches(idx, steps, k)
    assert [i for launch in launches for i in launch] == idx
    assert max(map(len, launches)) == min(per, 300)
    assert all(len(launch) * steps * k <= max(rcx_ops.LAUNCH_BYTES, steps * k)
               for launch in launches)
