"""Test configuration: force an 8-device virtual CPU platform so sharding
tests run without accelerator hardware (SURVEY.md §4: multi-host testable in
CI via --xla_force_host_platform_device_count). Tests marked `gpu` need the
card; the `gpu_device` fixture skips them elsewhere."""

import os

# CPU unless the caller asked for the card: `JAX_PLATFORMS=cuda,cpu
# python -m pytest -m gpu tests/` runs the card-only tests on a GPU host
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# the CPU platform must be chosen BEFORE enable_compilation_cache so the
# host-keyed CPU cache subdir is selected (utils/cache.py)
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from cpprcoder_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture
def gpu_device():
    """The GPU, for tests marked `gpu`; decided here at run time, never at
    import or collection, so every worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` there, "
                    "or these tests with JAX_PLATFORMS=cuda,cpu")
    return devs[0]


def pytest_collection_modifyitems(config, items):
    """Run the shard_map suites FIRST: this environment's XLA:CPU compiler
    intermittently segfaults (inside backend_compile_and_load) when a big
    shard_map program is compiled late in a long-lived process with ~200
    executables already loaded — the same compile succeeds in a fresh
    process. Compiling the sharded programs while the process is young
    sidesteps the crash; the tests themselves are unchanged."""
    items.sort(key=lambda it: 0 if "sharded" in it.nodeid else 1)


DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

CANTERBURY = [
    "alice29.txt", "asyoulik.txt", "cp.html", "fields.c", "grammar.lsp",
    "kennedy.xls", "lcet10.txt", "plrabn12.txt", "ptt5", "sum", "xargs.1",
]


def corpus_file(name: str) -> bytes:
    with open(os.path.join(DATA_DIR, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def grammar():
    return corpus_file("grammar.lsp")


@pytest.fixture(scope="session")
def xargs():
    return corpus_file("xargs.1")


@pytest.fixture(scope="session")
def fields():
    return corpus_file("fields.c")


def std_cases(rng=None):
    """Edge-case byte strings every codec must round-trip."""
    rng = rng or np.random.default_rng(1234)
    return [
        b"",
        b"\x00",
        b"a",
        b"\xff" * 300,
        b"abcabcabc" * 50,
        bytes(range(256)) * 3,
        bytes(rng.integers(0, 256, 1021, dtype=np.uint8)),
        bytes(rng.integers(0, 3, 4099, dtype=np.uint8)),
        b"\x00" * 2048,
        bytes(rng.integers(250, 256, 513, dtype=np.uint8)),
    ]
