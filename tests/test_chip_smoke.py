"""chip_smoke.py's phases at tiny size on the CPU (where the default route is
the XLA twin), its refusal to run without a GPU, and its card-only checks,
which skip here and run on a GPU (`JAX_PLATFORMS=cuda,cpu`)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_sharded_phase_four_on_virtual_devices():
    # the --four path on 4 of the 8 virtual CPU devices: 2 blocks per data
    # shard, K=64 lanes sharded over 'lane'
    chip_smoke.phase_four(total_bytes=16 << 10, block_bytes=4 << 10,
                          lanes=64)


def test_phase_corpus_small_files(capsys):
    chip_smoke.phase_corpus(chip_smoke.corpus(["grammar.lsp", "xargs.1"]))
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 4 and all('"phase": "a"' in r for r in rows)


def test_phase_corpus_catches_a_corrupted_container(monkeypatch):
    real = chip_smoke.compress

    def corrupt(data, **kw):
        blob = bytearray(real(data, **kw))
        blob[-1] ^= 0x01
        return bytes(blob)

    monkeypatch.setattr(chip_smoke, "compress", corrupt)
    with pytest.raises(AssertionError, match="container"):
        chip_smoke.phase_corpus(chip_smoke.corpus(["grammar.lsp"]))


def test_phase_codecs_small_file():
    chip_smoke.phase_codecs(chip_smoke.corpus(["grammar.lsp"]))


def test_phase_stream_small():
    chip_smoke.phase_stream(total_bytes=20000, sb_log2=13)


def test_phase_timing_small(capsys):
    rows = chip_smoke.phase_timing(
        {"xargs": list(chip_smoke.corpus(["xargs.1"]).values())}, reps=1)
    assert rows[0]["bytes"] == 4227
    assert 0 < rows[0]["default_expansion_share"] < 1


def test_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("check", chip_smoke.CARD_CHECKS,
                         ids=[c.__name__ for c in chip_smoke.CARD_CHECKS])
def test_card_check(gpu_device, check):
    check()
