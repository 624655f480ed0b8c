"""Property tests: two-level (16×16) lookup paths == flat one-hot specs.

The scan hot loops use coder_step_lookups2 / find_symbol2 (matmul-friendly
two-level decomposition); these tests pin them to the flat [K,256] forms
they replaced, including tie cases from zero-frequency symbols (static
tables) and the active-lane masking contract."""

import numpy as np
import jax.numpy as jnp
import pytest

from cpprcoder_tpu.ops.lookup import (
    coder_step_lookups2,
    find_symbol,
    find_symbol2,
    find_symbol_of,
    hist_from_onehots,
    histogram256,
)

U32 = jnp.uint32
I32 = jnp.int32


def _freq_cases():
    rng = np.random.default_rng(7)
    yield np.ones(256, np.uint32)                       # fresh adaptive model
    yield rng.integers(1, 1000, 256).astype(np.uint32)  # generic adaptive
    f = rng.integers(0, 50, 256).astype(np.uint32)      # static with zeros
    f[f < 25] = 0
    f[0] = 3
    yield f
    f = np.zeros(256, np.uint32)                        # single-symbol table
    f[97] = 1 << 16
    yield f


@pytest.mark.parametrize("case", range(4))
def test_find_symbol2_matches_flat(case):
    freqs = list(_freq_cases())[case]
    cum = jnp.cumsum(jnp.asarray(freqs, U32))
    total = int(freqs.sum())
    rng = np.random.default_rng(case)
    v = rng.integers(0, total, 333).astype(np.uint32)
    v = jnp.asarray(np.concatenate([v, [0, total - 1]]))
    s0, c0, f0 = find_symbol(cum, v)
    s1, c1, f1, _ = find_symbol2(cum, v)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))


def test_find_symbol2_onehot_hist():
    rng = np.random.default_rng(3)
    freqs = rng.integers(1, 99, 256).astype(np.uint32)
    cum = jnp.cumsum(jnp.asarray(freqs, U32))
    total = int(freqs.sum())
    v = jnp.asarray(rng.integers(0, total, 511).astype(np.uint32))
    active = jnp.asarray(rng.integers(0, 2, 511).astype(bool))
    s, _, _, ohs = find_symbol2(cum, v, active)
    got = hist_from_onehots(*ohs, 24)
    want = histogram256(s, 24, active)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_coder_step_lookups2_matches_flat():
    rng = np.random.default_rng(11)
    freqs = jnp.asarray(rng.integers(1, 2000, 256).astype(np.uint32))
    cum = jnp.cumsum(freqs)
    syms = jnp.asarray(rng.integers(0, 256, 777).astype(np.int32))
    active = jnp.asarray(rng.integers(0, 2, 777).astype(bool))
    f, c, upd = coder_step_lookups2(freqs, cum, syms, active, 24)
    f0, c0 = find_symbol_of(freqs, cum, syms)
    upd0 = histogram256(syms, 24, active)
    np.testing.assert_array_equal(np.asarray(upd), np.asarray(upd0))
    a = np.asarray(active)
    # contract: inactive lanes are masked (f = c = 0); active lanes match
    np.testing.assert_array_equal(np.asarray(f)[a], np.asarray(f0)[a])
    np.testing.assert_array_equal(np.asarray(c)[a], np.asarray(c0)[a])
    assert not np.asarray(f)[~a].any() and not np.asarray(c)[~a].any()
