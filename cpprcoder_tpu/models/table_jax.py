"""Device (jnp) twins of the host table builders in models.static_table.

Bit-identical by construction (same integer spec, u32-safe; the pre-scale
step guarantees c*T < 2^31 so no 64-bit arithmetic is needed on device).
Keeping table construction on device lets a full encode run without any
host↔device round-trip between histogram and payload.
"""

from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def histogram_masked(x_flat, n, chunk: int = 1 << 15):
    """256-bin histogram of x_flat (u8, padded) counting only the first n.

    Device equivalent of np.bincount(x[:n], minlength=256), as chunked
    one-hot matmuls (0/1 operands are exact at DEFAULT precision and
    per-chunk counts < 2^24 accumulate exactly in f32; ops/lookup.py).
    Whether this or a scatter-add is faster on the GPU is not measured."""
    import jax.lax as lax

    m = x_flat.shape[0]
    if m < (1 << 12):  # tiny inputs: scatter is fine and compiles leaner
        idx = jnp.where(jnp.arange(m) < n, x_flat.astype(I32), 256)
        return jnp.zeros(257, I32).at[idx].add(1)[:256]
    pad = (-m) % chunk
    xs = jnp.concatenate([x_flat.reshape(-1),
                          jnp.zeros(pad, x_flat.dtype)]) if pad else x_flat
    xs = xs.reshape(-1, chunk)
    iota = jnp.arange(256, dtype=I32)
    base = jnp.arange(chunk, dtype=I32)

    def one(carry, args):
        row, cidx = args
        act = (base + cidx * chunk) < n.astype(I32)
        oh = ((row.astype(I32)[:, None] == iota[None, :])
              & act[:, None]).astype(jnp.float32)
        h = jnp.dot(jnp.ones((1, chunk), jnp.float32), oh,
                    preferred_element_type=jnp.float32)[0]
        return carry + h, 0

    hist, _ = lax.scan(one, jnp.zeros(256, jnp.float32),
                       (xs, jnp.arange(xs.shape[0], dtype=I32)))
    return hist.astype(I32)


def prescale_counts_jnp(counts, n):
    """counts i32 [256], n = true symbol count (traced u32/i32 scalar)."""
    counts = counts.astype(I32)
    nm1 = jnp.maximum(n.astype(I32) - 1, 0).astype(U32)
    # exact integer bit length: bl = (nm1>0) + #{k in 1..31 : nm1 >= 2^k}
    bl = (nm1 > 0).astype(I32) + (
        nm1[None] >= (U32(1) << jnp.arange(1, 32, dtype=U32))
    ).sum().astype(I32)
    shift = jnp.maximum(bl - 14, 0)
    c = counts >> shift
    c = jnp.where((counts > 0) & (c == 0), 1, c)
    return c


def normalize_freqs_jnp(counts, n, total_bits: int):
    """Device twin of static_table.normalize_freqs. counts i32 [256]."""
    total = 1 << total_bits
    c = prescale_counts_jnp(counts, n)
    nn = c.sum()
    present = c > 0
    f = jnp.where(nn > 0, (c * total) // jnp.maximum(nn, 1), 0)
    r = jnp.where(nn > 0, (c * total) % jnp.maximum(nn, 1), 0)
    f = jnp.where(present & (f == 0), 1, f)
    d = total - f.sum()

    # d > 0 branch: +1 to the d present symbols with largest remainder
    # (absent symbols ranked last so they never occupy a give slot)
    r = jnp.where(present, r, -1)
    order_r = jnp.argsort(-r, stable=True)
    rank_r = jnp.zeros(256, I32).at[order_r].set(jnp.arange(256, dtype=I32))
    f_give = f + (present & (rank_r < d)).astype(I32)

    # d < 0 branch: drain richest first (stable ties by symbol)
    need = -d
    excess = jnp.where(present, f - 1, 0)
    order_f = jnp.argsort(-f, stable=True)
    ex_sorted = excess[order_f]
    cum = jnp.cumsum(ex_sorted)
    take_sorted = jnp.clip(need - (cum - ex_sorted), 0, ex_sorted)
    take = jnp.zeros(256, I32).at[order_f].set(take_sorted)
    f_steal = f - take

    f = jnp.where(d > 0, f_give, jnp.where(d < 0, f_steal, f))

    # single-symbol cap (FORMATS.md rule 5)
    is_full = f == total
    any_full = is_full.any()
    s = jnp.argmax(is_full).astype(I32)
    f = jnp.where(any_full,
                  f.at[s].add(-1).at[(s + 1) % 256].add(1),
                  f)
    return f.astype(U32)


def exclusive_cumsum_jnp(freqs):
    return jnp.concatenate([jnp.zeros(1, U32), jnp.cumsum(freqs[:255].astype(U32))])
