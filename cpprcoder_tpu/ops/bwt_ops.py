"""JAX Burrows-Wheeler transform: CT-BWT1.

Lane-parallel design (SURVEY.md §7 phase 4): the reference's multikey quicksort over
rotation pointers (blksort.h:276-350, strictly sequential, O(depth) compares)
becomes prefix-doubling rank sort — log2(B) rounds of batched
`lax.sort(num_keys=2)` over [n_blocks, B], entirely parallel across blocks
and lanes. The inverse LF walk (blksort.h:645-652, pointer chasing) becomes
permutation doubling: log2(B) rounds of batched gathers.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from cpprcoder_tpu.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu.reference import bwt_ref

I32 = jnp.int32


@lru_cache(maxsize=16)
def _forward_fn(nb: int, b: int):
    rounds = max(1, (b - 1).bit_length())

    @jax.jit
    def run(blocks):  # [nb, b] u8
        rank = blocks.astype(I32)
        idx = jnp.broadcast_to(jnp.arange(b, dtype=I32), (nb, b))
        perm = idx
        for j in range(rounds):
            h = 1 << j
            key2 = jnp.roll(rank, -h, axis=1)
            r1, r2, perm = lax.sort((rank, key2, idx), num_keys=2,
                                    is_stable=True)
            diff = jnp.concatenate(
                [jnp.zeros((nb, 1), I32),
                 ((r1[:, 1:] != r1[:, :-1]) | (r2[:, 1:] != r2[:, :-1])
                  ).astype(I32)], axis=1)
            new_sorted = jnp.cumsum(diff, axis=1)
            _, rank = lax.sort((perm, new_sorted), num_keys=1, is_stable=True)
        _, order = lax.sort((rank, idx), num_keys=1, is_stable=True)
        last = jnp.take_along_axis(blocks, (order - 1) % b, axis=1)
        rows = jnp.argmax(order == 0, axis=1).astype(jnp.uint32)
        return last, rows

    return run


@lru_cache(maxsize=16)
def _inverse_fn(nb: int, b: int):
    @jax.jit
    def run(last, rows):  # [nb, b] u8, [nb] u32
        idx = jnp.broadcast_to(jnp.arange(b, dtype=I32), (nb, b))
        _, t = lax.sort((last.astype(I32), idx), num_keys=1, is_stable=True)
        pos = jnp.zeros((nb, b), I32)
        first = jnp.take_along_axis(t, rows.astype(I32)[:, None], axis=1)
        pos = lax.dynamic_update_slice(pos, first, (0, 0))
        p = t
        filled = 1
        while filled < b:
            m = min(filled, b - filled)
            nxt = jnp.take_along_axis(
                p, lax.dynamic_slice(pos, (0, 0), (nb, m)), axis=1)
            pos = lax.dynamic_update_slice(pos, nxt, (0, filled))
            filled *= 2
            if filled < b:
                p = jnp.take_along_axis(p, p, axis=1)
        return jnp.take_along_axis(last, pos, axis=1)

    return run


def _size_groups(sizes: list[int]):
    """Consecutive equal-size runs: [(size, count), ...] in stream order.
    The CT-BWT1 layout is [bs]*nb + strictly-decreasing tail powers, so
    each group is one batched device call."""
    groups = []
    for bs in sizes:
        if groups and groups[-1][0] == bs:
            groups[-1][1] += 1
        else:
            groups.append([bs, 1])
    return groups


def bwt_encode_jax(data, block_log2: int = 15) -> bytes:
    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n).u8(block_log2)
    sizes, rem = bwt_ref.block_layout(n, block_log2)
    off = 0
    for bs, cnt in _size_groups(sizes):
        blocks = x[off: off + cnt * bs].reshape(cnt, bs)
        last, rows = _forward_fn(cnt, bs)(jnp.asarray(blocks))
        last = np.asarray(jax.device_get(last))
        rows = np.asarray(jax.device_get(rows))
        for i in range(cnt):
            w.raw(last[i].tobytes()).u32(int(rows[i]))
        off += cnt * bs
    w.raw(x[n - rem:].tobytes())
    return w.getvalue()


def bwt_decode_jax(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    sizes, rem = bwt_ref.block_layout(n, r.u8())
    out = bytearray()
    for bs, cnt in _size_groups(sizes):
        lasts = np.empty((cnt, bs), np.uint8)
        rows = np.empty(cnt, np.uint32)
        for i in range(cnt):
            lasts[i] = r.raw(bs)
            rows[i] = r.u32()
        orig = _inverse_fn(cnt, bs)(jnp.asarray(lasts), jnp.asarray(rows))
        out += np.asarray(jax.device_get(orig)).tobytes()
    out += r.raw(rem).tobytes()
    return bytes(out)
