"""Mesh-sharded codec steps (shard_map over ('data', 'lane')).

Distribution model (BASELINE.json north star):
  - 'data' axis: independent superblocks, one shared-model instance each
    (pure data parallelism — the device generalization of the reference's
    independent 32 KB blocks, blksort.h:432-442).
  - 'lane' axis: the K interleaved lanes of each superblock are sharded;
    the adaptive frequency table is REPLICATED across lane shards and its
    per-step batched histogram update is `psum`'d over the 'lane' axis —
    encoder and decoder stay bit-identical because the update is an
    order-independent sum.
  - assembly: per-shard payload sizes are all-gathered and exclusively
    scanned so each shard knows its byte offset in the final container
    (the size-scan + slice-assembly pattern).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cpprcoder_tpu.ops import compaction, rc_common

U32 = jnp.uint32
I32 = jnp.int32


def _adaptive_shard_body(x3d_local, n_vec_local, k_global, inc, limit,
                         n_slots, steps, k_local):
    """Encode the local lane shard of each local superblock.

    x3d_local: [blocks_local, steps, k_local] u8; n_vec_local [blocks_local]
    true byte counts. Returns events [blocks_local, k_local, E], lane_sizes
    [blocks_local, k_local], shard_total [1]."""
    lane_ax = jax.lax.axis_index("lane").astype(U32)

    from cpprcoder_tpu.ops.lookup import coder_step_lookups2

    def encode_one(x2d, n):
        st = tuple(jax.lax.pvary(a, ("data", "lane"))
                   for a in rc_common.make_state(k_local))
        lane_ids = lane_ax * k_local + jnp.arange(k_local, dtype=U32)
        freqs0 = jax.lax.pvary(jnp.ones(256, U32), ("data",))
        total0 = jax.lax.pvary(U32(256), ("data",))

        def step(carry, xt):
            st, t_idx, freqs, total = carry
            resc = total >= U32(limit)
            f_resc = (freqs >> 1) | 1
            freqs = jnp.where(resc, f_resc, freqs)
            total = jnp.where(resc, f_resc.sum(), total)
            cum_incl = jnp.cumsum(freqs)
            syms = xt.astype(I32)
            active = (t_idx * k_global + lane_ids) < n
            f, c, upd = coder_step_lookups2(freqs, cum_incl, syms, active,
                                            inc)
            t = st[2] // total
            is_top = (c + f) == total
            st2, evs = rc_common.encode_symbol(st, t, c, f, is_top, active,
                                               n_slots)
            hist = jax.lax.psum(upd, "lane")
            freqs = freqs + hist
            total = total + hist.sum()
            return (st2, t_idx + 1, freqs, total), evs

        (st, _, _, _), evs = lax.scan(step, (st, U32(0), freqs0, total0),
                                      x2d)
        flush_evs = rc_common.flush(st)
        events = jnp.concatenate(
            [jnp.transpose(evs, (2, 0, 1)).reshape(k_local, -1),
             jnp.transpose(flush_evs, (1, 0))], axis=1)
        _, _, lane_sizes, _, total_b = compaction.lane_layout(events)
        return events, lane_sizes, total_b

    events, lane_sizes, totals = jax.vmap(encode_one)(x3d_local, n_vec_local)
    return events, lane_sizes, totals.sum()[None]


@lru_cache(maxsize=16)
def _sharded_adaptive_encode_fn(mesh: Mesh, blocks: int, steps: int,
                                k_global: int, inc: int, limit_log2: int):
    limit = 1 << limit_log2
    n_slots = 2 if limit_log2 <= 16 else 3
    lane_n = mesh.shape["lane"]
    k_local = k_global // lane_n
    assert k_local * lane_n == k_global

    body = partial(_adaptive_shard_body, inc=inc, limit=limit,
                   n_slots=n_slots, steps=steps, k_local=k_local)

    @jax.jit
    def run(x3d, n_vec):
        # x3d [blocks, steps, k_global] sharded (data, None, lane)
        def shard_fn(x_local, n_local):
            return body(x_local, n_local, k_global)

        events, lane_sizes, shard_totals = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("data", None, "lane"), P("data")),
            out_specs=(P("data", "lane", None), P("data", "lane"),
                       P(("data", "lane"))),
        )(x3d, n_vec)
        # size-scan assembly: each shard's byte offset in the container
        offsets = jnp.cumsum(shard_totals) - shard_totals
        return events, lane_sizes, shard_totals, offsets

    return run


def sharded_adaptive_encode(x: np.ndarray, mesh: Mesh, blocks: int | None = None,
                            k_global: int = 16, inc: int = 24,
                            limit_log2: int = 16):
    """Distributed encode of `blocks` superblocks over the mesh.

    Returns ((events, lane_sizes, shard_totals, offsets) device arrays,
    (blocks, steps, per_block))."""
    data_n = mesh.shape["data"]
    blocks = blocks or data_n
    n = len(x)
    per_block = -(-n // blocks)
    steps = -(-per_block // k_global)
    padded = np.zeros(blocks * per_block, np.uint8)
    padded[:n] = x
    x3d = np.zeros((blocks, steps * k_global), np.uint8)
    x3d[:, :per_block] = padded.reshape(blocks, per_block)
    x3d = x3d.reshape(blocks, steps, k_global)
    n_vec = np.minimum(per_block,
                       np.maximum(n - np.arange(blocks) * per_block, 0)
                       ).astype(np.uint32)
    fn = _sharded_adaptive_encode_fn(mesh, blocks, steps, k_global, inc,
                                     limit_log2)
    x3d_dev = jax.device_put(x3d, NamedSharding(mesh, P("data", None, "lane")))
    n_dev = jax.device_put(n_vec, NamedSharding(mesh, P("data")))
    return fn(x3d_dev, n_dev), (blocks, steps, per_block)


@lru_cache(maxsize=16)
def _sharded_histogram_fn(mesh: Mesh):
    @jax.jit
    def run(x_sharded):
        def shard_fn(x_local):
            h = jnp.zeros(256, I32).at[x_local.reshape(-1).astype(I32)].add(1)
            return jax.lax.psum(jax.lax.psum(h, "lane"), "data")[None]

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(("data", "lane")),),
            out_specs=P(("data", "lane"), None),
        )(x_sharded)

    return run


def sharded_histogram(x: np.ndarray, mesh: Mesh):
    """Global 256-bin histogram with psum over both mesh axes (the shared
    static-table build for broadcast tables)."""
    n_dev = mesh.devices.size
    pad = -(-max(len(x), 1) // n_dev) * n_dev
    padded = np.zeros(pad, np.uint8)
    padded[: len(x)] = x
    sharding = NamedSharding(mesh, P(("data", "lane")))
    x_dev = jax.device_put(padded, sharding)
    out = _sharded_histogram_fn(mesh)(x_dev)
    h = np.asarray(jax.device_get(out))[0].copy()
    h[0] -= pad - len(x)  # remove zero padding
    return h
