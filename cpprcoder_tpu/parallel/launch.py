"""One-command distributed CT-RCX run (the BASELINE Config-5 north star).

Single host today, multi-host when hardware appears — the SAME command:

    python -m cpprcoder_tpu.parallel.launch [total_bytes] [--hosts N]

Under a multi-host launcher (GKE/SLURM/manual with JAX_COORDINATOR_ADDRESS
set, one process per host), `multihost_init` runs `jax.distributed
.initialize()` and the mesh spans every device of every host; collectives
ride NVLink within a host and the network across. `--hosts N` is a
declaration used to sanity-check the detected topology (process_count), not
to spawn processes — spawning is the launcher's job.

Single-host (no coordinator env), it runs on the local devices — the same
code path the virtual 8-device CPU mesh CI exercises (tests/test_sharded_
rcx.py, __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="distributed CT-RCX roundtrip")
    p.add_argument("total_bytes", nargs="?", type=int, default=1 << 24)
    p.add_argument("--hosts", type=int, default=None,
                   help="expected process count (sanity check only)")
    p.add_argument("--lanes", type=int, default=64,
                   help="global lane count (sharded over the 'lane' axis)")
    p.add_argument("--blocks-per-shard", type=int, default=2)
    args = p.parse_args(argv)

    from cpprcoder_tpu.parallel.mesh import make_mesh, multihost_init

    multihost_init()
    import jax

    if args.hosts is not None and jax.process_count() != args.hosts:
        print(json.dumps({
            "error": f"--hosts {args.hosts} but jax.process_count() = "
                     f"{jax.process_count()} (launcher mismatch)"}))
        return 1

    from cpprcoder_tpu.bench.synth import synth_stream
    from cpprcoder_tpu.parallel.sharded_rcx import (
        sharded_rcx_decode, sharded_rcx_encode)

    mesh = make_mesh()
    data_shards = mesh.shape["data"]
    blocks = data_shards * args.blocks_per_shard
    x = np.frombuffer(synth_stream(args.total_bytes, seed=0), np.uint8)

    t0 = time.perf_counter()
    ((events, lane_sizes, shard_totals, offsets),
     (blocks, n_vec, stride_vec, steps)) = sharded_rcx_encode(
        x, mesh, blocks=blocks, k_global=args.lanes)
    totals = np.asarray(jax.device_get(shard_totals))
    t_enc = time.perf_counter() - t0

    # decode twin over the mesh: payload rows from the encode events
    from cpprcoder_tpu.ops import compaction
    from cpprcoder_tpu.ops.rcq_ops import _rows_fn
    from cpprcoder_tpu.utils.shapes import bucket

    import jax.numpy as jnp

    l4 = bucket((2 * steps + 8) // 4 + 2)
    ev_host = np.asarray(jax.device_get(events))
    rows3d = np.zeros((blocks, args.lanes, l4), np.uint32)
    for b in range(blocks):
        ev = jnp.asarray(ev_host[b])
        total = int(compaction.payload_layout(ev)[4])
        payload, sizes = compaction.materialize(ev, bucket(total + 8))
        p_cap = bucket(max(total, 1))
        padded = np.zeros(p_cap, np.uint8)
        padded[:total] = np.asarray(payload)[:total]
        rows3d[b] = np.asarray(_rows_fn(args.lanes, l4, p_cap)(
            jnp.asarray(padded),
            jnp.asarray(np.asarray(sizes), jnp.int32)))

    t0 = time.perf_counter()
    out = sharded_rcx_decode(rows3d, n_vec, stride_vec, mesh, steps,
                             k_global=args.lanes)
    t_dec = time.perf_counter() - t0

    per_block = -(-len(x) // blocks)
    ok = True
    for b in range(blocks):
        st = int(stride_vec[b])
        nb = int(n_vec[b])
        got = out[b, :st, :].T.reshape(-1)[:nb].astype(np.uint8)
        want = x[b * per_block: b * per_block + nb]
        if not (got == want).all():
            ok = False
            break

    if jax.process_index() == 0:
        print(json.dumps({
            "devices": len(jax.devices()),
            "hosts": jax.process_count(),
            "mesh": dict(mesh.shape),
            "bytes": len(x), "blocks": blocks, "lanes": args.lanes,
            "compressed": int(totals.sum()),
            "enc_wall_s": round(t_enc, 3), "dec_wall_s": round(t_dec, 3),
            "roundtrip_ok": bool(ok),
        }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
