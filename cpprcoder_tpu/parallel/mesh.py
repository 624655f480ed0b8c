"""Device-mesh construction for distributed codec runs.

The reference has no communication layer at all (SURVEY.md §2 parallelism
inventory); the equivalents here follow BASELINE.json: blocks are
data-parallel across devices ('data' axis), the K interleaved coder lanes of
a block are sharded across devices ('lane' axis) with the shared adaptive
model replicated and its batched updates all-reduced (on GPUs over NVLink,
all to all, so the mesh shape follows the algorithm alone).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: int | None = None, lane: int | None = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None and lane is None:
        lane = 2 if n % 2 == 0 and n > 1 else 1
        data = n // lane
    elif data is None:
        data = n // lane
    elif lane is None:
        lane = n // data
    assert data * lane == n, f"mesh {data}x{lane} != {n} devices"
    arr = np.asarray(devices).reshape(data, lane)
    return Mesh(arr, ("data", "lane"))


def multihost_init():
    """Initialize jax.distributed when running under a multi-host launcher
    (no-op single-host). Call before any other jax API in multi-host runs."""
    import os

    if "JAX_COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()
