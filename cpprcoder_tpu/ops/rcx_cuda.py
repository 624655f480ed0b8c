"""CT-RCX on the GPU: the CUDA kernels of native/rcx_cuda.cu, through jax.ffi.

The kernels run the coder's whole step loop, one thread block per container
(design notes in the .cu file). They have the signatures of the XLA twins in
ops/rcx_ops.py (xla_events / xla_symbols), and the container framing there
(rcx_ops.encode_many / decode_many) frames their output as it frames the
twins': the kernel route and the XLA route differ only in the coder loop.

    kernel_events:  x [nc, steps, K] u8, n [nc] -> events [nc, 2*steps+2, K]
    kernel_symbols: word rows [nc, K, L4] u32, n [nc] -> symbols [nc, steps, K]

The library is built with nvcc from the tracked source into build/ at first
use; `build_seconds` records how long that took (set-up time). Without nvcc,
or when the build fails, `library()` raises: nothing falls back. A shape the
kernels do not take (`takes`) raises too; the route rule (codecs/rcx.py)
sends such shapes to the XLA twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SRC = os.path.join(_ROOT, "native", "rcx_cuda.cu")
BUILD_DIR = os.path.join(_ROOT, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
ENCODE_TARGET = "cpprcoder_rcx_encode"
DECODE_TARGET = "cpprcoder_rcx_decode"

MIN_THREADS = 128       # four warps share a requantization
MAX_THREADS = 512       # the kernels' __launch_bounds__
MAX_LPT = 16            # lanes per thread the kernels are instantiated for
MAX_LANES = MAX_THREADS * MAX_LPT
SMEM_LIMIT = 232_448    # shared memory one block may opt into on sm_90


def smem_bytes(cbits: int) -> int:
    """C [2^cbits, 256] u32 + quantized freq and cum tables, u16 each."""
    return (1 << cbits) * 256 * (4 + 2 + 2)


def launch_shape(k: int, cbits: int) -> tuple[int, int, int]:
    """(threads per block, lanes per thread, shared bytes) for K lanes."""
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-k // 32) * 32))
    lpt = -(-k // threads)
    return threads, 1 << (lpt - 1).bit_length(), smem_bytes(cbits)


def takes(k: int, cbits: int) -> bool:
    """The kernels' shape rule: a wider K or model goes to the XLA twin."""
    return k <= MAX_LANES and smem_bytes(cbits) <= SMEM_LIMIT


# ------------------------------------------------------------------ library

_LIB = None
build_seconds: float | None = None


def find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    return shutil.which("nvcc") or (cand if os.path.exists(cand) else None)


def _build() -> str:
    with open(SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"librcx_cuda-{tag}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "CT-RCX GPU kernels: nvcc not found (set CUDA_HOME); "
            "backend='jax' runs the XLA twin instead")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, SRC],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CT-RCX GPU kernels: nvcc failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library():
    """Build (once per source version), load and register the kernels."""
    global _LIB, build_seconds
    if _LIB is None:
        t0 = time.perf_counter()
        lib = ctypes.cdll.LoadLibrary(_build())
        for name, sym in ((ENCODE_TARGET, lib.RcxEncode),
                          (DECODE_TARGET, lib.RcxDecode)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        build_seconds = time.perf_counter() - t0
        _LIB = lib
    return _LIB


def _attrs(k, inc, climit_log2, cbits, wlog):
    if not takes(k, cbits):
        raise ValueError(f"CT-RCX kernels do not take K={k} "
                         f"cbits={cbits}; route it to the XLA twin")
    threads, lpt, smem = launch_shape(k, cbits)
    return {name: np.int32(v) for name, v in (
        ("inc", inc), ("climit_log2", climit_log2), ("cbits", cbits),
        ("wlog", wlog), ("threads", threads), ("lpt", lpt), ("smem", smem))}


def kernel_events(x3d, n_vec, *, inc, climit_log2, cbits, wlog):
    """x [nc, steps, K] u8, n [nc] i32 -> events [nc, 2*steps+2, K] u32."""
    nc, steps, k = x3d.shape
    attrs = _attrs(k, inc, climit_log2, cbits, wlog)
    library()
    return jax.ffi.ffi_call(
        ENCODE_TARGET,
        jax.ShapeDtypeStruct((nc, 2 * steps + 2, k), jnp.uint32))(
            x3d, n_vec, **attrs)


def kernel_symbols(rows_w, n_vec, steps, *, inc, climit_log2, cbits, wlog):
    """word rows [nc, K, L4] u32, n [nc] i32 -> symbols [nc, steps, K] u8."""
    nc, k, _ = rows_w.shape
    attrs = _attrs(k, inc, climit_log2, cbits, wlog)
    library()
    return jax.ffi.ffi_call(
        DECODE_TARGET, jax.ShapeDtypeStruct((nc, steps, k), jnp.uint8))(
            rows_w, n_vec, **attrs)
