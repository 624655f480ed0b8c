// CT-RCX encode and decode kernels for Hopper (sm_90a), called from JAX
// through the XLA foreign function interface (ops/rcx_cuda.py builds and
// registers this file).
//
// One thread block codes one container (a file or a superblock); a launch
// runs a batch of containers that share (K, inc, climit, cbits, wlog). The
// whole step loop runs inside the block:
//
//   - each thread owns LPT lanes (lane = j * blockDim.x + threadIdx.x) and
//     keeps their coder state in registers;
//   - shared memory holds the counts C[2^cbits][256] (u32) and the window's
//     quantized freq and exclusive-cum tables (u16);
//   - table reads are direct indexes; the count update is an atomicAdd into
//     shared memory (integer, so order-free and bit-exact);
//   - at every window boundary (t % 2^wlog == 0) the block synchronises and
//     requantizes, one warp per context row: native integer division, a
//     warp reduction for the row sums and the first argmax, and a warp scan
//     for the 256-wide cumsum. Between boundaries lanes never meet, so the
//     steps of a window need no barrier.
//
// The arithmetic is models/cxmodel.py's (rescale_rows_jnp, quantize_rows_jnp)
// and ops/rc_common.py's (encode_symbol, flush) bit for bit. Encode writes the
// time-major event grid [E = 2*steps + 2, K] of ops/rc_common.py: rows 2t and
// 2t+1 are step t's two renormalisation slots, the last two rows the flush.
// Decode reads the big-endian word rows [K, L4] of ops/rcq_ops._rows_fn and
// writes the time-major symbol grid [steps, K].

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr uint32_t kQBits = 15;
constexpr uint32_t kQTotal = 1u << kQBits;
constexpr uint32_t kQReserve = 256;
constexpr uint32_t kRcTop = 1u << 24;
constexpr uint32_t kEvRunMask = (1u << 22) - 1;
constexpr int kRescaleRounds = 3;
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Rescale and requantize every context row; one warp per row, lane l owns the
// eight consecutive entries 8l..8l+7.
__device__ void requantize(uint32_t* C, uint16_t* q, uint16_t* cum, int rows,
                           uint32_t climit) {
  const int wid = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = wid; r < rows; r += nwarps) {
    uint32_t* Cr = C + r * 256 + l * 8;
    uint32_t c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = Cr[i];
#pragma unroll
    for (int round = 0; round < kRescaleRounds; ++round) {
      uint32_t s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += c[i];
      if (warp_sum(s) >= climit) {
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = (c[i] >> 1) | 1u;
      }
    }
    uint32_t tot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += c[i];
    tot = warp_sum(tot);
    uint32_t qv[8];
    uint32_t qs = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t v = (c[i] * (kQTotal - kQReserve)) / tot;
      qv[i] = v > 1u ? v : 1u;
      qs += qv[i];
    }
    const uint32_t rem = kQTotal - warp_sum(qs);
    // first argmax: the larger value wins, a tie goes to the lower index
    uint32_t bv = qv[0];
    int bi = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      if (qv[i] > bv) {
        bv = qv[i];
        bi = i;
      }
    }
    int bidx = l * 8 + bi;
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      if (ov > bv || (ov == bv && oi < bidx)) {
        bv = ov;
        bidx = oi;
      }
    }
    if ((bidx >> 3) == l) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == (bidx & 7)) qv[i] += rem;
    }
    uint32_t ex[8];
    uint32_t loc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ex[i] = loc;
      loc += qv[i];
    }
    uint32_t incl = loc;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, off);
      if (l >= off) incl += v;
    }
    const uint32_t base = incl - loc;
    uint16_t* qr = q + r * 256 + l * 8;
    uint16_t* cr = cum + r * 256 + l * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      Cr[i] = c[i];
      qr[i] = static_cast<uint16_t>(qv[i]);
      cr[i] = static_cast<uint16_t>(base + ex[i]);
    }
  }
}

__device__ __forceinline__ uint32_t shift_low(uint32_t& low, uint32_t& carry,
                                              uint32_t& cache,
                                              uint32_t& csize) {
  uint32_t ev = 0;
  if (low < 0xFF000000u || carry) {
    ev = 0x80000000u | (((cache + carry) & 0xFFu) << 23) |
         ((carry & 1u) << 22) | ((csize - 1u) & kEvRunMask);
    cache = low >> 24;
    csize = 0;
    carry = 0;
  }
  csize += 1;
  low <<= 8;
  return ev;
}

__device__ void init_counts(uint32_t* C, int rows) {
  for (int i = threadIdx.x; i < rows * 256; i += blockDim.x) C[i] = 1u;
}

template <int LPT>
__global__ void __launch_bounds__(kMaxThreads)
    rcx_encode_kernel(const uint8_t* __restrict__ x,
                      const int32_t* __restrict__ nvec,
                      uint32_t* __restrict__ ev, int steps, int K,
                      uint32_t inc, uint32_t climit, int cbits, int wlog) {
  extern __shared__ uint32_t smem[];
  const int rows = 1 << cbits;
  uint32_t* C = smem;
  uint16_t* q = reinterpret_cast<uint16_t*>(C + rows * 256);
  uint16_t* cum = q + rows * 256;
  const int shift = 8 - cbits;
  const int W = 1 << wlog;

  const uint8_t* xc = x + static_cast<size_t>(blockIdx.x) * steps * K;
  uint32_t* evc = ev + static_cast<size_t>(blockIdx.x) * (2 * steps + 2) * K;
  const int64_t n = nvec[blockIdx.x];
  const int64_t stride = (n + K - 1) / K;

  uint32_t low[LPT], carry[LPT], rng[LPT], cache[LPT], csize[LPT], prev[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    low[j] = 0;
    carry[j] = 0;
    rng[j] = 0xFFFFFFFFu;
    cache[j] = 0;
    csize[j] = 1;
    prev[j] = 0;
  }
  init_counts(C, rows);

  for (int t = 0; t < steps; ++t) {
    if (t < stride && t % W == 0) {
      __syncthreads();
      requantize(C, q, cum, rows, climit);
      __syncthreads();
    }
    uint32_t* e0 = evc + static_cast<size_t>(2 * t) * K;
    uint32_t* e1 = e0 + K;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = j * blockDim.x + threadIdx.x;
      if (lane >= K) continue;
      uint32_t o0 = 0, o1 = 0;
      if (t < stride && lane * stride + t < n) {
        const uint32_t s = xc[static_cast<size_t>(t) * K + lane];
        const int idx = static_cast<int>(prev[j] >> shift) * 256 + s;
        const uint32_t cu = cum[idx];
        const uint32_t f = q[idx];
        const uint32_t tt = rng[j] >> kQBits;
        const uint32_t add = tt * cu;
        const uint32_t nl = low[j] + add;
        carry[j] |= nl < low[j] ? 1u : 0u;
        low[j] = nl;
        rng[j] = (cu + f == kQTotal) ? rng[j] - add : tt * f;
        if (rng[j] < kRcTop) {
          o0 = shift_low(low[j], carry[j], cache[j], csize[j]);
          rng[j] <<= 8;
        }
        if (rng[j] < kRcTop) {
          o1 = shift_low(low[j], carry[j], cache[j], csize[j]);
          rng[j] <<= 8;
        }
        atomicAdd(&C[idx], inc);
        prev[j] = s;
      }
      e0[lane] = o0;
      e1[lane] = o1;
    }
  }
  uint32_t* f0 = evc + static_cast<size_t>(2 * steps) * K;
  uint32_t* f1 = f0 + K;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int lane = j * blockDim.x + threadIdx.x;
    if (lane >= K) continue;
    // round the code value up to a multiple of 2^24, then two shift_lows
    const uint32_t delta = (0u - low[j]) & 0xFFFFFFu;
    const uint32_t nl = low[j] + delta;
    carry[j] |= nl < low[j] ? 1u : 0u;
    low[j] = nl;
    f0[lane] = shift_low(low[j], carry[j], cache[j], csize[j]);
    f1[lane] = shift_low(low[j], carry[j], cache[j], csize[j]);
  }
}

template <int LPT>
__global__ void __launch_bounds__(kMaxThreads)
    rcx_decode_kernel(const uint32_t* __restrict__ rows_w,
                      const int32_t* __restrict__ nvec,
                      uint8_t* __restrict__ out, int steps, int K, int L4,
                      uint32_t inc, uint32_t climit, int cbits, int wlog) {
  extern __shared__ uint32_t smem[];
  const int rows = 1 << cbits;
  uint32_t* C = smem;
  uint16_t* q = reinterpret_cast<uint16_t*>(C + rows * 256);
  uint16_t* cum = q + rows * 256;
  const int shift = 8 - cbits;
  const int W = 1 << wlog;

  const uint32_t* wc = rows_w + static_cast<size_t>(blockIdx.x) * K * L4;
  uint8_t* oc = out + static_cast<size_t>(blockIdx.x) * steps * K;
  const int64_t n = nvec[blockIdx.x];
  const int64_t stride = (n + K - 1) / K;

  uint32_t rng[LPT], code[LPT], pos[LPT], prev[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int lane = j * blockDim.x + threadIdx.x;
    rng[j] = 0xFFFFFFFFu;
    code[j] = lane < K ? wc[static_cast<size_t>(lane) * L4] : 0u;
    pos[j] = 4;  // next payload byte of the lane
    prev[j] = 0;
  }
  init_counts(C, rows);

  for (int t = 0; t < steps; ++t) {
    if (t < stride && t % W == 0) {
      __syncthreads();
      requantize(C, q, cum, rows, climit);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = j * blockDim.x + threadIdx.x;
      if (lane >= K) continue;
      uint32_t sym = 0;
      if (t < stride && lane * stride + t < n) {
        const int row = static_cast<int>(prev[j] >> shift) * 256;
        const uint16_t* cr = cum + row;
        const uint32_t tt = rng[j] >> kQBits;
        // the unique s with cum[s]*t <= code < cum[s+1]*t (cum is strictly
        // increasing and cum[0] = 0): binary search for the last s that holds
        uint32_t s = 0;
#pragma unroll
        for (uint32_t b = 128; b > 0; b >>= 1)
          if (static_cast<uint32_t>(cr[s + b]) * tt <= code[j]) s += b;
        const uint32_t cu = cr[s];
        const uint32_t f = q[row + s];
        code[j] -= cu * tt;
        rng[j] = (cu + f == kQTotal) ? rng[j] - cu * tt : f * tt;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          if (rng[j] < kRcTop) {
            const uint32_t w = pos[j] >> 2;
            const uint32_t b =
                w < static_cast<uint32_t>(L4)
                    ? (wc[static_cast<size_t>(lane) * L4 + w] >>
                       (24 - 8 * (pos[j] & 3u))) & 0xFFu
                    : 0u;
            pos[j] += 1;
            code[j] = (code[j] << 8) | b;
            rng[j] <<= 8;
          }
        }
        atomicAdd(&C[row + s], inc);
        prev[j] = s;
        sym = s;
      }
      oc[static_cast<size_t>(t) * K + lane] = static_cast<uint8_t>(sym);
    }
  }
}

// Launch shape comes from ops/rcx_cuda.launch_shape (the one place it is
// computed); this side only checks it and picks the template.
ffi::Error check_launch(int K, int cbits, int threads, int lpt, int smem) {
  if (cbits < 0 || cbits > 8) return ffi::Error::InvalidArgument("bad cbits");
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return ffi::Error::InvalidArgument("bad thread count");
  if (static_cast<int64_t>(threads) * lpt < K)
    return ffi::Error::InvalidArgument("threads * lpt < K");
  if (smem != (1 << cbits) * 256 * 8)
    return ffi::Error::InvalidArgument("shared-memory size mismatch");
  return ffi::Error::Success();
}

ffi::Error last_error(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

template <int LPT>
ffi::Error encode_launch(cudaStream_t stream, int blocks, int threads, int smem,
                         const uint8_t* x, const int32_t* n, uint32_t* ev,
                         int steps, int K, uint32_t inc, uint32_t climit,
                         int cbits, int wlog) {
  cudaFuncSetAttribute(rcx_encode_kernel<LPT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rcx_encode_kernel<LPT><<<blocks, threads, smem, stream>>>(
      x, n, ev, steps, K, inc, climit, cbits, wlog);
  return last_error("rcx_encode_kernel");
}

template <int LPT>
ffi::Error decode_launch(cudaStream_t stream, int blocks, int threads, int smem,
                         const uint32_t* rows_w, const int32_t* n,
                         uint8_t* out, int steps, int K, int L4, uint32_t inc,
                         uint32_t climit, int cbits, int wlog) {
  cudaFuncSetAttribute(rcx_decode_kernel<LPT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rcx_decode_kernel<LPT><<<blocks, threads, smem, stream>>>(
      rows_w, n, out, steps, K, L4, inc, climit, cbits, wlog);
  return last_error("rcx_decode_kernel");
}

ffi::Error RcxEncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> x,
                         ffi::Buffer<ffi::S32> n,
                         ffi::ResultBuffer<ffi::U32> ev, int32_t inc,
                         int32_t climit_log2, int32_t cbits, int32_t wlog,
                         int32_t threads, int32_t lpt, int32_t smem) {
  const auto dims = x.dimensions();
  if (dims.size() != 3) return ffi::Error::InvalidArgument("x must be rank 3");
  const int blocks = static_cast<int>(dims[0]);
  const int steps = static_cast<int>(dims[1]);
  const int K = static_cast<int>(dims[2]);
  ffi::Error err = check_launch(K, cbits, threads, lpt, smem);
  if (err.failure()) return err;
  if (blocks == 0) return ffi::Error::Success();
  const uint32_t climit = 1u << climit_log2;
#define RCX_ENCODE(L)                                                        \
  case L:                                                                    \
    return encode_launch<L>(stream, blocks, threads, smem, x.typed_data(),   \
                            n.typed_data(), ev->typed_data(), steps, K, inc, \
                            climit, cbits, wlog);
  switch (lpt) {
    RCX_ENCODE(1)
    RCX_ENCODE(2)
    RCX_ENCODE(4)
    RCX_ENCODE(8)
    RCX_ENCODE(16)
    default:
      return ffi::Error::InvalidArgument("lanes per thread not in {1..16}");
  }
#undef RCX_ENCODE
}

ffi::Error RcxDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> rows_w,
                         ffi::Buffer<ffi::S32> n,
                         ffi::ResultBuffer<ffi::U8> out, int32_t inc,
                         int32_t climit_log2, int32_t cbits, int32_t wlog,
                         int32_t threads, int32_t lpt, int32_t smem) {
  const auto wdims = rows_w.dimensions();
  const auto odims = out->dimensions();
  if (wdims.size() != 3 || odims.size() != 3)
    return ffi::Error::InvalidArgument("rows and out must be rank 3");
  const int blocks = static_cast<int>(wdims[0]);
  const int K = static_cast<int>(wdims[1]);
  const int L4 = static_cast<int>(wdims[2]);
  const int steps = static_cast<int>(odims[1]);
  if (odims[0] != wdims[0] || odims[2] != wdims[1])
    return ffi::Error::InvalidArgument("out must be [blocks, steps, K]");
  ffi::Error err = check_launch(K, cbits, threads, lpt, smem);
  if (err.failure()) return err;
  if (blocks == 0) return ffi::Error::Success();
  const uint32_t climit = 1u << climit_log2;
#define RCX_DECODE(L)                                                       \
  case L:                                                                   \
    return decode_launch<L>(stream, blocks, threads, smem,                  \
                            rows_w.typed_data(), n.typed_data(),            \
                            out->typed_data(), steps, K, L4, inc, climit,   \
                            cbits, wlog);
  switch (lpt) {
    RCX_DECODE(1)
    RCX_DECODE(2)
    RCX_DECODE(4)
    RCX_DECODE(8)
    RCX_DECODE(16)
    default:
      return ffi::Error::InvalidArgument("lanes per thread not in {1..16}");
  }
#undef RCX_DECODE
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RcxEncode, RcxEncodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("inc")
                                  .Attr<int32_t>("climit_log2")
                                  .Attr<int32_t>("cbits")
                                  .Attr<int32_t>("wlog")
                                  .Attr<int32_t>("threads")
                                  .Attr<int32_t>("lpt")
                                  .Attr<int32_t>("smem"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RcxDecode, RcxDecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("inc")
                                  .Attr<int32_t>("climit_log2")
                                  .Attr<int32_t>("cbits")
                                  .Attr<int32_t>("wlog")
                                  .Attr<int32_t>("threads")
                                  .Attr<int32_t>("lpt")
                                  .Attr<int32_t>("smem"));
