// Native host-side implementation of the CT-RC1/CT-RC2 container formats
// (FORMATS.md). Purpose: a fast bit-exact verifier and host fallback codec
// for the device codecs — large-input oracle checks (the 128 MiB adaptive
// stress test mirrors test/main.cpp:1201-1237 of the reference) run here at
// native speed instead of through the scalar Python oracle.
//
// This implements the CT specs (K round-robin lanes, LZMA-style carry
// pipeline, 2-byte minimal flush, shared batched adaptive model); it is not
// a copy of the reference C++, whose formats are different.
//
// Build: g++ -O2 -shared -fPIC -o libctrc.so ctrc.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kStaticTotalBits = 16;
constexpr uint32_t kStaticTotal = 1u << kStaticTotalBits;

struct LaneEncoder {
  uint64_t low = 0;  // bit 32 = pending carry
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;  // includes initial dummy byte
  std::vector<uint8_t> out;

  void shift_low() {
    uint32_t low32 = static_cast<uint32_t>(low);
    if (low32 < 0xFF000000u || low > 0xFFFFFFFFull) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      out.push_back(static_cast<uint8_t>(cache + carry));
      for (uint64_t i = 1; i < cache_size; ++i)
        out.push_back(static_cast<uint8_t>(0xFFu + carry));
      cache = static_cast<uint8_t>(low32 >> 24);
      cache_size = 0;
    }
    ++cache_size;
    low = (static_cast<uint64_t>(low32) << 8) & 0xFFFFFFFFull;
  }

  void encode(uint32_t cum, uint32_t freq, uint32_t total, uint32_t t) {
    low += static_cast<uint64_t>(t) * cum;
    if (cum + freq == total)
      range -= t * cum;
    else
      range = t * freq;
    while (range < kTop) {
      shift_low();
      range <<= 8;
    }
  }

  void finish() {
    low += (0u - static_cast<uint32_t>(low)) & 0xFFFFFFu;
    shift_low();
    shift_low();
  }
};

struct LaneDecoder {
  const uint8_t* data;
  int64_t pos = 0, size = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  void init(const uint8_t* d, int64_t s) {
    data = d;
    size = s;
    pos = 0;
    for (int i = 0; i < 4; ++i) code = (code << 8) | next();
  }
  uint8_t next() { return pos < size ? data[pos++] : 0; }
  void consume(uint32_t cum, uint32_t freq, uint32_t total, uint32_t t) {
    code -= t * cum;
    if (cum + freq == total)
      range -= t * cum;
    else
      range = t * freq;
    while (range < kTop) {
      code = (code << 8) | next();
      range <<= 8;
    }
  }
};

void write_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 24) & 0xFF);
}

// normalization per FORMATS.md (prescale to 14 bits + largest remainder)
void normalize(const int64_t* counts_in, int total_bits, uint32_t* freqs) {
  int64_t counts[256];
  int64_t n = 0;
  for (int i = 0; i < 256; ++i) n += counts_in[i];
  int shift = 0;
  {
    int64_t m = n - 1;
    int bl = 0;
    while (m > 0) {
      ++bl;
      m >>= 1;
    }
    shift = bl > 14 ? bl - 14 : 0;
  }
  int64_t nn = 0;
  for (int i = 0; i < 256; ++i) {
    counts[i] = counts_in[i] >> shift;
    if (counts_in[i] > 0 && counts[i] == 0) counts[i] = 1;
    nn += counts[i];
  }
  const int64_t total = 1ll << total_bits;
  int64_t f[256], r[256];
  int64_t sum = 0;
  for (int i = 0; i < 256; ++i) {
    f[i] = counts[i] * total / nn;
    r[i] = counts[i] * total % nn;
    if (counts[i] > 0 && f[i] == 0) f[i] = 1;
    sum += f[i];
  }
  int64_t d = total - sum;
  if (d > 0) {
    // rank by remainder desc, symbol asc
    int order[256];
    for (int i = 0; i < 256; ++i) order[i] = i;
    for (int i = 1; i < 256; ++i) {  // stable insertion sort by -r
      int o = order[i];
      int j = i;
      while (j > 0 && r[order[j - 1]] < r[o]) {
        order[j] = order[j - 1];
        --j;
      }
      order[j] = o;
    }
    for (int t = 0; t < 256 && d > 0; ++t) {
      int s = order[t];
      if (counts[s] > 0) {
        ++f[s];
        --d;
      }
    }
  } else if (d < 0) {
    int64_t need = -d;
    int order[256];
    for (int i = 0; i < 256; ++i) order[i] = i;
    for (int i = 1; i < 256; ++i) {  // stable insertion sort by -f
      int o = order[i];
      int j = i;
      while (j > 0 && f[order[j - 1]] < f[o]) {
        order[j] = order[j - 1];
        --j;
      }
      order[j] = o;
    }
    for (int t = 0; t < 256 && need > 0; ++t) {
      int s = order[t];
      int64_t ex = counts[s] > 0 ? f[s] - 1 : 0;
      int64_t take = ex < need ? ex : need;
      f[s] -= take;
      need -= take;
    }
  }
  for (int i = 0; i < 256; ++i)
    if (f[i] == total) {
      --f[i];
      ++f[(i + 1) % 256];
    }
  for (int i = 0; i < 256; ++i) freqs[i] = static_cast<uint32_t>(f[i]);
}

// packed frequency table (FORMATS.md "Packed frequency table"):
// 128 B nibble classes b = min(bitlen(f), 15) (low nibble first), then an
// LSB-first extra-bit stream (b-1 bits of f - 2^(b-1) for 2<=b<15; 16 bits
// of f - 2^14 for b == 15)
void pack_freqs(const uint32_t* f, std::vector<uint8_t>& out) {
  uint8_t b[256];
  for (int s = 0; s < 256; ++s) {
    uint32_t v = f[s];
    int bl = 0;
    while (v) {
      ++bl;
      v >>= 1;
    }
    b[s] = bl > 15 ? 15 : bl;
  }
  for (int s = 0; s < 256; s += 2)
    out.push_back(static_cast<uint8_t>(b[s] | (b[s + 1] << 4)));
  uint64_t acc = 0;
  int nbits = 0;
  for (int s = 0; s < 256; ++s) {
    int eb = b[s] <= 1 ? 0 : (b[s] < 15 ? b[s] - 1 : 16);
    if (!eb) continue;
    uint32_t val = b[s] < 15 ? f[s] - (1u << (b[s] - 1)) : f[s] - (1u << 14);
    acc |= static_cast<uint64_t>(val) << nbits;
    nbits += eb;
    while (nbits >= 8) {
      out.push_back(static_cast<uint8_t>(acc & 0xFF));
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits) out.push_back(static_cast<uint8_t>(acc & 0xFF));
}

// returns bytes consumed, or -1 on underrun
int64_t unpack_freqs(const uint8_t* p, int64_t avail, uint32_t* f) {
  if (avail < 128) return -1;
  uint8_t b[256];
  for (int s = 0; s < 128; ++s) {
    b[2 * s] = p[s] & 0xF;
    b[2 * s + 1] = p[s] >> 4;
  }
  uint64_t acc = 0;
  int nbits = 0;
  int64_t pos = 128;
  for (int s = 0; s < 256; ++s) {
    int eb = b[s] <= 1 ? 0 : (b[s] < 15 ? b[s] - 1 : 16);
    if (!eb) {
      f[s] = b[s];
      continue;
    }
    while (nbits < eb) {
      if (pos >= avail) return -1;
      acc |= static_cast<uint64_t>(p[pos++]) << nbits;
      nbits += 8;
    }
    uint32_t v = static_cast<uint32_t>(acc & ((1u << eb) - 1));
    acc >>= eb;
    nbits -= eb;
    f[s] = (b[s] == 15 ? (1u << 14) : (1u << (b[s] - 1))) + v;
  }
  return pos;
}

int64_t assemble(std::vector<uint8_t>& hdr, std::vector<LaneEncoder>& lanes,
                 uint8_t lane_desc_base, uint8_t* dst, int64_t cap) {
  uint64_t max_size = 0, total = 0;
  for (auto& l : lanes) {
    uint64_t s = l.out.size() - 1;  // drop dummy
    max_size = s > max_size ? s : max_size;
    total += s;
  }
  bool wide = max_size >= (1u << 16);
  hdr[4] = lane_desc_base | (wide ? 0x80 : 0);
  std::vector<uint8_t> sizes;
  for (auto& l : lanes) {
    uint32_t s = static_cast<uint32_t>(l.out.size() - 1);
    sizes.push_back(s & 0xFF);
    sizes.push_back((s >> 8) & 0xFF);
    if (wide) {
      sizes.push_back((s >> 16) & 0xFF);
      sizes.push_back((s >> 24) & 0xFF);
    }
  }
  int64_t need = hdr.size() + sizes.size() + total;
  if (need > cap) return -1;
  uint8_t* p = dst;
  std::memcpy(p, hdr.data(), hdr.size());
  p += hdr.size();
  std::memcpy(p, sizes.data(), sizes.size());
  p += sizes.size();
  for (auto& l : lanes) {
    std::memcpy(p, l.out.data() + 1, l.out.size() - 1);
    p += l.out.size() - 1;
  }
  return need;
}

int lane_log2(uint32_t k) {
  int e = 0;
  while ((1u << e) < k) ++e;
  return e;
}

}  // namespace

extern "C" {

int64_t ct_static_encode(const uint8_t* src, int64_t n, uint32_t k,
                         uint8_t* dst, int64_t cap) {
  std::vector<uint8_t> hdr;
  write_u32(hdr, static_cast<uint32_t>(n));
  hdr.push_back(0);  // lane desc patched by assemble
  if (n == 0) {
    if (cap < 5) return -1;
    std::memcpy(dst, hdr.data(), 5);
    dst[4] = lane_log2(k);
    return 5;
  }
  int64_t counts[256] = {0};
  for (int64_t i = 0; i < n; ++i) ++counts[src[i]];
  uint32_t freqs[256], cums[256];
  normalize(counts, kStaticTotalBits, freqs);
  uint32_t c = 0;
  for (int i = 0; i < 256; ++i) {
    cums[i] = c;
    c += freqs[i];
  }
  pack_freqs(freqs, hdr);
  std::vector<LaneEncoder> lanes(k);
  for (int64_t i = 0; i < n; ++i) {
    LaneEncoder& e = lanes[i % k];
    uint8_t s = src[i];
    e.encode(cums[s], freqs[s], kStaticTotal, e.range >> kStaticTotalBits);
  }
  for (auto& l : lanes) l.finish();
  return assemble(hdr, lanes, lane_log2(k), dst, cap);
}

int64_t ct_static_decode(const uint8_t* src, int64_t src_size, uint8_t* dst,
                         int64_t cap) {
  if (src_size < 5) return -1;
  uint32_t n;
  std::memcpy(&n, src, 4);
  if (static_cast<int64_t>(n) > cap) return -1;
  if ((src[4] & 0x1F) > 16) return -1;  // lane bound, matches the oracle
  uint32_t k = 1u << (src[4] & 0x1F);
  bool wide = src[4] & 0x80;
  if (n == 0) return 0;
  const uint8_t* p = src + 5;
  uint32_t freqs[256], cums[256];
  {
    int64_t used = unpack_freqs(p, src_size - 5, freqs);
    if (used < 0) return -1;
    p += used;
  }
  uint32_t c = 0;
  for (int i = 0; i < 256; ++i) {
    cums[i] = c;
    c += freqs[i];
  }
  std::vector<uint8_t> sym_of(kStaticTotal);
  {
    uint32_t pos = 0;
    for (int s = 0; s < 256; ++s)
      for (uint32_t j = 0; j < freqs[s]; ++j) sym_of[pos++] = s;
  }
  std::vector<int64_t> sizes(k);
  for (uint32_t j = 0; j < k; ++j) {
    sizes[j] = p[0] | (p[1] << 8);
    p += 2;
    if (wide) {
      sizes[j] |= (static_cast<int64_t>(p[0]) << 16) |
                  (static_cast<int64_t>(p[1]) << 24);
      p += 2;
    }
  }
  std::vector<LaneDecoder> lanes(k);
  for (uint32_t j = 0; j < k; ++j) {
    lanes[j].init(p, sizes[j]);
    p += sizes[j];
  }
  for (int64_t i = 0; i < n; ++i) {
    LaneDecoder& d = lanes[i % k];
    uint32_t t = d.range >> kStaticTotalBits;
    uint32_t v = d.code / t;
    if (v > kStaticTotal - 1) v = kStaticTotal - 1;
    uint8_t s = sym_of[v];
    dst[i] = s;
    d.consume(cums[s], freqs[s], kStaticTotal, t);
  }
  return n;
}

int64_t ct_adaptive_encode(const uint8_t* src, int64_t n, uint32_t k,
                           uint32_t inc, uint32_t limit_log2, uint8_t* dst,
                           int64_t cap) {
  std::vector<uint8_t> hdr;
  write_u32(hdr, static_cast<uint32_t>(n));
  hdr.push_back(0);
  hdr.push_back(static_cast<uint8_t>(inc));
  hdr.push_back(static_cast<uint8_t>(limit_log2));
  if (n == 0) {
    if (cap < 7) return -1;
    std::memcpy(dst, hdr.data(), 7);
    dst[4] = lane_log2(k);
    return 7;
  }
  const uint32_t limit = 1u << limit_log2;
  std::vector<uint32_t> freqs(256, 1), cums(256);
  uint32_t total = 256;
  std::vector<LaneEncoder> lanes(k);
  int64_t steps = (n + k - 1) / k;
  for (int64_t t = 0; t < steps; ++t) {
    if (total >= limit) {
      total = 0;
      for (int i = 0; i < 256; ++i) {
        freqs[i] = (freqs[i] >> 1) | 1;
        total += freqs[i];
      }
    }
    uint32_t cacc = 0;
    for (int i = 0; i < 256; ++i) {
      cums[i] = cacc;
      cacc += freqs[i];
    }
    int64_t base = t * k;
    int64_t active = n - base < static_cast<int64_t>(k) ? n - base : k;
    for (int64_t j = 0; j < active; ++j) {
      LaneEncoder& e = lanes[j];
      uint8_t s = src[base + j];
      e.encode(cums[s], freqs[s], total, e.range / total);
    }
    for (int64_t j = 0; j < active; ++j) freqs[src[base + j]] += inc;
    total += static_cast<uint32_t>(active) * inc;
  }
  for (auto& l : lanes) l.finish();
  int64_t out = assemble(hdr, lanes, lane_log2(k), dst, cap);
  return out;
}

int64_t ct_adaptive_decode(const uint8_t* src, int64_t src_size, uint8_t* dst,
                           int64_t cap) {
  if (src_size < 7) return -1;
  uint32_t n;
  std::memcpy(&n, src, 4);
  if (static_cast<int64_t>(n) > cap) return -1;
  if ((src[4] & 0x1F) > 16 || src[6] >= 32) return -1;  // header bounds
  uint32_t k = 1u << (src[4] & 0x1F);
  bool wide = src[4] & 0x80;
  uint32_t inc = src[5];
  uint32_t limit = 1u << src[6];
  if (n == 0) return 0;
  const uint8_t* p = src + 7;
  std::vector<int64_t> sizes(k);
  for (uint32_t j = 0; j < k; ++j) {
    sizes[j] = p[0] | (p[1] << 8);
    p += 2;
    if (wide) {
      sizes[j] |= (static_cast<int64_t>(p[0]) << 16) |
                  (static_cast<int64_t>(p[1]) << 24);
      p += 2;
    }
  }
  std::vector<LaneDecoder> lanes(k);
  for (uint32_t j = 0; j < k; ++j) {
    lanes[j].init(p, sizes[j]);
    p += sizes[j];
  }
  std::vector<uint32_t> freqs(256, 1), cums(257);
  uint32_t total = 256;
  int64_t steps = (n + k - 1) / k;
  for (int64_t t = 0; t < steps; ++t) {
    if (total >= limit) {
      total = 0;
      for (int i = 0; i < 256; ++i) {
        freqs[i] = (freqs[i] >> 1) | 1;
        total += freqs[i];
      }
    }
    uint32_t cacc = 0;
    for (int i = 0; i < 256; ++i) {
      cums[i] = cacc;
      cacc += freqs[i];
    }
    cums[256] = total;
    int64_t base = t * k;
    int64_t active =
        static_cast<int64_t>(n) - base < static_cast<int64_t>(k)
            ? static_cast<int64_t>(n) - base
            : k;
    for (int64_t j = 0; j < active; ++j) {
      LaneDecoder& d = lanes[j];
      uint32_t tt = d.range / total;
      uint32_t v = d.code / tt;
      if (v > total - 1) v = total - 1;
      // binary search: greatest s with cums[s] <= v
      uint32_t lo = 0, hi = 256;
      while (lo + 1 < hi) {
        uint32_t mid = (lo + hi) >> 1;
        if (cums[mid] <= v)
          lo = mid;
        else
          hi = mid;
      }
      dst[base + j] = static_cast<uint8_t>(lo);
      d.consume(cums[lo], freqs[lo], total, tt);
    }
    for (int64_t j = 0; j < active; ++j) freqs[dst[base + j]] += inc;
    total += static_cast<uint32_t>(active) * inc;
  }
  return n;
}

}  // extern "C"


// ---------------------------------------------------------------- CT-RCQ
// Quantized-model adaptive range coder (format: reference/rcq_ref.py;
// model: cpprcoder_tpu/models/qmodel.py). The host verifier twin of the
// JAX backends: containers must be byte-identical.

static const uint32_t kQBits = 15;
static const uint32_t kQTotal = 1u << kQBits;
static const uint32_t kQReserve = 256;

static void rcq_quantize(const uint32_t* C, uint32_t* q) {
  uint64_t tot = 0;
  for (int i = 0; i < 256; ++i) tot += C[i];
  uint32_t sum = 0;
  for (int i = 0; i < 256; ++i) {
    uint64_t num = static_cast<uint64_t>(C[i]) * (kQTotal - kQReserve);
    uint32_t v = static_cast<uint32_t>(num / tot);
    q[i] = v < 1 ? 1 : v;
    sum += q[i];
  }
  uint32_t rem = kQTotal - sum;
  int arg = 0;
  for (int i = 1; i < 256; ++i)
    if (q[i] > q[arg]) arg = i;   // first max
  q[arg] += rem;
}

static void rcq_model_step(uint32_t* C, uint32_t climit, uint32_t* q,
                           uint32_t* cums) {
  uint64_t tot = 0;
  for (int i = 0; i < 256; ++i) tot += C[i];
  if (tot >= climit)
    for (int i = 0; i < 256; ++i) C[i] = (C[i] >> 1) | 1;
  rcq_quantize(C, q);
  uint32_t acc = 0;
  for (int i = 0; i < 256; ++i) {
    cums[i] = acc;
    acc += q[i];
  }
}

extern "C" {

int64_t ct_rcq_encode(const uint8_t* src, int64_t n, uint32_t k,
                      uint32_t inc, uint32_t climit_log2, uint8_t* dst,
                      int64_t cap) {
  std::vector<uint8_t> hdr;
  write_u32(hdr, static_cast<uint32_t>(n));
  hdr.push_back(0);
  hdr.push_back(static_cast<uint8_t>(inc));
  hdr.push_back(static_cast<uint8_t>(climit_log2));
  hdr.push_back(static_cast<uint8_t>(kQBits));
  if (n == 0) {
    if (cap < 8) return -1;
    std::memcpy(dst, hdr.data(), 8);
    dst[4] = lane_log2(k);
    return 8;
  }
  const uint32_t climit = 1u << climit_log2;
  std::vector<uint32_t> C(256, 1), q(256), cums(256);
  std::vector<LaneEncoder> lanes(k);
  int64_t steps = (n + k - 1) / k;
  for (int64_t t = 0; t < steps; ++t) {
    rcq_model_step(C.data(), climit, q.data(), cums.data());
    int64_t base = t * k;
    int64_t active = n - base < static_cast<int64_t>(k) ? n - base : k;
    for (int64_t j = 0; j < active; ++j) {
      LaneEncoder& e = lanes[j];
      uint8_t s = src[base + j];
      e.encode(cums[s], q[s], kQTotal, e.range >> kQBits);
    }
    for (int64_t j = 0; j < active; ++j) C[src[base + j]] += inc;
  }
  for (auto& l : lanes) l.finish();
  return assemble(hdr, lanes, lane_log2(k), dst, cap);
}

int64_t ct_rcq_decode(const uint8_t* src, int64_t src_size, uint8_t* dst,
                      int64_t cap) {
  if (src_size < 8) return -1;
  uint32_t n;
  std::memcpy(&n, src, 4);
  if ((src[4] & 0x1F) > 16 || src[6] >= 32) return -1;  // header bounds
  uint32_t k = 1u << (src[4] & 0x1F);
  bool wide = (src[4] & 0x80) != 0;
  uint32_t inc = src[5];
  uint32_t climit = 1u << src[6];
  if (src[7] != kQBits) return -1;
  if (n == 0) return 0;
  if (static_cast<int64_t>(n) > cap) return -1;
  int64_t pos = 8;
  std::vector<int64_t> sizes(k);
  for (uint32_t j = 0; j < k; ++j) {
    if (wide) {
      if (pos + 4 > src_size) return -1;
      uint32_t v;
      std::memcpy(&v, src + pos, 4);
      sizes[j] = v;
      pos += 4;
    } else {
      if (pos + 2 > src_size) return -1;
      sizes[j] = src[pos] | (src[pos + 1] << 8);
      pos += 2;
    }
  }
  std::vector<LaneDecoder> decs(k);
  for (uint32_t j = 0; j < k; ++j) {
    if (pos + sizes[j] > src_size) return -1;
    decs[j].init(src + pos, sizes[j]);
    pos += sizes[j];
  }
  std::vector<uint32_t> C(256, 1), q(256), cums(256);
  int64_t steps = (n + k - 1) / k;
  for (int64_t t = 0; t < steps; ++t) {
    rcq_model_step(C.data(), climit, q.data(), cums.data());
    int64_t base = t * k;
    int64_t active = n - base < static_cast<int64_t>(k) ? n - base : k;
    for (int64_t j = 0; j < active; ++j) {
      LaneDecoder& d = decs[j];
      uint32_t tt = d.range >> kQBits;
      // s = max{s : cums[s]*t <= code} (binary search, u64-exact)
      int lo = 0, hi = 255;
      while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (static_cast<uint64_t>(cums[mid]) * tt <= d.code)
          lo = mid;
        else
          hi = mid - 1;
      }
      dst[base + j] = static_cast<uint8_t>(lo);
      d.consume(cums[lo], q[lo], kQTotal, tt);
    }
    for (int64_t j = 0; j < active; ++j) C[dst[base + j]] += inc;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------- CT-RCX
// Context-conditioned quantized adaptive range coder (format:
// reference/rcx_ref.py; model: cpprcoder_tpu/models/cxmodel.py). Chunked
// lane layout: lane i owns src[i*stride .. i*stride+stride); the context
// of a symbol is the lane's PREVIOUS byte >> (8 - cbits). Host verifier
// twin of the JAX backends: containers must be byte-identical.

namespace {

struct RcxModel {
  int B;
  uint32_t climit, inc;
  std::vector<uint32_t> C, q, cums;
  std::vector<uint64_t> tot;
  std::vector<uint8_t> dirty;

  RcxModel(int cbits, uint32_t climit_, uint32_t inc_)
      : B(1 << cbits), climit(climit_), inc(inc_),
        C(static_cast<size_t>(B) * 256, 1),
        q(static_cast<size_t>(B) * 256, 0),
        cums(static_cast<size_t>(B) * 256, 0),
        tot(B, 256), dirty(B, 1) {}

  // v2 window boundary: rescale (up to 3 conditional halvings, matching
  // models/cxmodel.py RESCALE_ROUNDS — between requants a row can exceed
  // 2*climit) then requantize every row whose counts changed. Tables are
  // FROZEN until the next boundary even though counts keep updating, so
  // quantization must happen here, not lazily at use time.
  void begin_window() {
    for (int round = 0; round < 3; ++round) {
      bool any = false;
      for (int r = 0; r < B; ++r) {
        if (tot[r] >= climit) {
          uint32_t* row = &C[static_cast<size_t>(r) * 256];
          uint64_t t = 0;
          for (int i = 0; i < 256; ++i) {
            row[i] = (row[i] >> 1) | 1;
            t += row[i];
          }
          tot[r] = t;
          dirty[r] = 1;
          any = true;
        }
      }
      if (!any) break;
    }
    for (int r = 0; r < B; ++r)
      if (dirty[r]) quantize_row(r);
  }

  // quantize row r (pure function of C[r]; identical per-row semantics to
  // rcq_quantize: floor-scale, min 1, remainder to first max)
  void quantize_row(int r) {
    const uint32_t* row = &C[static_cast<size_t>(r) * 256];
    uint32_t* qr = &q[static_cast<size_t>(r) * 256];
    uint32_t sum = 0;
    for (int i = 0; i < 256; ++i) {
      uint64_t num = static_cast<uint64_t>(row[i]) * (kQTotal - kQReserve);
      uint32_t v = static_cast<uint32_t>(num / tot[r]);
      qr[i] = v < 1 ? 1 : v;
      sum += qr[i];
    }
    uint32_t rem = kQTotal - sum;
    int arg = 0;
    for (int i = 1; i < 256; ++i)
      if (qr[i] > qr[arg]) arg = i;  // first max
    qr[arg] += rem;
    uint32_t* cr = &cums[static_cast<size_t>(r) * 256];
    uint32_t acc = 0;
    for (int i = 0; i < 256; ++i) {
      cr[i] = acc;
      acc += qr[i];
    }
    dirty[r] = 0;
  }

  const uint32_t* row_cums(int r) const {
    return &cums[static_cast<size_t>(r) * 256];
  }

  uint32_t row_q(int r, int s) const {
    return q[static_cast<size_t>(r) * 256 + s];
  }

  void update(int r, int s) {
    C[static_cast<size_t>(r) * 256 + s] += inc;
    tot[r] += inc;
    dirty[r] = 1;
  }
};

}  // namespace

extern "C" {

int64_t ct_rcx_encode(const uint8_t* src, int64_t n, uint32_t k,
                      uint32_t inc, uint32_t climit_log2, uint32_t cbits,
                      uint32_t wlog, uint8_t* dst, int64_t cap) {
  if (wlog > 3) return -1;
  std::vector<uint8_t> hdr;
  write_u32(hdr, static_cast<uint32_t>(n));
  hdr.push_back(0);
  hdr.push_back(static_cast<uint8_t>(inc));
  hdr.push_back(static_cast<uint8_t>(climit_log2));
  hdr.push_back(static_cast<uint8_t>(kQBits));
  hdr.push_back(static_cast<uint8_t>(cbits));
  hdr.push_back(static_cast<uint8_t>(wlog));
  if (n == 0) {
    if (cap < 10) return -1;
    std::memcpy(dst, hdr.data(), 10);
    dst[4] = lane_log2(k);
    return 10;
  }
  RcxModel m(cbits, 1u << climit_log2, inc);
  std::vector<LaneEncoder> lanes(k);
  std::vector<uint8_t> prev(k, 0);
  int64_t stride = (n + k - 1) / k;
  int64_t W = int64_t(1) << wlog;
  int shift = 8 - static_cast<int>(cbits);
  for (int64_t t = 0; t < stride; ++t) {
    if (t % W == 0) m.begin_window();
    // active lanes are the prefix {i : i*stride + t < n}
    int64_t active = (n - t + stride - 1) / stride;
    for (int64_t i = 0; i < active; ++i) {
      LaneEncoder& e = lanes[i];
      uint8_t s = src[i * stride + t];
      int r = cbits ? (prev[i] >> shift) : 0;
      const uint32_t* cr = m.row_cums(r);
      e.encode(cr[s], m.row_q(r, s), kQTotal, e.range >> kQBits);
    }
    for (int64_t i = 0; i < active; ++i) {
      uint8_t s = src[i * stride + t];
      m.update(cbits ? (prev[i] >> shift) : 0, s);
      prev[i] = s;
    }
  }
  for (auto& l : lanes) l.finish();
  return assemble(hdr, lanes, lane_log2(k), dst, cap);
}

int64_t ct_rcx_decode(const uint8_t* src, int64_t src_size, uint8_t* dst,
                      int64_t cap) {
  if (src_size < 10) return -1;
  uint32_t n;
  std::memcpy(&n, src, 4);
  if ((src[4] & 0x1F) > 16 || src[6] >= 32) return -1;  // header bounds
  uint32_t k = 1u << (src[4] & 0x1F);
  bool wide = (src[4] & 0x80) != 0;
  uint32_t inc = src[5];
  uint32_t climit_log2 = src[6];
  if (src[7] != kQBits) return -1;
  uint32_t cbits = src[8];
  if (cbits > 8) return -1;
  uint32_t wlog = src[9];
  if (wlog > 3) return -1;
  if (n == 0) return 0;
  if (static_cast<int64_t>(n) > cap) return -1;
  int64_t pos = 10;
  std::vector<int64_t> sizes(k);
  for (uint32_t j = 0; j < k; ++j) {
    if (wide) {
      if (pos + 4 > src_size) return -1;
      uint32_t v;
      std::memcpy(&v, src + pos, 4);
      sizes[j] = v;
      pos += 4;
    } else {
      if (pos + 2 > src_size) return -1;
      sizes[j] = src[pos] | (src[pos + 1] << 8);
      pos += 2;
    }
  }
  std::vector<LaneDecoder> decs(k);
  for (uint32_t j = 0; j < k; ++j) {
    if (pos + sizes[j] > src_size) return -1;
    decs[j].init(src + pos, sizes[j]);
    pos += sizes[j];
  }
  RcxModel m(cbits, 1u << climit_log2, inc);
  std::vector<uint8_t> prev(k, 0);
  int64_t stride = (n + k - 1) / k;
  int64_t W = int64_t(1) << wlog;
  int shift = 8 - static_cast<int>(cbits);
  for (int64_t t = 0; t < stride; ++t) {
    if (t % W == 0) m.begin_window();
    int64_t active = (n - t + stride - 1) / stride;
    for (int64_t i = 0; i < active; ++i) {
      LaneDecoder& d = decs[i];
      int r = cbits ? (prev[i] >> shift) : 0;
      const uint32_t* cr = m.row_cums(r);
      uint32_t tt = d.range >> kQBits;
      int lo = 0, hi = 255;
      while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (static_cast<uint64_t>(cr[mid]) * tt <= d.code)
          lo = mid;
        else
          hi = mid - 1;
      }
      dst[i * stride + t] = static_cast<uint8_t>(lo);
      d.consume(cr[lo], m.row_q(r, lo), kQTotal, tt);
    }
    for (int64_t i = 0; i < active; ++i) {
      uint8_t s = dst[i * stride + t];
      m.update(cbits ? (prev[i] >> shift) : 0, s);
      prev[i] = s;
    }
  }
  return n;
}

}  // extern "C"

// ------------------------------------------------------------------ CT-LZ4
// SLZ4 (LZ4 block format, FORMATS.md; reference lineage test/slz4.h
// 116-592) with the EXACT nearest-previous-occurrence parse of
// reference/slz4_ref.py: a latest-position map over exact 4-byte keys
// (open addressing, no information loss — unlike the reference's 16K
// single-probe dict), byte-exact LCP capped at 4096, one-step lazy rule.
// Containers are byte-identical to the oracle and the JAX backend.

namespace {

constexpr int64_t kLzMinMatch = 4;
constexpr int64_t kLzLcpCap = 4096;
constexpr int64_t kLzMaxDist = 65535;
constexpr int64_t kLzEndLiterals = 5;
constexpr int64_t kLzLastGuard = 12;

struct Lz4Dict {
  std::vector<uint32_t> keys;
  std::vector<int32_t> pos;
  uint32_t mask;
  explicit Lz4Dict(int64_t n) {
    uint64_t cap = 8;
    while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
    keys.assign(cap, 0);
    pos.assign(cap, -1);
    mask = static_cast<uint32_t>(cap - 1);
  }
  static uint32_t hash(uint32_t k) {
    k *= 0x9E3779B1u;
    k ^= k >> 16;
    return k;
  }
  void put(uint32_t key, int32_t p) {
    uint32_t h = hash(key) & mask;
    for (;;) {
      if (pos[h] < 0) {
        keys[h] = key;
        pos[h] = p;
        return;
      }
      if (keys[h] == key) {
        pos[h] = p;
        return;
      }
      h = (h + 1) & mask;
    }
  }
  int32_t get(uint32_t key) const {
    uint32_t h = hash(key) & mask;
    for (;;) {
      if (pos[h] < 0) return -1;
      if (keys[h] == key) return pos[h];
      h = (h + 1) & mask;
    }
  }
};

inline uint32_t lz_key(const uint8_t* b, int64_t p) {
  uint32_t k;
  std::memcpy(&k, b + p, 4);
  return k;
}

inline int64_t lz_lcp(const uint8_t* b, int64_t j, int64_t p, int64_t L) {
  int64_t l = 0;
  int64_t maxl = L - p;
  if (maxl > kLzLcpCap) maxl = kLzLcpCap;
  while (l + 8 <= maxl) {
    uint64_t a, c;
    std::memcpy(&a, b + j + l, 8);
    std::memcpy(&c, b + p + l, 8);
    if (a != c) {
      l += __builtin_ctzll(a ^ c) >> 3;
      return l;
    }
    l += 8;
  }
  while (l < maxl && b[j + l] == b[p + l]) ++l;
  return l;
}

struct LzParser {
  const uint8_t* b;
  int64_t L;
  Lz4Dict dict;
  int64_t next_to_index = 0;
  LzParser(const uint8_t* b_, int64_t L_) : b(b_), L(L_), dict(L_) {}
  void index_up_to(int64_t p) {
    while (next_to_index < p && next_to_index + kLzMinMatch <= L) {
      dict.put(lz_key(b, next_to_index),
               static_cast<int32_t>(next_to_index));
      ++next_to_index;
    }
  }
  // (mlen, off) of the valid match at p, or (0, 0) — reference/
  // slz4_ref.py match_at, bit for bit
  void match_at(int64_t p, int64_t* mlen, int64_t* off) {
    *mlen = 0;
    *off = 0;
    if (p > L - kLzLastGuard) return;
    index_up_to(p);
    int32_t j = dict.get(lz_key(b, p));
    if (j < 0 || p - j > kLzMaxDist) return;
    int64_t lcp = lz_lcp(b, j, p, L);
    if (lcp < kLzMinMatch) return;
    int64_t cap = L - kLzEndLiterals - p;
    *mlen = lcp < cap ? lcp : cap;
    *off = p - j;
  }
};

// emit one LZ4 token; returns bytes written or -1 on overflow
inline int64_t lz_emit(const uint8_t* seg, int64_t lit_start,
                       int64_t lit_len, int64_t mlen, int64_t off,
                       uint8_t* out, int64_t cap) {
  int64_t w = 0;
  int64_t lit_tok = lit_len < 15 ? lit_len : 15;
  int64_t m_tok = mlen ? (mlen - kLzMinMatch < 15 ? mlen - kLzMinMatch : 15)
                       : 0;
  if (w >= cap) return -1;
  out[w++] = static_cast<uint8_t>((lit_tok << 4) | m_tok);
  if (lit_len >= 15) {
    int64_t rem = lit_len - 15;
    while (rem >= 255) {
      if (w >= cap) return -1;
      out[w++] = 255;
      rem -= 255;
    }
    if (w >= cap) return -1;
    out[w++] = static_cast<uint8_t>(rem);
  }
  if (w + lit_len > cap) return -1;
  std::memcpy(out + w, seg + lit_start, lit_len);
  w += lit_len;
  if (mlen) {
    if (w + 2 > cap) return -1;
    out[w++] = static_cast<uint8_t>(off & 0xFF);
    out[w++] = static_cast<uint8_t>(off >> 8);
    if (mlen - kLzMinMatch >= 15) {
      int64_t rem = mlen - kLzMinMatch - 15;
      while (rem >= 255) {
        if (w >= cap) return -1;
        out[w++] = 255;
        rem -= 255;
      }
      if (w >= cap) return -1;
      out[w++] = static_cast<uint8_t>(rem);
    }
  }
  return w;
}

int64_t lz_compress_segment(const uint8_t* seg, int64_t L, bool lazy,
                            uint8_t* out, int64_t cap) {
  LzParser ps(seg, L);
  int64_t w = 0, i = 0, lit_start = 0;
  while (i < L) {
    int64_t mlen, off, mlen2, off2;
    ps.match_at(i, &mlen, &off);
    if (mlen && lazy) {
      ps.match_at(i + 1, &mlen2, &off2);
      if (mlen2 > mlen) mlen = 0;  // defer, re-decide at i+1
    }
    if (mlen) {
      int64_t t = lz_emit(seg, lit_start, i - lit_start, mlen, off,
                          out + w, cap - w);
      if (t < 0) return -1;
      w += t;
      i += mlen;
      lit_start = i;
    } else {
      ++i;
    }
  }
  int64_t t = lz_emit(seg, lit_start, L - lit_start, 0, 0, out + w,
                      cap - w);
  if (t < 0) return -1;
  return w + t;
}

}  // namespace

extern "C" {

int64_t ct_slz4_encode(const uint8_t* src, int64_t n, uint32_t seg_log2,
                       uint32_t lazy, uint8_t* dst, int64_t cap) {
  if (seg_log2 < 6 || seg_log2 > 24) return -1;
  int64_t s = 1ll << seg_log2;
  int64_t n_segs = n ? (n + s - 1) / s : 0;
  int64_t hdr = 9 + 4 * n_segs;
  if (hdr > cap) return -1;
  uint32_t n32 = static_cast<uint32_t>(n);
  std::memcpy(dst, &n32, 4);
  dst[4] = static_cast<uint8_t>(seg_log2);
  uint32_t ns32 = static_cast<uint32_t>(n_segs);
  std::memcpy(dst + 5, &ns32, 4);
  int64_t w = hdr;
  for (int64_t g = 0; g < n_segs; ++g) {
    int64_t L = n - g * s;
    if (L > s) L = s;
    int64_t t = lz_compress_segment(src + g * s, L, lazy != 0, dst + w,
                                    cap - w);
    if (t < 0) return -1;
    uint32_t t32 = static_cast<uint32_t>(t);
    std::memcpy(dst + 9 + 4 * g, &t32, 4);
    w += t;
  }
  return w;
}

int64_t ct_slz4_decode(const uint8_t* src, int64_t src_size, uint8_t* dst,
                       int64_t cap) {
  if (src_size < 9) return -1;
  uint32_t n32, ns32;
  std::memcpy(&n32, src, 4);
  uint32_t seg_log2 = src[4];
  std::memcpy(&ns32, src + 5, 4);
  if (seg_log2 < 6 || seg_log2 > 24) return -1;
  int64_t n = n32, n_segs = ns32, s = 1ll << seg_log2;
  if (n > cap) return -1;
  if (n_segs != (n ? (n + s - 1) / s : 0)) return -1;
  int64_t hdr = 9 + 4 * n_segs;
  if (hdr > src_size) return -1;
  int64_t r = hdr;
  int64_t out_pos = 0;
  for (int64_t g = 0; g < n_segs; ++g) {
    uint32_t bs32;
    std::memcpy(&bs32, src + 9 + 4 * g, 4);
    int64_t bend = r + bs32;
    if (bend > src_size) return -1;
    int64_t expect = n - g * s;
    if (expect > s) expect = s;
    int64_t seg_end = out_pos + expect;
    while (r < bend) {
      uint8_t token = src[r++];
      int64_t lit = token >> 4;
      if (lit == 15) {
        for (;;) {
          if (r >= bend) return -1;
          uint8_t bb = src[r++];
          lit += bb;
          if (bb != 255) break;
        }
      }
      if (r + lit > bend || out_pos + lit > seg_end) return -1;
      std::memcpy(dst + out_pos, src + r, lit);
      r += lit;
      out_pos += lit;
      if (r >= bend) break;
      if (r + 2 > bend) return -1;
      int64_t off = src[r] | (src[r + 1] << 8);
      r += 2;
      if (off == 0) return -1;
      int64_t mlen = (token & 0xF) + kLzMinMatch;
      if ((token & 0xF) == 15) {
        for (;;) {
          if (r >= bend) return -1;
          uint8_t bb = src[r++];
          mlen += bb;
          if (bb != 255) break;
        }
      }
      int64_t start = out_pos - off;
      if (start < g * s || out_pos + mlen > seg_end) return -1;
      for (int64_t t = 0; t < mlen; ++t) dst[out_pos + t] = dst[start + t];
      out_pos += mlen;
    }
    if (out_pos != seg_end) return -1;
    r = bend;
  }
  return out_pos == n ? n : -1;
}

}  // extern "C"
