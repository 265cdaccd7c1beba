// Canonical k-mer extraction fused with the staging append, for Hopper (sm_90a).
//
// Replaces the TPU kernel denovo_kmer_tpu/ops/extract_pallas.py:_extract_kernel (and its jnp
// twin ops/extract_fast.py:extract_canonical_kmers_fast, barrier=False) together with the
// staging append of ops/stream.py:append, as the JAX ingest step fuses them
// (pipeline.py:make_ingest_step). Bit layout (ops/extract_fast.py:1-23):
//   - words: base j of a read sits in word j/16, bits 2*(j%16)..+1 (LSB-first).
//   - mw = reverse of the 16 2-bit fields of each word: read MSB-first, the concatenated
//     mw words are the base stream, so the 32W-bit window at base p is
//     win[w] = (mw[q+w] << 2s) | (mw[q+w+1] >> (32-2s)), q = p/16, s = p%16, and the
//     forward value is win >> (32W - 2k).
//   - cw = ~words: the reverse complement is the little-endian 2k-bit field at bit 2p of
//     cw, assembled the same way with the shifts mirrored, then word-reversed and the top
//     word masked.
//   - x >> (32-2s) is written (x >> 1) >> (31-2s) so that s = 0 never shifts by 32.
//   - canonical: lexicographic minimum over the W words, ties to forward.
//   - valid: all k validity bits of the window set (vwords feed), or p + k <= length (the
//     length-shipped feed; exactly what ops/extract_fast.py:vwords_from_lengths implies).
//   - pass filter (n_passes > 1): valid also requires router.pass_of(key, n_passes) ==
//     pass_id, the FNV-1a + murmur3 hash with basis 0x9E3779B9 over the stored key words,
//     computed in registers, as the JAX multipass step fuses it (pipeline.py:213-217).
//     With n_passes == 1 the hash is not computed.
//
// Design: no shared memory, no block barrier, no division by the window. A read takes a
// segment of kLanes lanes of a warp (32, or 16 for reads of at most 16 - W - 1 words, two
// reads a warp) and the warps stride over the reads, loading their next reads' words before
// they compute the current ones. Lane j of a segment holds stream word j of a chunk of the
// read (mw and cw in registers, zero past the read) and the validity word that covers it; a
// window takes the W + 1 stream words it needs, and up to 3 validity words, from their
// lanes by __shfl_sync, and builds its forward and reverse-complement words by funnel
// shifts. Reads longer than one chunk (chunk_words + W + 1 <= 32 words) go chunk by chunk.
// Lanes take consecutive windows, kLanes a step, so key rows go out as one 8- or 16-byte
// store a lane (W = 2, 4; W = 1 and 3 as words) and valid bytes as one byte a lane, both on
// consecutive addresses. The feed and the pass filter are template parameters: the window
// code carries no branch on them. 16 lanes a read pays where 32 would leave a read's last
// step mostly idle (ops/extract.py:_lanes_per_read). Packing valid bytes four to a 32-bit
// store (a ballot and a multiply) measured slower than a byte a lane: its extra
// instructions cost more than the store instructions they save. No row outside
// [row0, row0 + B*P) is written.
//
// Bound: memory. At the main-path batch (B=16384, max_read_len=160, k=31: P=130, W=2) the
// kernel writes 16384*130*(8+1) B = 19.2 MB and reads about 0.7 MB; at 3.35 TB/s that is
// about 5.9 us. On the card it takes over twice that (PERF.md, Findings): the instructions of a
// window (6 shuffles, ~8 funnel shifts and masks, the canonical compare, addresses, two
// stores) and the idle lanes of a read's last step, not its bytes, set the pace.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int W>
__device__ __forceinline__ uint32_t pass_hash(const uint32_t (&key)[W]) {
  uint32_t h = 0x9E3779B9u;
#pragma unroll
  for (int w = 0; w < W; ++w) h = (h ^ key[w]) * 0x01000193u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t reverse_2bit_fields(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

// One chunk's words for this lane: stream word wb + lane and validity word wb/2 + lane of
// read b (zero past the read), or of no read when b >= B.
struct Chunk {
  uint32_t x, v;
  int len;
};

__device__ __forceinline__ Chunk load_chunk(const uint32_t* __restrict__ words, int B, int Lw,
                                            const uint32_t* __restrict__ vwords, int Lv,
                                            const int32_t* __restrict__ lengths, int b,
                                            int wb, int lane) {
  Chunk c{0u, 0u, 0};
  if (b >= B) return c;
  const int j = wb + lane;
  if (j < Lw) c.x = __ldg(words + (size_t)b * Lw + j);
  if (vwords != nullptr) {
    const int jv = wb / 2 + lane;
    if (jv < Lv) c.v = __ldg(vwords + (size_t)b * Lv + jv);
  } else {
    c.len = __ldg(lengths + b);
  }
  return c;
}

template <int W>
__device__ __forceinline__ void store_key(uint32_t* __restrict__ out_kmers, long long row,
                                          const uint32_t (&key)[W]) {
  if constexpr (W == 2) {
    reinterpret_cast<uint2*>(out_kmers)[row] = make_uint2(key[0], key[1]);
  } else if constexpr (W == 4) {
    reinterpret_cast<uint4*>(out_kmers)[row] = make_uint4(key[0], key[1], key[2], key[3]);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out_kmers[row * W + w] = key[w];
  }
}

// What every window of a launch shares.
struct Geometry {
  int k, P, R;             // R: right shift aligning the 32W-bit window to 2k bits
  uint32_t top_mask;       // bits of the top key word
  uint32_t vmask[2];       // validity bits a window needs in its first and second word
  int canonical, n_passes, pass_id;
};

__device__ __forceinline__ Geometry make_geometry(int W, int k, int P, int canonical,
                                                  int n_passes, int pass_id) {
  Geometry g;
  g.k = k;
  g.P = P;
  g.R = 32 * W - 2 * k;
  const int u = 2 * k - 32 * (W - 1);
  g.top_mask = u < 32 ? ((1u << u) - 1u) : 0xFFFFFFFFu;
  g.vmask[0] = k < 32 ? (1u << k) - 1u : 0xFFFFFFFFu;
  g.vmask[1] = k > 32 ? (1u << (k - 32)) - 1u : 0u;
  g.canonical = canonical;
  g.n_passes = n_passes;
  g.pass_id = pass_id;
  return g;
}

// a <= b, lexicographically over W big-endian words, compared 64 bits at a time.
template <int W>
__device__ __forceinline__ bool not_above(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
  auto pair = [](uint32_t hi, uint32_t lo) { return ((uint64_t)hi << 32) | lo; };
  if constexpr (W == 1) {
    return a[0] <= b[0];
  } else if constexpr (W == 2) {
    return pair(a[0], a[1]) <= pair(b[0], b[1]);
  } else if constexpr (W == 3) {
    const uint64_t x = pair(a[0], a[1]), y = pair(b[0], b[1]);
    return x < y || (x == y && a[2] <= b[2]);
  } else {
    const uint64_t x = pair(a[0], a[1]), y = pair(b[0], b[1]);
    return x < y || (x == y && pair(a[2], a[3]) <= pair(b[2], b[3]));
  }
}

// The key of the window whose first stream word sits in lane `src`, at bit phase `sh`:
// mw / cw words src .. src + W by shuffles, then funnel shifts ((hi:lo << sh) >> 32 and
// (hi:lo >> sh) & ~0u, one instruction each) and the canonical choice.
template <int W>
__device__ __forceinline__ void window_key(const Geometry& g, uint32_t mw, uint32_t cw,
                                           int src, int sh, uint32_t (&key)[W]) {
  uint32_t m[W + 1], c[W + 1];
#pragma unroll
  for (int w = 0; w <= W; ++w) {
    m[w] = __shfl_sync(kFull, mw, src + w);
    c[w] = __shfl_sync(kFull, cw, src + w);
  }
  uint32_t win[W], fwd[W], rc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    win[w] = __funnelshift_l(m[w + 1], m[w], sh);
    rc[W - 1 - w] = __funnelshift_r(c[w], c[w + 1], sh);
  }
  rc[0] &= g.top_mask;
  fwd[0] = win[0] >> g.R;
#pragma unroll
  for (int w = 1; w < W; ++w) fwd[w] = __funnelshift_r(win[w], win[w - 1], g.R);
  const bool use_fwd = !g.canonical || not_above<W>(fwd, rc);
#pragma unroll
  for (int w = 0; w < W; ++w) key[w] = use_fwd ? fwd[w] : rc[w];
}

// All k validity bits of the window at stream position p set: validity word p/32 of the
// read sits in lane `src`, LSB-first, at phase p%32.
__device__ __forceinline__ bool window_valid(const Geometry& g, uint32_t vw, int src, int p) {
  const int vs = p & 31;
  const uint32_t v0 = __shfl_sync(kFull, vw, src);
  const uint32_t v1 = __shfl_sync(kFull, vw, src + 1);
  bool ok = (__funnelshift_r(v0, v1, vs) & g.vmask[0]) == g.vmask[0];
  if (g.k > 32) {
    const uint32_t v2 = __shfl_sync(kFull, vw, src + 2);
    ok = ok && (__funnelshift_r(v1, v2, vs) & g.vmask[1]) == g.vmask[1];
  }
  return ok;
}

template <int W, bool kFilter>
__device__ __forceinline__ void store_row(const Geometry& g, uint32_t* __restrict__ out_kmers,
                                          uint8_t* __restrict__ out_valid, long long row,
                                          const uint32_t (&key)[W], bool ok) {
  if constexpr (kFilter)
    ok = ok && pass_hash<W>(key) % (uint32_t)g.n_passes == (uint32_t)g.pass_id;
  store_key<W>(out_kmers, row, key);
  out_valid[row] = ok ? 1 : 0;
}

// A read a kLanes-lane segment of a warp (32: any width, chunk_words stream words at a time;
// 16: reads of at most 16 - W - 1 words, two reads a warp, one chunk each), kLanes windows a
// step, the warps striding over the reads.
template <int W, int kLanes, bool kVwords, bool kFilter>
__global__ void __launch_bounds__(kThreads) extract_kmers_kernel(
    const uint32_t* __restrict__ words, int B, int Lw,
    const uint32_t* __restrict__ vwords, int Lv,
    const int32_t* __restrict__ lengths,
    int k, int P, int canonical, int n_passes, int pass_id, int chunk_words,
    uint32_t* __restrict__ out_kmers, uint8_t* __restrict__ out_valid,
    long long row0) {
  constexpr int kReads = 32 / kLanes;      // reads a warp takes at once
  const int lane = threadIdx.x & 31;
  const int j = lane & (kLanes - 1);       // lane within the read's segment
  const int seg = lane - j;                // the segment's first lane
  const int stride = ((gridDim.x * kThreads) >> 5) * kReads;
  const int step_words = kLanes == 32 ? chunk_words : 1 << 24;
  const Geometry g = make_geometry(W, k, P, canonical, n_passes, pass_id);
  int b = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * kReads + lane / kLanes;
  Chunk next = load_chunk(words, B, Lw, vwords, Lv, lengths, b, 0, j);
  for (; b - lane / kLanes < B; b += stride) {
    Chunk cur = next;
    next = load_chunk(words, B, Lw, vwords, Lv, lengths, b + stride, 0, j);
    for (int wb = 0; wb * 16 < P; wb += step_words) {
      if (wb > 0) cur = load_chunk(words, B, Lw, vwords, Lv, lengths, b, wb, j);
      const uint32_t mw = reverse_2bit_fields(cur.x);  // zero words stay zero
      const uint32_t cw = wb + j < Lw ? ~cur.x : 0u;
      const int p_end = min(P, (wb + step_words) * 16);
      for (int p0 = wb * 16; p0 < p_end; p0 += kLanes) {
        const int p = p0 + j;
        uint32_t key[W];
        window_key<W>(g, mw, cw, seg + (p >> 4) - wb, 2 * (p & 15), key);
        bool ok;
        if constexpr (kVwords) {
          ok = window_valid(g, cur.v, seg + (p >> 5) - wb / 2, p);
        } else {
          ok = p + k <= cur.len;
        }
        if (p < p_end && b < B)
          store_row<W, kFilter>(g, out_kmers, out_valid, row0 + (long long)b * P + p, key, ok);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Blocks to launch: as many as the card keeps resident, at most what the reads need. The
// resident count is queried once per device for each kernel instance and kept in that
// instance's `cache`, so a launch pays no occupancy query.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int device, long long warps_needed,
                            int (&cache)[kMaxDevices], unsigned* blocks) {
  int resident = device >= 0 && device < kMaxDevices ? cache[device] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (device >= 0 && device < kMaxDevices) cache[device] = resident;
  }
  const long long need = (warps_needed * 32 + kThreads - 1) / kThreads;
  *blocks = (unsigned)(need < resident ? need : resident);
  return cudaSuccess;
}

template <int W, bool kVwords, bool kFilter>
cudaError_t launch_kernel(const void* words, int B, int Lw, const void* vwords, int Lv,
                          const void* lengths, int k, int P, int canonical, int n_passes,
                          int pass_id, int chunk_words, int lanes, void* out_kmers,
                          void* out_valid, long long row0, int device, cudaStream_t stream) {
  auto w = static_cast<const uint32_t*>(words);
  auto vw = static_cast<const uint32_t*>(vwords);
  auto len = static_cast<const int32_t*>(lengths);
  auto ok = static_cast<uint32_t*>(out_kmers);
  auto ov = static_cast<uint8_t*>(out_valid);
  static int resident16[kMaxDevices], resident32[kMaxDevices];  // this instance's counts
  unsigned blocks = 0;
  if (lanes == 16) {
    auto kernel = extract_kmers_kernel<W, 16, kVwords, kFilter>;
    const cudaError_t e = resident_blocks(kernel, device, (B + 1) / 2, resident16, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kThreads, 0, stream>>>(w, B, Lw, vw, Lv, len, k, P, canonical, n_passes,
                                            pass_id, chunk_words, ok, ov, row0);
  } else {
    auto kernel = extract_kmers_kernel<W, 32, kVwords, kFilter>;
    const cudaError_t e = resident_blocks(kernel, device, B, resident32, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kThreads, 0, stream>>>(w, B, Lw, vw, Lv, len, k, P, canonical, n_passes,
                                            pass_id, chunk_words, ok, ov, row0);
  }
  return cudaGetLastError();
}

// The feed (validity words or lengths) and the pass filter are template parameters, so
// the per-window code carries no branch on them.
template <int W>
cudaError_t launch(const void* words, int B, int Lw, const void* vwords, int Lv,
                   const void* lengths, int k, int P, int canonical, int n_passes,
                   int pass_id, int chunk_words, int lanes, void* out_kmers,
                   void* out_valid, long long row0, int device, cudaStream_t stream) {
#define DK_KERNEL(V, F)                                                                    \
  launch_kernel<W, V, F>(words, B, Lw, vwords, Lv, lengths, k, P, canonical, n_passes,    \
                         pass_id, chunk_words, lanes, out_kmers, out_valid, row0, device,  \
                         stream)
  if (vwords != nullptr) return n_passes > 1 ? DK_KERNEL(true, true) : DK_KERNEL(true, false);
  return n_passes > 1 ? DK_KERNEL(false, true) : DK_KERNEL(false, false);
#undef DK_KERNEL
}

}  // namespace

// words (B, Lw) u32, vwords (B, Lv) u32 or null, lengths (B,) i32 (read when vwords is
// null); writes rows [row0, row0 + B*P) of out_kmers (rows of W u32, 16-byte aligned) and
// out_valid (u8), on `device`, in the order of `stream`. n_passes > 1 keeps only windows of
// pass pass_id. A read takes `lanes` lanes of a warp: 32, chunk_words stream words at a time
// (chunk_words even, chunk_words + W + 1 <= 32: ops/extract.py:_chunk_words), or 16 when
// Lw + W + 1 <= 16 (ops/extract.py:_lanes_per_read chooses).
extern "C" int dk_extract_kmers_append(
    const void* words, int B, int Lw, const void* vwords, int Lv, const void* lengths,
    int k, int P, int canonical, int n_passes, int pass_id, int chunk_words, int lanes,
    void* out_kmers, void* out_valid, long long row0, int device, void* stream) {
  if (B <= 0 || P <= 0 || k < 1 || k > 63) return cudaErrorInvalidValue;
  if (n_passes < 1 || pass_id < 0 || pass_id >= n_passes) return cudaErrorInvalidValue;
  const int W = (2 * k + 31) / 32;
  if (chunk_words < 2 || chunk_words % 2 != 0 || chunk_words + W + 1 > 32)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out_kmers) % 16 != 0) return cudaErrorInvalidValue;
  if (lanes != 32 && (lanes != 16 || Lw + W + 1 > 16)) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DK_LAUNCH(W)                                                                  \
  launch<W>(words, B, Lw, vwords, Lv, lengths, k, P, canonical, n_passes, pass_id,    \
            chunk_words, lanes, out_kmers, out_valid, row0, device, s)
  cudaError_t e;
  switch (W) {
    case 1: e = DK_LAUNCH(1); break;
    case 2: e = DK_LAUNCH(2); break;
    case 3: e = DK_LAUNCH(3); break;
    default: e = DK_LAUNCH(4); break;
  }
#undef DK_LAUNCH
  return static_cast<int>(e);
}
