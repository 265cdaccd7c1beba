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
// Design: one block stages a tile of reads (their mw/cw words, and validity words) in
// shared memory; one thread computes one (read, position) window and writes its W words
// and its valid byte straight into the staging buffer at row row0 + b*P + p. There is no
// intermediate (B, P, W) tensor.
//
// Bound: memory. At the main-path batch (B=16384, max_read_len=160, k=31: P=130, W=2) the
// kernel writes 16384*130*(8+1) B = 19.2 MB and reads about 0.7 MB; at 3.35 TB/s that is
// about 5.9 us. The integer work (~60 ALU ops per window, 2.1M windows) is a fraction of
// that at the card's ALU rate. Consecutive threads write consecutive rows, so the stores
// coalesce; reads come from shared memory.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

template <int W>
__global__ void extract_kmers_append_kernel(
    const uint32_t* __restrict__ words, int B, int Lw,
    const uint32_t* __restrict__ vwords, int Lv,
    const int32_t* __restrict__ lengths,
    int k, int P, int canonical, int n_passes, int pass_id, int tile_reads,
    uint32_t* __restrict__ out_kmers, uint8_t* __restrict__ out_valid,
    long long row0) {
  extern __shared__ uint32_t smem[];
  const int Lm = Lw + W + 1;  // stream words per read, zero padded
  const int Lvp = Lv + 2;     // validity words per read, zero padded
  uint32_t* mw = smem;
  uint32_t* cw = mw + tile_reads * Lm;
  uint32_t* vw = cw + tile_reads * Lm;

  const int b0 = blockIdx.x * tile_reads;
  const int nb = min(tile_reads, B - b0);

  for (int i = threadIdx.x; i < nb * Lm; i += blockDim.x) {
    const int r = i / Lm, j = i - r * Lm;
    const bool in = j < Lw;
    const uint32_t x = in ? words[(size_t)(b0 + r) * Lw + j] : 0u;
    mw[i] = in ? reverse_2bit_fields(x) : 0u;
    cw[i] = in ? ~x : 0u;
  }
  if (vwords != nullptr) {
    for (int i = threadIdx.x; i < nb * Lvp; i += blockDim.x) {
      const int r = i / Lvp, j = i - r * Lvp;
      vw[i] = j < Lv ? vwords[(size_t)(b0 + r) * Lv + j] : 0u;
    }
  }
  __syncthreads();

  const int R = 32 * W - 2 * k;             // right shift aligning the window to 2k bits
  const int u = 2 * k - 32 * (W - 1);       // bits used in the top word
  const uint32_t top_mask = u < 32 ? ((1u << u) - 1u) : 0xFFFFFFFFu;

  for (int t = threadIdx.x; t < nb * P; t += blockDim.x) {
    const int r = t / P, p = t - r * P;
    const int sh = 2 * (p & 15);
    const uint32_t* m = mw + r * Lm + (p >> 4);
    const uint32_t* c = cw + r * Lm + (p >> 4);

    uint32_t win[W], fwd[W], rc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      win[w] = (m[w] << sh) | ((m[w + 1] >> 1) >> (31 - sh));
      uint32_t le = (c[w] >> sh) | ((c[w + 1] << 1) << (31 - sh));
      if (w == W - 1) le &= top_mask;
      rc[W - 1 - w] = le;
    }
    if (R == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) fwd[w] = win[w];
    } else {
      fwd[0] = win[0] >> R;
#pragma unroll
      for (int w = 1; w < W; ++w) fwd[w] = (win[w] >> R) | (win[w - 1] << (32 - R));
    }

    bool use_fwd = true;
    if (canonical) {
      bool lt = false, eq = true;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        lt = lt || (eq && fwd[w] < rc[w]);
        eq = eq && fwd[w] == rc[w];
      }
      use_fwd = lt || eq;
    }

    bool ok;
    if (vwords == nullptr) {
      ok = p + k <= lengths[b0 + r];
    } else {
      // the k validity bits at p: LSB-first stream, word p/32, phase p%32
      const uint32_t* v = vw + r * Lvp + (p >> 5);
      const int vs = p & 31;
      ok = true;
      int rem = k;
      for (int w = 0; rem > 0; ++w) {
        const uint32_t bits = (v[w] >> vs) | ((v[w + 1] << 1) << (31 - vs));
        const int take = rem < 32 ? rem : 32;
        const uint32_t mask = take == 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
        ok = ok && ((bits & mask) == mask);
        rem -= take;
      }
    }

    uint32_t key[W];
#pragma unroll
    for (int w = 0; w < W; ++w) key[w] = use_fwd ? fwd[w] : rc[w];
    if (n_passes > 1) ok = ok && pass_hash<W>(key) % (uint32_t)n_passes == (uint32_t)pass_id;

    const long long row = row0 + (long long)(b0 + r) * P + p;
#pragma unroll
    for (int w = 0; w < W; ++w) out_kmers[row * W + w] = key[w];
    out_valid[row] = ok ? 1 : 0;
  }
}

template <int W>
void launch(const void* words, int B, int Lw, const void* vwords, int Lv,
            const void* lengths, int k, int P, int canonical, int n_passes, int pass_id,
            int tile_reads, void* out_kmers, void* out_valid, long long row0, size_t smem,
            cudaStream_t stream) {
  const int blocks = (B + tile_reads - 1) / tile_reads;
  extract_kmers_append_kernel<W><<<blocks, 256, smem, stream>>>(
      static_cast<const uint32_t*>(words), B, Lw,
      static_cast<const uint32_t*>(vwords), Lv,
      static_cast<const int32_t*>(lengths), k, P, canonical, n_passes, pass_id, tile_reads,
      static_cast<uint32_t*>(out_kmers), static_cast<uint8_t*>(out_valid), row0);
}

// Shared memory bytes one block needs for a tile of `tile_reads` reads (the wrapper in
// ops/extract.py sizes the tile by the same formula).
long long smem_bytes(int tile_reads, int Lw, int Lv, int k, bool with_vwords) {
  const int W = (2 * k + 31) / 32;
  const long long per_read = 2LL * (Lw + W + 1) + (with_vwords ? (Lv + 2) : 0);
  return per_read * tile_reads * 4;
}

}  // namespace

// words (B, Lw) u32, vwords (B, Lv) u32 or null, lengths (B,) i32 (read when vwords is
// null); writes rows [row0, row0 + B*P) of out_kmers (rows of W u32) and out_valid (u8),
// on `device`, in the order of `stream`. n_passes > 1 keeps only windows of pass pass_id.
extern "C" int dk_extract_kmers_append(
    const void* words, int B, int Lw, const void* vwords, int Lv, const void* lengths,
    int k, int P, int canonical, int n_passes, int pass_id, int tile_reads,
    void* out_kmers, void* out_valid, long long row0, int device, void* stream) {
  if (B <= 0 || P <= 0 || tile_reads <= 0 || k < 1 || k > 63) return cudaErrorInvalidValue;
  if (n_passes < 1 || pass_id < 0 || pass_id >= n_passes) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(tile_reads, Lw, Lv, k, vwords != nullptr);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DK_LAUNCH(W)                                                                  \
  launch<W>(words, B, Lw, vwords, Lv, lengths, k, P, canonical, n_passes, pass_id,    \
            tile_reads, out_kmers, out_valid, row0, smem, s)
  switch ((2 * k + 31) / 32) {
    case 1: DK_LAUNCH(1); break;
    case 2: DK_LAUNCH(2); break;
    case 3: DK_LAUNCH(3); break;
    default: DK_LAUNCH(4); break;
  }
#undef DK_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
