// Per-block bitonic sort of every column by u32 key, with a u32 payload, for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/micro_pallas_sort.py:_kernel (pallas_block_sort, and the
// inline pallas_call of its main), whose network is _bitonic_sort_block. Contract: keys and
// pays (N, L) u32, row-major; every (R, L) block of R consecutive rows (R a power of two,
// N a multiple of R) has each of its L columns sorted ascending by unsigned key, each payload
// moving with its key. The network is the TPU kernel's, stage for stage:
//   for size = 2, 4, ..., R:  for s = size/2, ..., 1:
//     every row i with (i & s) == 0 pairs with i + s; the pair is in a descending run when
//     (i / size) & 1; it swaps when (key[i] > key[i + s]) XOR descending (strict compare).
// Equal keys in a descending run do swap, so the order of payloads under equal keys is the
// network's own; running the same network gives the TPU kernel's output bit for bit.
//
// Design: a (R, L) block is R * L * 8 bytes (2 MB at R = 2048, L = 128), more than a CTA's
// shared memory, and columns are independent, so one CTA takes one block and `lanes` of its
// columns (the wrapper picks lanes so that R * lanes * 8 <= 128 KiB: 8 at R = 2048, which is
// one 32-byte sector of each row). The CTA loads its tile into shared memory as [row][lane]
// (consecutive threads on consecutive words), runs the log2(R) * (log2(R) + 1) / 2 stages
// (66 at R = 2048) with a __syncthreads between stages, each thread taking compare-exchange
// pairs in turn, and writes the tile back. Keys compare as uint32_t.
//
// Bound: memory. Each element's key and payload are read once and written once: 16 bytes an
// element, 8.59 GB at the probe's shape (2^22 x 128), 2.56 ms at 3.35 TB/s. The compare-
// exchanges (2^28 pairs a stage x 66 stages at that shape) are far under the card's integer
// rate, but every stage re-reads its tile from shared memory: about 16 bytes of shared-memory
// traffic per pair and stage, ~280 GB at the probe's shape, and a barrier per stage with one
// CTA on each SM. Keeping the strides below 32 in registers and warp shuffles would cut both;
// this kernel does not.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr size_t kMaxSmem = 128 * 1024;

__global__ void __launch_bounds__(kThreads) block_sort_kernel(
    const uint32_t* __restrict__ keys, const uint32_t* __restrict__ pays,
    uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_pays, int L, int R,
    int lanes) {
  extern __shared__ uint32_t smem[];
  const long long row0 = (long long)blockIdx.x * R;
  const int lane0 = blockIdx.y * lanes;
  const int nl = min(lanes, L - lane0);  // columns of this tile
  uint32_t* sk = smem;                    // [R][nl] keys
  uint32_t* sp = smem + (size_t)R * nl;   // [R][nl] payloads
  const int n = R * nl;

  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int r = t / nl;
    const long long g = (row0 + r) * L + lane0 + (t - r * nl);
    sk[t] = keys[g];
    sp[t] = pays[g];
  }
  __syncthreads();

  const int pairs = n >> 1;
  for (int size = 2; size <= R; size <<= 1) {
    for (int s = size >> 1; s >= 1; s >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += kThreads) {
        const int q = t / nl;                              // pair index within the column
        const int c = t - q * nl;
        const int lo = ((q & ~(s - 1)) << 1) | (q & (s - 1));  // row with (row & s) == 0
        const int a = lo * nl + c;
        const int b = a + s * nl;
        const uint32_t ka = sk[a];
        const uint32_t kb = sk[b];
        const bool desc = (lo & size) != 0;
        if ((ka > kb) != desc) {
          sk[a] = kb;
          sk[b] = ka;
          const uint32_t pa = sp[a];
          sp[a] = sp[b];
          sp[b] = pa;
        }
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int r = t / nl;
    const long long g = (row0 + r) * L + lane0 + (t - r * nl);
    out_keys[g] = sk[t];
    out_pays[g] = sp[t];
  }
}

}  // namespace

// keys, pays (N, L) u32 row-major; writes out_keys, out_pays (N, L) u32 with every column of
// every block of `block_rows` rows sorted by key. One CTA takes one block and `lanes` columns;
// 2 * block_rows * lanes * 4 bytes of shared memory (at most 128 KiB). On `device`, in the
// order of `stream`.
extern "C" int dk_block_sort(const void* keys, const void* pays, void* out_keys,
                             void* out_pays, long long N, int L, int block_rows, int lanes,
                             int device, void* stream) {
  if (N <= 0 || L < 1 || block_rows < 2 || (block_rows & (block_rows - 1)) != 0 ||
      N % block_rows != 0 || lanes < 1 || lanes > L)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)block_rows * lanes * 8;
  const long long grid_x = N / block_rows;
  const long long grid_y = (L + lanes - 1) / lanes;
  if (smem > kMaxSmem || grid_x > 0x7FFFFFFFLL || grid_y > 65535) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  block_sort_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(pays),
      static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_pays), L, block_rows,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
