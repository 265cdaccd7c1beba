// Per-block stable bucket partition with per-block counts, for Hopper (sm_90a).
//
// Replaces the TPU kernel denovo_kmer_tpu/ops/partition_pallas.py:_partition_kernel
// (radix_partition_blocks). Same contract: data (C, N) u32 with row index = column n (any
// strides), ids (N,) u32 bucket ids; out (C, N) where each block of `block_lanes` columns
// holds its rows bucket-major and, within a bucket, in their original order; counts
// (ceil(N / block_lanes), n_buckets) i32, the rows of each bucket in each block. A ragged
// last block is allowed here (the Python entry of the JAX contract rejects it as JAX does).
//
// The TPU kernel sorts bit by bit with lane-roll and select cascades because Mosaic has no
// scatter. A GPU scatters, so this is a plain stable counting partition, one CTA per block:
//   1. the block is cut into kWarps contiguous chunks, one a warp; each warp counts its
//      chunk's ids into its own shared-memory histogram row (no atomics: __match_any_sync
//      groups equal ids in a warp, and one lane of each group adds the group's size);
//   2. totals per bucket are written to `counts`, an exclusive scan over buckets gives each
//      bucket's start in the block, and each (warp, bucket) base is that start plus the
//      rows of the bucket in earlier warps' chunks;
//   3. each warp walks its chunk in order, 32 rows at a time: a row's slot is its warp's
//      running base for its bucket plus its rank among equal ids of lower lanes; the
//      group's first lane then advances the base. Order within a bucket is thus the
//      original order: the partition is stable.
// Bucket ids are any values below n_buckets (not only powers of two), so the spill's entry
// can send invalid rows to a bucket of their own. Shared memory is (kWarps + 1) * n_buckets
// int32, which bounds n_buckets by kMaxBuckets (36 KiB at 1024 buckets, within the 48 KiB a
// block takes without opting in). An id at or above n_buckets is clamped into the last
// bucket so that the kernel never writes outside its tiles.
//
// Bound: memory. The kernel reads each row's C words and its id and writes the C words:
// (8 C + 4) bytes a row, which at the spill window (N = 34,078,720, C = 2) is 682 MB, about
// 0.20 ms at 3.35 TB/s. The ids are read twice (once per pass); the second read mostly hits
// L2. Reads of consecutive rows by consecutive lanes coalesce; the scatter's writes form one
// run per bucket per 32 rows.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBuckets = 1024;

__device__ __forceinline__ uint32_t bucket_of(uint32_t id, int n_buckets) {
  return id < (uint32_t)n_buckets ? id : (uint32_t)(n_buckets - 1);
}

__global__ void __launch_bounds__(kThreads) radix_partition_kernel(
    const uint32_t* __restrict__ data, long long stride_c, long long stride_n, int C,
    const uint32_t* __restrict__ ids, long long N, int block_lanes, int n_buckets,
    uint32_t* __restrict__ out, int32_t* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;                        // [kWarps][n_buckets]: counts, then bases
  int32_t* start = smem + kWarps * n_buckets;  // [n_buckets]: totals, then bucket starts
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;    // lanes below this one
  const long long b0 = (long long)blockIdx.x * block_lanes;
  const int len = (int)min((long long)block_lanes, N - b0);
  const int chunk = (len + kWarps - 1) / kWarps;
  const int w0 = min(len, warp * chunk);
  const int w1 = min(len, w0 + chunk);
  int32_t* mine = hist + warp * n_buckets;

  for (int i = threadIdx.x; i < kWarps * n_buckets; i += kThreads) hist[i] = 0;
  __syncthreads();

  // 1. per-warp histogram of the warp's chunk
  for (int i = w0; i < w1; i += 32) {
    const int r = i + lane;
    const bool active = r < w1;
    const uint32_t id = active ? bucket_of(ids[b0 + r], n_buckets) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    if (active && (peers & lower) == 0) mine[id] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. bucket totals (the block's counts), their exclusive scan, the per-warp bases
  for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += hist[w * n_buckets + b];
    start[b] = t;
    counts[(long long)blockIdx.x * n_buckets + b] = t;
  }
  __syncthreads();
  if (warp == 0) {  // lane l scans a contiguous run of buckets; the runs chain by shuffles
    const int per = (n_buckets + 31) / 32;
    const int lo = min(n_buckets, lane * per);
    const int hi = min(n_buckets, lo + per);
    int own = 0;
    for (int b = lo; b < hi; ++b) own += start[b];
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - own;
    for (int b = lo; b < hi; ++b) {
      const int t = start[b];
      start[b] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
    int run = start[b];
    for (int w = 0; w < kWarps; ++w) {
      const int t = hist[w * n_buckets + b];
      hist[w * n_buckets + b] = run;
      run += t;
    }
  }
  __syncthreads();

  // 3. stable scatter: each warp walks its chunk in order
  for (int i = w0; i < w1; i += 32) {
    const int r = i + lane;
    const bool active = r < w1;
    const uint32_t id = active ? bucket_of(ids[b0 + r], n_buckets) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    const int slot = active ? mine[id] + __popc(peers & lower) : 0;
    __syncwarp();
    if (active && (peers & lower) == 0) mine[id] += __popc(peers);
    __syncwarp();
    if (active) {
      const long long src = b0 + r;
      const long long dst = b0 + slot;
      for (int c = 0; c < C; ++c) out[c * N + dst] = data[c * stride_c + src * stride_n];
    }
  }
}

}  // namespace

// data: C rows of N u32 at data[c * stride_c + n * stride_n]; ids (N,) u32; writes
// out (C, N) u32 contiguous and counts (ceil(N / block_lanes), n_buckets) i32, on
// `device`, in the order of `stream`.
extern "C" int dk_radix_partition(
    const void* data, long long stride_c, long long stride_n, int C, const void* ids,
    long long N, int block_lanes, int n_buckets, void* out, void* counts, int device,
    void* stream) {
  if (N <= 0 || C < 1 || block_lanes < 1 || n_buckets < 1 || n_buckets > kMaxBuckets)
    return cudaErrorInvalidValue;
  const long long grid = (N + block_lanes - 1) / block_lanes;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = sizeof(int32_t) * (size_t)(kWarps + 1) * n_buckets;
  radix_partition_kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), stride_c, stride_n, C,
      static_cast<const uint32_t*>(ids), N, block_lanes, n_buckets,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
