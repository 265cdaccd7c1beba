// Per-block stable bucket partition with per-block counts, for Hopper (sm_90a).
//
// Replaces the TPU kernel denovo_kmer_tpu/ops/partition_pallas.py:_partition_kernel
// (radix_partition_blocks). Same contract: data (C, N) u32 with row index = column n (any
// strides), ids (N,) u32 bucket ids; out (C, N) where each block of `block_lanes` columns
// holds its rows bucket-major and, within a bucket, in their original order; counts
// (ceil(N / block_lanes), n_buckets) i32, the rows of each bucket in each block. A ragged
// last block is allowed here (the Python entry of the JAX contract rejects it as JAX does).
// Bucket ids are any values below n_buckets (not only powers of two), so the spill's entry
// can send invalid rows to a bucket of their own; an id at or above n_buckets counts as the
// last bucket.
//
// The TPU kernel sorts bit by bit with lane-roll and select cascades because Mosaic has no
// scatter. A GPU scatters, so this is a stable counting partition, one CTA of 16 warps per
// block:
//   1. the CTA reads the block's ids once (16-byte loads where aligned), keeps them in
//      shared memory narrowed to 16 bits and counts them per bucket: below 33 buckets by
//      one __ballot_sync per bucket (lane b keeps bucket b's count), above by
//      __match_any_sync groups; then `counts` and each bucket's start in the block;
//   2. the block is walked in tiles of 2048 rows. Each warp owns 128 consecutive rows of a
//      tile and loads them into registers (8 or 16 bytes a lane where the rows are
//      contiguous, as in the spill's (W, S) view of its staging rows; element loads for any
//      other strides). It ranks its rows among equal ids of its own earlier rows; the
//      per-(warp, bucket) counts give each bucket's tile start and each warp's base;
//   3. each row goes to its bucket-major slot of a shared-memory tile, beside its
//      destination in the block; the CTA then writes the tile in slot order, so
//      consecutive lanes store consecutive addresses of one bucket's run. The next tile's
//      loads are issued before this write, so they overlap it.
// Order within a bucket is the original order (tile by tile, warp by warp, lane by lane):
// the partition is stable. More than 4 columns go through the tile 4 at a time.
//
// Bound: memory. Each row's C words and its id are read once and its C words written once:
// (8 C + 4) bytes a row, 682 MB at the spill window (N = 34,078,720, C = 2), 0.20 ms at
// 3.35 TB/s. Shared memory at 32,768-row blocks, C = 2 and 5 buckets is 89 KB (64 KB of ids),
// so two CTAs share an SM and one's barriers overlap the other's memory traffic. Blocks
// whose ids do not fit the 227 KB budget read them from device memory twice instead.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                     // rows a lane holds per tile
constexpr int kTile = kThreads * kRows;      // 2048 rows a tile
constexpr int kWarpRows = 32 * kRows;        // 128 consecutive rows a warp owns in a tile
constexpr int kMaxCols = 4;                  // columns that pass through the tile at once
constexpr int kMaxBuckets = 1024;
constexpr int kSmallBuckets = 32;            // at most this many: ballot ranks
constexpr size_t kMaxSmem = 227 * 1024;
constexpr uint32_t kNone = 0xFFFFu;          // a row past the block's end
constexpr unsigned kFull = 0xFFFFFFFFu;

// 32-bit words that `rows` 16-bit ids take, rounded up to 16 bytes.
__host__ __device__ __forceinline__ size_t ids_words(long long rows) {
  return (size_t)((rows + 7) / 8) * 4;
}

__device__ __forceinline__ uint32_t bucket_of(uint32_t id, int n_buckets) {
  return id < (uint32_t)n_buckets ? id : (uint32_t)(n_buckets - 1);
}

// Exclusive scan of a[0, n) in place by warp 0: lane l takes a contiguous run of buckets,
// the runs chain by shuffles. With `copy`, the values are first written there.
__device__ void warp_exclusive_scan(int32_t* a, int n, int lane, int32_t* copy) {
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per);
  const int hi = min(n, lo + per);
  int own = 0;
  for (int b = lo; b < hi; ++b) {
    own += a[b];
    if (copy != nullptr) copy[b] = a[b];
  }
  int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  int run = incl - own;
  for (int b = lo; b < hi; ++b) {
    const int t = a[b];
    a[b] = run;
    run += t;
  }
}

// Adds this lane's bucket `b` (kNone for none) to the counts: lane bb's `cnt` for bucket bb
// (small), or shared atomics by one lane of each group of equal ids.
template <bool kSmall>
__device__ __forceinline__ void count_bucket(uint32_t b, int n_buckets, int lane,
                                             uint32_t& cnt, int32_t* hist) {
  if (kSmall) {
    for (int bb = 0; bb < n_buckets; ++bb) {
      const unsigned m = __ballot_sync(kFull, b == (uint32_t)bb);
      if (lane == bb) cnt += __popc(m);
    }
  } else {
    const unsigned peers = __match_any_sync(kFull, b);
    if (b != kNone && (peers & ((1u << lane) - 1u)) == 0) atomicAdd(&hist[b], __popc(peers));
  }
}

// Loads this lane's kRows rows of tile rows [t0, t0 + tlen), columns [c0, c0 + cols).
// kVec 2 / 4: the rows are contiguous runs of C = kVec words (stride_c 1, stride_n C).
template <int kVec>
__device__ __forceinline__ void load_rows(uint32_t (&v)[kRows][kMaxCols],
                                          const uint32_t* __restrict__ data,
                                          long long stride_c, long long stride_n, int c0,
                                          int cols, long long r0, int tlen, int q0) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + i * 32;
    if (q >= tlen) continue;
    const long long n = r0 + q;
    if constexpr (kVec == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(data) + n);
      v[i][0] = x.x;
      v[i][1] = x.y;
    } else if constexpr (kVec == 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(data) + n);
      v[i][0] = x.x;
      v[i][1] = x.y;
      v[i][2] = x.z;
      v[i][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < cols) v[i][j] = __ldg(data + (c0 + j) * stride_c + n * stride_n);
    }
  }
}

template <bool kCached, bool kSmall, int kVec>
__global__ void __launch_bounds__(kThreads, 2) radix_partition_kernel(
    const uint32_t* __restrict__ data, long long stride_c, long long stride_n, int C,
    const uint32_t* __restrict__ ids, long long N, int block_lanes, int n_buckets,
    uint32_t* __restrict__ out, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tile_cols = min(C, kMaxCols);
  const long long ids_rows = kCached ? min((long long)block_lanes, N) : 0;
  uint16_t* ids16 = reinterpret_cast<uint16_t*>(smem);     // [ids_rows] bucket of each row
  uint32_t* tile = smem + ids_words(ids_rows);             // [tile_cols][kTile] rows by slot
  int32_t* dsts = reinterpret_cast<int32_t*>(tile + tile_cols * kTile);  // [kTile] slot -> row
  int32_t* wcnt = dsts + kTile;               // [kWarps][n_buckets]: counts, then bases
  int32_t* run = wcnt + kWarps * n_buckets;   // [n_buckets]: next row of each bucket
  int32_t* delta = run + n_buckets;           // [n_buckets]: run - tile start
  int32_t* tmp = delta + n_buckets;           // [n_buckets]: tile totals, then starts

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const long long b0 = (long long)blockIdx.x * block_lanes;
  const int len = (int)min((long long)block_lanes, N - b0);

  for (int i = threadIdx.x; i < n_buckets; i += kThreads) run[i] = 0;
  if (!kSmall)
    for (int i = threadIdx.x; i < kWarps * n_buckets; i += kThreads) wcnt[i] = 0;
  __syncthreads();

  // 1. ids: one read, kept as 16 bits, counted per bucket
  uint32_t cnt = 0;
  const uint32_t* bids = ids + b0;
  const int n4 = (reinterpret_cast<uintptr_t>(bids) & 15) == 0 ? len / 4 : 0;
  for (int i = threadIdx.x; i - lane < n4; i += kThreads) {
    uint4 x = make_uint4(kNone, kNone, kNone, kNone);
    if (i < n4) {
      x = __ldg(reinterpret_cast<const uint4*>(bids) + i);
      x.x = bucket_of(x.x, n_buckets);
      x.y = bucket_of(x.y, n_buckets);
      x.z = bucket_of(x.z, n_buckets);
      x.w = bucket_of(x.w, n_buckets);
      if (kCached) {
        reinterpret_cast<uint2*>(ids16)[i] = make_uint2(x.x | (x.y << 16), x.z | (x.w << 16));
      }
    }
    count_bucket<kSmall>(x.x, n_buckets, lane, cnt, run);
    count_bucket<kSmall>(x.y, n_buckets, lane, cnt, run);
    count_bucket<kSmall>(x.z, n_buckets, lane, cnt, run);
    count_bucket<kSmall>(x.w, n_buckets, lane, cnt, run);
  }
  for (int i = 4 * n4 + threadIdx.x; i - lane < len; i += kThreads) {
    const uint32_t b = i < len ? bucket_of(__ldg(bids + i), n_buckets) : kNone;
    if (kCached && i < len) ids16[i] = (uint16_t)b;
    count_bucket<kSmall>(b, n_buckets, lane, cnt, run);
  }
  if (kSmall && lane < n_buckets) atomicAdd(&run[lane], (int)cnt);
  __syncthreads();
  if (warp == 0)
    warp_exclusive_scan(run, n_buckets, lane, counts + (long long)blockIdx.x * n_buckets);
  __syncthreads();

  // 2-3. tiles: rank, place bucket-major in shared memory, write runs
  const int n_tiles = (len + kTile - 1) / kTile;
  const int q0 = warp * kWarpRows + lane;  // this lane's first row in a tile
  uint32_t v[kRows][kMaxCols];
  load_rows<kVec>(v, data, stride_c, stride_n, 0, tile_cols, b0, min(kTile, len), q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kTile;
    const int tlen = min(kTile, len - t0);
    uint32_t bk[kRows];
    int slot[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q = q0 + i * 32;
      bk[i] = q >= tlen ? kNone
              : kCached ? (uint32_t)ids16[t0 + q]
                        : bucket_of(__ldg(bids + t0 + q), n_buckets);
    }
    if (kSmall) {
      uint32_t seen = 0;  // lane bb: rows of bucket bb among this warp's earlier rows
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        unsigned mine = 0, add = 0;
        for (int bb = 0; bb < n_buckets; ++bb) {
          const unsigned m = __ballot_sync(kFull, bk[i] == (uint32_t)bb);
          if (bk[i] == (uint32_t)bb) mine = m;
          if (lane == bb) add = __popc(m);
        }
        slot[i] = (int)__shfl_sync(kFull, seen, bk[i] & 31) + __popc(mine & lower);
        seen += add;
      }
      if (lane < n_buckets) wcnt[warp * n_buckets + lane] = (int)seen;
    } else {
      int32_t* mine = wcnt + warp * n_buckets;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned peers = __match_any_sync(kFull, bk[i]);
        slot[i] = bk[i] != kNone ? mine[bk[i]] + __popc(peers & lower) : 0;
        __syncwarp();
        if (bk[i] != kNone && (peers & lower) == 0) mine[bk[i]] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();

    // tile start of each bucket, each warp's base within it, and delta = run - start
    if (kSmall) {
      if (warp == 0) {
        int tot = 0;
        if (lane < n_buckets)
          for (int w = 0; w < kWarps; ++w) tot += wcnt[w * n_buckets + lane];
        int incl = tot;
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += x;
        }
        if (lane < n_buckets) {
          int r = incl - tot;
          delta[lane] = run[lane] - r;
          run[lane] += tot;
          for (int w = 0; w < kWarps; ++w) {
            const int c = wcnt[w * n_buckets + lane];
            wcnt[w * n_buckets + lane] = r;
            r += c;
          }
        }
      }
    } else {
      for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
        int tot = 0;
        for (int w = 0; w < kWarps; ++w) tot += wcnt[w * n_buckets + b];
        tmp[b] = tot;
      }
      __syncthreads();
      if (warp == 0) warp_exclusive_scan(tmp, n_buckets, lane, nullptr);
      __syncthreads();
      for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
        int r = tmp[b];
        delta[b] = run[b] - r;
        for (int w = 0; w < kWarps; ++w) {
          const int c = wcnt[w * n_buckets + b];
          wcnt[w * n_buckets + b] = r;
          r += c;
        }
        run[b] += r - tmp[b];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (bk[i] == kNone) continue;
      slot[i] += wcnt[warp * n_buckets + bk[i]];
      dsts[slot[i]] = delta[bk[i]] + slot[i];
    }
    for (int c0 = 0; c0 < C; c0 += kMaxCols) {
      const int cols = min(kMaxCols, C - c0);
      if (c0 > 0) load_rows<kVec>(v, data, stride_c, stride_n, c0, cols, b0 + t0, tlen, q0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (bk[i] == kNone) continue;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < cols) tile[j * kTile + slot[i]] = v[i][j];
      }
      __syncthreads();
      if (c0 + kMaxCols >= C && t + 1 < n_tiles)  // the next tile's loads overlap the writes
        load_rows<kVec>(v, data, stride_c, stride_n, 0, tile_cols, b0 + t0 + kTile,
                        min(kTile, len - t0 - kTile), q0);
      for (int p = threadIdx.x; p < tlen; p += kThreads) {
        const long long dst = b0 + dsts[p];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < cols) out[(c0 + j) * N + dst] = tile[j * kTile + p];
      }
      __syncthreads();
    }
    if (!kSmall) {  // this warp's counts start from zero in the next tile
      for (int b = lane; b < n_buckets; b += 32) wcnt[warp * n_buckets + b] = 0;
      __syncwarp();
    }
  }
}

size_t smem_bytes(int C, int n_buckets, long long ids_rows) {
  const int tile_cols = C < kMaxCols ? C : kMaxCols;
  return sizeof(uint32_t) * (ids_words(ids_rows) + (size_t)(tile_cols + 1) * kTile +
                             (size_t)(kWarps + 3) * n_buckets);
}

template <bool kCached, bool kSmall, int kVec>
cudaError_t launch(const uint32_t* data, long long stride_c, long long stride_n, int C,
                   const uint32_t* ids, long long N, int block_lanes, int n_buckets,
                   uint32_t* out, int32_t* counts, unsigned grid, size_t smem,
                   cudaStream_t stream) {
  auto kernel = radix_partition_kernel<kCached, kSmall, kVec>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kMaxSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(data, stride_c, stride_n, C, ids, N, block_lanes,
                                           n_buckets, out, counts);
  return cudaGetLastError();
}

template <bool kCached, bool kSmall>
cudaError_t launch_vec(int vec, const uint32_t* data, long long stride_c, long long stride_n,
                       int C, const uint32_t* ids, long long N, int block_lanes,
                       int n_buckets, uint32_t* out, int32_t* counts, unsigned grid,
                       size_t smem, cudaStream_t stream) {
#define DK_LAUNCH(V)                                                                       \
  launch<kCached, kSmall, V>(data, stride_c, stride_n, C, ids, N, block_lanes, n_buckets, \
                             out, counts, grid, smem, stream)
  if (vec == 2) return DK_LAUNCH(2);
  if (vec == 4) return DK_LAUNCH(4);
  return DK_LAUNCH(0);
#undef DK_LAUNCH
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
  const long long rows = block_lanes < N ? block_lanes : N;
  const bool cached = smem_bytes(C, n_buckets, rows) <= kMaxSmem;
  const size_t smem = smem_bytes(C, n_buckets, cached ? rows : 0);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const int vec = (stride_c == 1 && stride_n == C && (C == 2 || C == 4) &&
                   addr % (4 * C) == 0) ? C : 0;
  const bool small = n_buckets <= kSmallBuckets;
  auto d = static_cast<const uint32_t*>(data);
  auto i = static_cast<const uint32_t*>(ids);
  auto o = static_cast<uint32_t*>(out);
  auto c = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  cudaError_t e;
  if (cached && small)
    e = launch_vec<true, true>(vec, d, stride_c, stride_n, C, i, N, block_lanes, n_buckets,
                               o, c, g, smem, s);
  else if (cached)
    e = launch_vec<true, false>(vec, d, stride_c, stride_n, C, i, N, block_lanes, n_buckets,
                                o, c, g, smem, s);
  else if (small)
    e = launch_vec<false, true>(vec, d, stride_c, stride_n, C, i, N, block_lanes, n_buckets,
                                o, c, g, smem, s);
  else
    e = launch_vec<false, false>(vec, d, stride_c, stride_n, C, i, N, block_lanes, n_buckets,
                                 o, c, g, smem, s);
  return static_cast<int>(e);
}
