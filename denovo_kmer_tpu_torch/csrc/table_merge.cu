// Merge of two sorted, unique key sets into a table, weights added, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package folds each staged window into its table by
// sorting the table's rows together with the window's (ops/table.py:_aggregate_multi), and
// the port did the same until the table steps took 96% of the card's busy time. A table is
// sorted and unique by invariant, so a step needs to sort only what is new; this kernel then
// folds the two sorted sets together in one linear pass. It serves `flush`, `flush_score`
// (the table and the staged window reduced to unique keys) and `seed_score_table` (the two
// parents' tables).
//
// Contract: A is `a_keys` (a_cap, W) u32 rows, of which the first *a_n (clamped to
// [0, a_cap]) are valid, sorted strictly ascending in unsigned lexicographic word order; the
// same for B. Each side has n_cols (1 or 2) u32 weight columns, a null column reading 0.
// The output is the first out_cap rows of the union in key order: a key present in both
// sides takes the sum of its weights, wrapped to 32 bits; rows past the union are all-ones
// keys with zero weights. *out_n is the union's size, even above out_cap, less one where
// the union's last row is the all-ones key with every weight 0 (the padding key, which a
// table never holds as a row of weight 0). scratch[2 * tiles + 2] is set to the valid rows
// read, *a_n + *b_n clamped.
//
// Design: merge path. The union in merge order (on equal keys A first) is cut into tiles of
// kTile = 1024 positions; a first kernel finds, for each tile boundary, the split of A and
// B by a binary search along its diagonal, one thread a boundary. A key present in both
// sides occurs at most once in each, so in merge order the B row follows the A row at once:
// the A row takes the B row's weights and the B row is dropped. An output row's index is its
// merge position less the drops before it. A count kernel counts each tile's drops, one CTA
// scans the counts, and the write kernel merges each tile again: it loads the tile's A and
// B rows (one row more on each side, for the drops across its edges) into shared memory,
// each of its 128 threads finds its own 8 positions by a search in shared memory and merges
// them into registers, a CTA scan places the kept rows, and the CTA writes them to a
// shared-memory tile and from there to the output in order, so consecutive threads store
// consecutive words. The same kernel writes the padding rows of its tile's output range.
//
// Bound: memory. The valid input rows are read once and the valid output rows written once
// (12 B a KmerTable row at W = 2), the bytes the benchmark's flush_roofline reckons; the
// kernel also reads the input keys a second time (the count pass) and writes the padding.
// The searches are latency, one global search a tile boundary and one in shared memory a
// thread; the kernels launch on the caller's stream, do not synchronise and allocate
// nothing. The C entry point returns cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                 // merge positions a thread
constexpr int kTile = kThreads * kItems;  // merge positions a tile
constexpr int kMaxCols = 2;
constexpr int kSearchThreads = 256;
constexpr int kScanThreads = 1024;
constexpr uint32_t kOnes = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Side {
  const uint32_t* keys;             // (cap, W) rows
  const uint32_t* cols[kMaxCols];   // (cap,) weights; nullptr reads 0
  const long long* n;               // valid rows, on the device
  long long cap;
};

struct Out {
  uint32_t* keys;                   // (cap, W) rows
  uint32_t* cols[kMaxCols];
  long long* n;
  long long cap;
};

__device__ __forceinline__ long long rows_of(const Side& s) {
  const long long v = *s.n;
  return v < 0 ? 0 : (v > s.cap ? s.cap : v);
}

// a <= b and a == b in unsigned lexicographic word order
template <int W>
__device__ __forceinline__ bool key_le(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (a[w] != b[w]) return a[w] < b[w];
  return true;
}

template <int W>
__device__ __forceinline__ bool key_eq(const uint32_t* a, const uint32_t* b) {
  bool eq = true;
#pragma unroll
  for (int w = 0; w < W; ++w) eq &= a[w] == b[w];
  return eq;
}

// The number of A rows among the first d rows of the merge (A first on equal keys).
template <int W>
__device__ long long merge_path(const uint32_t* a, long long na, const uint32_t* b,
                                long long nb, long long d) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_le<W>(a + mid * W, b + (d - 1 - mid) * W))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(kSearchThreads)
partition_kernel(Side a, Side b, long long* split, long long tiles) {
  const long long t = blockIdx.x * (long long)kSearchThreads + threadIdx.x;
  if (t > tiles) return;
  const long long na = rows_of(a), nb = rows_of(b);
  const long long d = t * kTile < na + nb ? t * kTile : na + nb;
  split[t] = merge_path<W>(a.keys, na, b.keys, nb, d);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

template <int W, int NC, bool kWrite>
__global__ void __launch_bounds__(kThreads)
tile_kernel(Side a, Side b, const long long* split, long long* drops, long long tiles,
            const long long* n_merged, Out out) {
  // staged rows: A[ia, i1) then B[j0, jb), keys and then the weight columns; the kept
  // output rows reuse the same words
  __shared__ uint32_t s_keys[(kTile + 2) * W];
  __shared__ uint32_t s_cols[kWrite ? NC : 1][kWrite ? kTile + 2 : 1];
  __shared__ int s_warp[kThreads / 32];
  const int tid = threadIdx.x;
  const long long t = blockIdx.x;

  if constexpr (kWrite) {  // padding of this tile's output range past the union
    const long long nm = *n_merged;
    long long p0 = t * kTile, p1 = p0 + kTile;
    if (p0 < nm) p0 = nm;
    if (p1 > out.cap) p1 = out.cap;
    for (long long i = p0 * W + tid; i < p1 * W; i += kThreads) out.keys[i] = kOnes;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      for (long long i = p0 + tid; i < p1; i += kThreads) out.cols[c][i] = 0;
  }
  if (t >= tiles) return;

  const long long na = rows_of(a), nb = rows_of(b);
  const long long total = na + nb;
  const long long d0 = t * kTile < total ? t * kTile : total;
  const long long d1 = d0 + kTile < total ? d0 + kTile : total;
  if (d0 >= d1) {
    if (!kWrite && tid == 0) drops[t] = 0;
    return;
  }
  const long long i0 = split[t], i1 = split[t + 1];
  const long long j0 = d0 - i0, j1 = d1 - i1;
  const long long ia = i0 > 0 ? i0 - 1 : 0;    // one A row before the tile
  const long long jb = j1 < nb ? j1 + 1 : j1;  // one B row after it
  const int a_rows = (int)(i1 - ia), b_rows = (int)(jb - j0);

  for (int i = tid; i < a_rows * W; i += kThreads) s_keys[i] = a.keys[ia * W + i];
  for (int i = tid; i < b_rows * W; i += kThreads) s_keys[a_rows * W + i] = b.keys[j0 * W + i];
  if constexpr (kWrite) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < a_rows; i += kThreads)
        s_cols[c][i] = a.cols[c] != nullptr ? a.cols[c][ia + i] : 0u;
      for (int i = tid; i < b_rows; i += kThreads)
        s_cols[c][a_rows + i] = b.cols[c] != nullptr ? b.cols[c][j0 + i] : 0u;
    }
  }
  __syncthreads();

  // shared-memory row of A row i and of B row j (global indices)
  auto sa = [&](long long i) { return s_keys + (int)(i - ia) * W; };
  auto sb = [&](long long j) { return s_keys + (a_rows + (int)(j - j0)) * W; };

  // this thread's first position and its split, by a search along its diagonal
  const int span = (int)(d1 - d0);
  const int a_len = (int)(i1 - i0), b_len = (int)(j1 - j0);
  const int dd = tid * kItems < span ? tid * kItems : span;
  int lo = dd > b_len ? dd - b_len : 0, hi = dd < a_len ? dd : a_len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_le<W>(sa(i0 + mid), sb(j0 + dd - 1 - mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  long long i = i0 + lo, j = j0 + dd - lo;
  const int items = span - dd < kItems ? span - dd : kItems;

  // the merge of this thread's positions: each kept row's shared-memory row and, for an A
  // row equal to the next B row, that B row's (its weights are added)
  int src[kItems], add[kItems];
  int kept = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    src[k] = -1;
    add[k] = -1;
    if (k < items) {
      const bool take_a = i < i1 && (j >= j1 || key_le<W>(sa(i), sb(j)));
      if (take_a) {
        src[k] = (int)(i - ia);
        if (j < nb && key_eq<W>(sa(i), sb(j))) add[k] = a_rows + (int)(j - j0);
        ++i;
      } else {
        if (!(i > 0 && key_eq<W>(sa(i - 1), sb(j)))) src[k] = a_rows + (int)(j - j0);
        ++j;
      }
      kept += src[k] >= 0;
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
  if constexpr (!kWrite) {
    const int d = warp_sum(items - kept);
    if (lane == 0) s_warp[warp] = d;
    __syncthreads();
    if (tid == 0) {
      long long sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
      drops[t] = sum;
    }
  } else {
    // the kept rows' keys and weights into registers, then their places in the tile
    uint32_t rk[kItems][W], rc[kItems][NC];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (src[k] >= 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) rk[k][w] = s_keys[src[k] * W + w];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          rc[k][c] = s_cols[c][src[k]] + (add[k] >= 0 ? s_cols[c][add[k]] : 0u);
      }
    }
    int incl = kept;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // every thread has read the staged rows
    int base = incl - kept, tile_kept = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) base += s_warp[w];
      tile_kept += s_warp[w];
    }
    int at = base;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (src[k] >= 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) s_keys[at * W + w] = rk[k][w];
#pragma unroll
        for (int c = 0; c < NC; ++c) s_cols[c][at] = rc[k][c];
        ++at;
      }
    }
    __syncthreads();
    const long long o0 = d0 - drops[t];  // drops: the exclusive scan over tiles
    long long rows = tile_kept;
    if (o0 + rows > out.cap) rows = out.cap > o0 ? out.cap - o0 : 0;
    for (long long x = tid; x < rows * W; x += kThreads) out.keys[o0 * W + x] = s_keys[x];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      for (long long x = tid; x < rows; x += kThreads) out.cols[c][o0 + x] = s_cols[c][x];
  }
}

// One CTA: the exclusive scan of the tiles' drops in place, the union's size and the
// output's n, and the valid rows read.
template <int W, int NC>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(Side a, Side b, long long* drops, long long tiles, long long* n_merged, Out out,
            long long* rows_read) {
  __shared__ long long s_sum[kScanThreads];
  const int tid = threadIdx.x;
  const long long per = (tiles + kScanThreads - 1) / kScanThreads;
  const long long lo = tid * per < tiles ? tid * per : tiles;
  const long long hi = lo + per < tiles ? lo + per : tiles;
  long long own = 0;
#pragma unroll 8
  for (long long x = lo; x < hi; ++x) own += drops[x];
  s_sum[tid] = own;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // Hillis-Steele, inclusive
    const long long v = tid >= o ? s_sum[tid - o] : 0;
    __syncthreads();
    s_sum[tid] += v;
    __syncthreads();
  }
  long long run = s_sum[tid] - own;
#pragma unroll 8
  for (long long x = lo; x < hi; ++x) {
    const long long d = drops[x];
    drops[x] = run;
    run += d;
  }
  if (tid != 0) return;
  const long long na = rows_of(a), nb = rows_of(b);
  const long long nm = na + nb - s_sum[kScanThreads - 1];
  // the union's last row, where it is the all-ones key: its weights
  bool ones_a = na > 0, ones_b = nb > 0;
  for (int w = 0; w < W; ++w) {
    if (ones_a) ones_a = a.keys[(na - 1) * W + w] == kOnes;
    if (ones_b) ones_b = b.keys[(nb - 1) * W + w] == kOnes;
  }
  bool strip = ones_a || ones_b;
  for (int c = 0; c < NC; ++c) {
    uint32_t s = 0;
    if (ones_a && a.cols[c] != nullptr) s += a.cols[c][na - 1];
    if (ones_b && b.cols[c] != nullptr) s += b.cols[c][nb - 1];
    strip &= s == 0;
  }
  *n_merged = nm;
  *out.n = nm - (strip ? 1 : 0);
  *rows_read = na + nb;
}

template <int W, int NC>
cudaError_t launch(const Side& a, const Side& b, const Out& out, long long* scratch,
                   long long tiles, cudaStream_t s) {
  long long* split = scratch;              // tiles + 1
  long long* drops = scratch + tiles + 1;  // tiles
  long long* n_merged = drops + tiles;
  long long* rows_read = n_merged + 1;
  const long long search_blocks = (tiles + 1 + kSearchThreads - 1) / kSearchThreads;
  partition_kernel<W><<<(unsigned)search_blocks, kSearchThreads, 0, s>>>(a, b, split, tiles);
  if (tiles > 0)  // the count reads no weights: one instance a W
    tile_kernel<W, 1, false><<<(unsigned)tiles, kThreads, 0, s>>>(a, b, split, drops, tiles,
                                                                  n_merged, out);
  scan_kernel<W, NC><<<1, kScanThreads, 0, s>>>(a, b, drops, tiles, n_merged, out, rows_read);
  const long long out_tiles = (out.cap + kTile - 1) / kTile;
  const long long grid = tiles > out_tiles ? tiles : out_tiles;
  if (grid > 0)
    tile_kernel<W, NC, true><<<(unsigned)grid, kThreads, 0, s>>>(a, b, split, drops, tiles,
                                                                 n_merged, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_cols(int n_cols, const Side& a, const Side& b, const Out& out,
                        long long* scratch, long long tiles, cudaStream_t s) {
  return n_cols == 1 ? launch<W, 1>(a, b, out, scratch, tiles, s)
                     : launch<W, 2>(a, b, out, scratch, tiles, s);
}

}  // namespace

// scratch: 2 * tiles + 3 int64 words, tiles = ceil((a_cap + b_cap) / 1024); scratch_len
// says how many the caller allocated.
extern "C" int dk_table_merge(
    const void* a_keys, const void* a_n, long long a_cap, const void* a_col0,
    const void* a_col1, const void* b_keys, const void* b_n, long long b_cap,
    const void* b_col0, const void* b_col1, void* out_keys, void* out_col0, void* out_col1,
    void* out_n, long long out_cap, int words, int n_cols, void* scratch,
    long long scratch_len, int device, void* stream) {
  if (words < 1 || words > 4 || n_cols < 1 || n_cols > kMaxCols || a_cap < 0 || b_cap < 0 ||
      out_cap < 0)
    return cudaErrorInvalidValue;
  const long long tiles = (a_cap + b_cap + kTile - 1) / kTile;
  const long long out_tiles = (out_cap + kTile - 1) / kTile;
  if (scratch_len < 2 * tiles + 3 || tiles >= 0x7FFFFFFFLL || out_tiles >= 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Side a{static_cast<const uint32_t*>(a_keys),
         {static_cast<const uint32_t*>(a_col0), static_cast<const uint32_t*>(a_col1)},
         static_cast<const long long*>(a_n), a_cap};
  Side b{static_cast<const uint32_t*>(b_keys),
         {static_cast<const uint32_t*>(b_col0), static_cast<const uint32_t*>(b_col1)},
         static_cast<const long long*>(b_n), b_cap};
  Out out{static_cast<uint32_t*>(out_keys),
          {static_cast<uint32_t*>(out_col0), static_cast<uint32_t*>(out_col1)},
          static_cast<long long*>(out_n), out_cap};
  auto sc = static_cast<long long*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: return static_cast<int>(launch_cols<1>(n_cols, a, b, out, sc, tiles, s));
    case 2: return static_cast<int>(launch_cols<2>(n_cols, a, b, out, sc, tiles, s));
    case 3: return static_cast<int>(launch_cols<3>(n_cols, a, b, out, sc, tiles, s));
    default: return static_cast<int>(launch_cols<4>(n_cols, a, b, out, sc, tiles, s));
  }
}
