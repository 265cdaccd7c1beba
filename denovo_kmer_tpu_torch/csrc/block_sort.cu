// Per-block bitonic sort of every column by u32 key, with a u32 payload, for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/micro_pallas_sort.py:_kernel (pallas_block_sort, and the
// inline pallas_call of its main), whose network is _bitonic_sort_block. Contract: keys and
// pays (N, L) u32, row-major; every (R, L) block of R consecutive rows (R a power of two from
// 2 to 16384, N a multiple of R) has each of its L columns sorted ascending by unsigned key,
// each payload moving with its key. The network is the TPU kernel's, stage for stage:
//   for size = 2^P, P = 1 .. log2 R:  for stride = 2^Q, Q = P-1 .. 0:
//     every row i with bit Q clear pairs with i + 2^Q; the pair is in a descending run when
//     bit P of i is set; it swaps when (key[i] > key[i + 2^Q]) XOR descending (strict).
// Equal keys in a descending run do swap, so the order of payloads under equal keys is the
// network's own; running the same network gives the TPU kernel's output bit for bit.
//
// Design: the network runs in registers. A column is sorted by a team of T = R / E threads,
// each holding E of its rows, keys and payloads (2E data registers): E = 16, the whole block
// below 16 rows, and 32 at R = 16384 (a team of 512 threads). A layout S maps row bits to
// places: bits S .. S+LE-1 (LE = log2 E) are the register index j, the others, in order,
// the thread index t within the team (row = t's low S bits | j << S | t's high bits <<
// (S + LE)). A stage at stride bit Q is then one of:
//   - a register stage, Q in [S, S+LE): compare-exchange of registers j and j | 2^(Q-S),
//     fully unrolled, no memory traffic; the direction bit P is a register bit (known at
//     compile time) or a thread bit (one predicate a thread and merge);
//   - a shuffle stage, Q a thread bit below LE (a lane bit): each thread takes
//     its partner's key and payload by __shfl_xor_sync and keeps the one the pair puts on
//     its side;
//   - else a transpose through shared memory to the layout S' = clamp(Q - LE + 1) whose
//     window has Q on top, then a register stage there.
// The schedule this gives at R = 2048 (LE = 4, T = 128: four warps a column; rS = register
// stage in layout S, sS = shuffle stage, Ta->b = transpose between layouts):
//   P = 1..4:  r0 (10 stages)       P = 5..8: s4 .. s(P-1), then r3 r2 r1 r0
//   P = 9:     T0->5 r8 r7 r6 r5 T5->1 r4 r3 r2 r1 s0
//   P = 10:    T1->6 r9 r8 r7 r6 T6->2 r5 r4 r3 r2 s1 s0
//   P = 11:    T2->7 r10 r9 r8 r7 T7->3 r6 r5 r4 r3 s2 s1 s0
// 66 stages: 50 register stages, 16 shuffle stages, 6 transposes, plus the tile's read into
// layout 0 and its write from layout 3. (R = 16384: 80, 25, 8; no R below 512 transposes,
// and R <= 16 is registers alone, many columns to a warp.) Lane bit LE transposes rather
// than shuffles: a transpose serves LE stages for 2 shared accesses an element, where a
// shuffle stage takes 2 SHFL and ~5 ALU (at R = 2048, 10.17 ms against 10.51 with lane bit
// 4 shuffled, in one call: PERF.md, Findings).
// Instructions, per compare-exchange: a register stage is one ISETP (the direction folded
// in) and four SEL (two may be IMNMX where the direction is known at compile time): 5. A
// shuffle stage costs an element 2 SHFL, 2 LOP3 (the role), one ISETP (the direction folded
// in) and 2 SEL; a transpose an 8-byte STS, an 8-byte LDS and their addresses.
//
// Threads that share a column synchronise alone: a named barrier (bar.sync id, T) for a
// team of several warps, __syncwarp for a team inside one warp. The only CTA-wide barriers
// are around the tile's load and store. Shared memory holds the CTA's tile as (key,
// payload) pairs, R a column; row r of a column sits at slot r ^ ((r >> LE) & 15), which puts
// the 16 lanes of each half-warp of every 8-byte access of every layout on distinct banks
// from R = 256 up. Below, the columns of a warp's teams are 8R bytes apart, and the tile's
// one read into registers and one write back conflict up to 16 ways (at R = 16).
//
// A CTA is 512 threads: as many columns as fill it (cta_columns, from the block height the
// wrapper passes), taken from the flattened (block, column) space so that columns of one
// block are consecutive: at R = 2048, 4 columns of 4 warps each, 512 threads of 64
// registers and 64 KiB of shared memory, two CTAs an SM, so that one CTA's load and store
// overlap another's network. The tile moves between device memory and shared memory in row
// segments: one 16-byte vector a row and array per 4 columns where L and the pointers
// allow, else a word a thread with consecutive threads on consecutive columns.
//
// Bound: operations. 2^28 pairs a stage x 66 stages x 5 instructions = 8.9e10 integer
// instructions at the probe's shape (2^22 x 128, R = 2048), 5.3 ms at 64 a clock an SM on
// 132 SMs at 1.98 GHz; the bytes (each key and payload read and written once, 8.59 GB) take
// 2.56 ms at 3.35 TB/s. The shuffle stages, transposes and addresses are the cost above that
// count (PERF.md, Findings). The launch bound asks ptxas for two CTAs an SM up to R = 4096
// (64 registers, no spills); R = 8192 and 16384 take one (105 and 128 registers), where two
// would spill 84 and 52 bytes a thread.
//
// The kernel launches on the caller's stream, does not synchronise and allocates nothing.
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLogR = 14;      // 16384 rows a block
constexpr int kMaxThreads = 512;  // a CTA; lets ptxas give a thread up to 128 registers
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// log2 of the rows a thread holds: 16, the whole block below 16 rows, and 32 at 16384 rows
// (a team of 512 threads, the most a CTA takes).
__host__ __device__ constexpr int log_e(int LR) { return LR < 4 ? LR : LR < 14 ? 4 : 5; }

// Columns a CTA: as many teams as fill kMaxThreads threads.
__host__ __device__ constexpr int cta_columns(int LR) {
  return kMaxThreads / ((1 << LR) >> log_e(LR));
}

// Every instance's CTA is whole warps, its teams of several warps have a named barrier each
// (ids 1..15), and its tile fits shared memory.
constexpr bool geometry_fits() {
  for (int LR = 1; LR <= kMaxLogR; ++LR) {
    const int team = (1 << LR) >> log_e(LR), cols = cta_columns(LR);
    if (team > kMaxThreads || cols * team != kMaxThreads || (team > 32 && cols > 15) ||
        (size_t)8 * cols * (1 << LR) > kMaxSmem)
      return false;
  }
  return true;
}
static_assert(geometry_fits(), "a block height the CTA cannot take");

__host__ __device__ constexpr int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Shared-memory slot of row `row` within its column: row bits LE..LE+3 are XORed onto bits
// 0..3, which puts the 16 lanes of each half-warp of every 8-byte access of every layout on
// distinct bank pairs (R >= 256, see the header). XOR-linear: word_of(a | b) ==
// word_of(a) ^ word_of(b) for disjoint a, b.
template <int LE>
__host__ __device__ constexpr int word_of(int row) {
  return row ^ ((row >> LE) & 15);
}

// Row bits that thread t of a team holds in layout S (its register bits are zero).
template <int LE, int S>
__device__ __forceinline__ int thread_rows(int t) {
  return (t & ((1 << S) - 1)) | ((t >> S) << (S + LE));
}

template <int E>
struct Tile {
  uint32_t k[E];
  uint32_t p[E];
};

struct Team {
  int t;     // thread index within the team
  int id;    // team index within the CTA
  char* s;   // the CTA's tile in shared memory: (key, payload) a row, R rows a column
  int col8;  // byte offset of the team's column in it (a multiple of 8R)
};

// The (key, payload) slot of row bits `thread` | `reg` in the team's column. The column
// starts at a multiple of 8R bytes, so the XOR of the compile-time part stays inside it and
// costs one instruction an access.
template <int LE>
__device__ __forceinline__ uint2* slot(const Team& m, int thread, int reg) {
  const int at = (m.col8 + 8 * word_of<LE>(thread)) ^ (8 * word_of<LE>(reg));
  return reinterpret_cast<uint2*>(m.s + at);
}

template <int T>
__device__ __forceinline__ void team_sync(int id) {
  if constexpr (T > 32) {
    asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "n"(T) : "memory");
  } else {
    __syncwarp();
  }
}

// Whether row (t, j) of layout S lies in a descending run of merge P: bit P of the row
// (never for P == LR, the last merge ascends everywhere).
template <int LR, int LE, int S, int P>
__device__ __forceinline__ bool descending(int t, int j) {
  if constexpr (P >= LR) {
    return false;
  } else if constexpr (P >= S && P < S + LE) {
    return (j >> (P - S)) & 1;
  } else if constexpr (P < S) {
    return (t >> P) & 1;
  } else {
    return (t >> (P - LE)) & 1;
  }
}

template <int LR, int LE, int S, int P, int Q>
__device__ __forceinline__ void register_stage(Tile<1 << LE>& x, int t) {
  constexpr int E = 1 << LE, b = 1 << (Q - S);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j & b) continue;
    const bool desc = descending<LR, LE, S, P>(t, j);
    const uint32_t klo = x.k[j], khi = x.k[j | b], plo = x.p[j], phi = x.p[j | b];
    const bool swap = (klo > khi) != desc;
    x.k[j] = swap ? khi : klo;
    x.k[j | b] = swap ? klo : khi;
    x.p[j] = swap ? phi : plo;
    x.p[j | b] = swap ? plo : phi;
  }
}

template <int LR, int LE, int S, int P, int Q>
__device__ __forceinline__ void shuffle_stage(Tile<1 << LE>& x, int t) {
  constexpr int E = 1 << LE, i = Q < S ? Q : Q - LE, mask = 1 << i;
  // All ones where this thread holds the pair's row with bit Q set: then key[lo] > key[hi]
  // is ~key > ~partner's key. One compare with the direction folded in, and no select of
  // the operands' order (a predicate for the role would be rebuilt at every use: ptxas has
  // 7 predicate registers).
  const uint32_t flip = 0u - ((t >> i) & 1);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const uint32_t ko = __shfl_xor_sync(kFull, x.k[j], mask);
    const uint32_t po = __shfl_xor_sync(kFull, x.p[j], mask);
    const bool swap = ((x.k[j] ^ flip) > (ko ^ flip)) != descending<LR, LE, S, P>(t, j);
    x.k[j] = swap ? ko : x.k[j];
    x.p[j] = swap ? po : x.p[j];
  }
}

template <int LE, int S>
__device__ __forceinline__ void to_shared(const Tile<1 << LE>& x, const Team& m) {
  const int rows = thread_rows<LE, S>(m.t);
#pragma unroll
  for (int j = 0; j < (1 << LE); ++j) *slot<LE>(m, rows, j << S) = make_uint2(x.k[j], x.p[j]);
}

template <int LE, int S>
__device__ __forceinline__ void from_shared(Tile<1 << LE>& x, const Team& m) {
  const int rows = thread_rows<LE, S>(m.t);
#pragma unroll
  for (int j = 0; j < (1 << LE); ++j) {
    const uint2 v = *slot<LE>(m, rows, j << S);
    x.k[j] = v.x;
    x.p[j] = v.y;
  }
}

// Stages (P, Q) onwards, in layout S; ends by writing the column to shared memory.
template <int LR, int P, int Q, int S>
__device__ __forceinline__ void network(Tile<1 << log_e(LR)>& x, const Team& m) {
  constexpr int LE = log_e(LR), T = (1 << LR) >> LE;
  if constexpr (P > LR) {
    __syncthreads();  // every team is done reading the tile
    to_shared<LE, S>(x, m);
  } else {
    constexpr int P2 = Q == 0 ? P + 1 : P, Q2 = Q == 0 ? P : Q - 1;
    constexpr int lane_bit = Q < S ? Q : Q - LE;
    if constexpr (Q >= S && Q < S + LE) {
      register_stage<LR, LE, S, P, Q>(x, m.t);
      network<LR, P2, Q2, S>(x, m);
    } else if constexpr (lane_bit < LE) {
      shuffle_stage<LR, LE, S, P, Q>(x, m.t);
      network<LR, P2, Q2, S>(x, m);
    } else {
      constexpr int S2 = clamp_int(Q - LE + 1, 0, LR - LE);
      team_sync<T>(m.id);  // the team is done reading the column
      to_shared<LE, S>(x, m);
      team_sync<T>(m.id);
      from_shared<LE, S2>(x, m);
      register_stage<LR, LE, S2, P, Q>(x, m.t);
      network<LR, P2, Q2, S2>(x, m);
    }
  }
}

// Moves the CTA's tile between device memory (keys and pays, (N, L) row-major) and shared
// memory (`cols` columns of R (key, payload) slots). Column slot s of the CTA is flattened
// column col0 + s of the (block, column) space; slots past `columns` are skipped.
template <int LR, bool kLoad>
__device__ __forceinline__ void move_tile(const uint32_t* __restrict__ keys,
                                          const uint32_t* __restrict__ pays,
                                          uint32_t* __restrict__ out_keys,
                                          uint32_t* __restrict__ out_pays, uint2* tile,
                                          long long col0, long long columns, int L,
                                          int log_cols, bool vec) {
  constexpr int R = 1 << LR, LE = log_e(LR);
  if (vec) {  // 4 columns a thread, one 16-byte vector a row and array
    const int log_groups = log_cols - 2;
    const int group = threadIdx.x & ((1 << log_groups) - 1);
    const long long idx = col0 + 4 * group;
    if (idx >= columns) return;
    const long long g = idx / L;
    const long long base = (g * R * L + (idx - g * L)) >> 2;  // in 16-byte vectors
    const int step = blockDim.x >> log_groups;
    uint2* t0 = tile + 4 * group * R;
#pragma unroll 4
    for (int row = threadIdx.x >> log_groups; row < R; row += step) {
      const int w = word_of<LE>(row);
      const long long at = base + (long long)row * (L >> 2);
      if constexpr (kLoad) {
        const uint4 k = reinterpret_cast<const uint4*>(keys)[at];
        const uint4 p = reinterpret_cast<const uint4*>(pays)[at];
        t0[w] = make_uint2(k.x, p.x);
        t0[R + w] = make_uint2(k.y, p.y);
        t0[2 * R + w] = make_uint2(k.z, p.z);
        t0[3 * R + w] = make_uint2(k.w, p.w);
      } else {
        const uint2 a = t0[w], b = t0[R + w], c = t0[2 * R + w], d = t0[3 * R + w];
        reinterpret_cast<uint4*>(out_keys)[at] = make_uint4(a.x, b.x, c.x, d.x);
        reinterpret_cast<uint4*>(out_pays)[at] = make_uint4(a.y, b.y, c.y, d.y);
      }
    }
  } else {  // a word a thread and array, consecutive threads on consecutive columns
    const int slot = threadIdx.x & ((1 << log_cols) - 1);
    const long long idx = col0 + slot;
    if (idx >= columns) return;
    const long long g = idx / L;
    const long long base = g * R * L + (idx - g * L);
    const int step = blockDim.x >> log_cols;
    uint2* t0 = tile + slot * R;
#pragma unroll 4
    for (int row = threadIdx.x >> log_cols; row < R; row += step) {
      const long long at = base + (long long)row * L;
      if constexpr (kLoad) {
        t0[word_of<LE>(row)] = make_uint2(keys[at], pays[at]);
      } else {
        const uint2 v = t0[word_of<LE>(row)];
        out_keys[at] = v.x;
        out_pays[at] = v.y;
      }
    }
  }
}

// Two CTAs an SM up to 4096 rows, one above (the header's Bound).
template <int LR>
__global__ void __launch_bounds__(kMaxThreads, LR <= 12 ? 2 : 1) block_sort_kernel(
    const uint32_t* __restrict__ keys, const uint32_t* __restrict__ pays,
    uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_pays, long long columns,
    int L, int log_cols, int vec) {
  constexpr int LE = log_e(LR), R = 1 << LR, T = R >> LE;
  extern __shared__ uint2 smem[];
  const long long col0 = (long long)blockIdx.x << log_cols;
  move_tile<LR, true>(keys, pays, nullptr, nullptr, smem, col0, columns, L, log_cols, vec);
  __syncthreads();
  const int team = threadIdx.x / T;
  const Team m{(int)threadIdx.x % T, team, reinterpret_cast<char*>(smem), team * R * 8};
  Tile<1 << LE> x;
  from_shared<LE, 0>(x, m);
  network<LR, 1, 0, 0>(x, m);
  __syncthreads();
  move_tile<LR, false>(nullptr, nullptr, out_keys, out_pays, smem, col0, columns, L, log_cols,
                       vec);
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, uint32_t*, long long,
                        int, int, int);

// One instance a block height, indexed by log2 R.
const Kernel kKernels[kMaxLogR + 1] = {
    nullptr,                block_sort_kernel<1>,  block_sort_kernel<2>,
    block_sort_kernel<3>,   block_sort_kernel<4>,  block_sort_kernel<5>,
    block_sort_kernel<6>,   block_sort_kernel<7>,  block_sort_kernel<8>,
    block_sort_kernel<9>,   block_sort_kernel<10>, block_sort_kernel<11>,
    block_sort_kernel<12>,  block_sort_kernel<13>, block_sort_kernel<14>};

}  // namespace

// keys, pays (N, L) u32 row-major; writes out_keys, out_pays (N, L) u32 with every column of
// every block of `block_rows` rows sorted by key (2 to 16384 rows). A CTA takes
// kMaxThreads / team columns (cta_columns).
// On `device`, in the order of `stream`. With `info` non-null nothing launches: info[0..5]
// get the instance's registers a thread, local (spilled) bytes a thread, CTAs resident on
// an SM, threads, shared bytes and columns a CTA.
extern "C" int dk_block_sort(const void* keys, const void* pays, void* out_keys,
                             void* out_pays, long long N, int L, int block_rows, int device,
                             void* stream, void* info) {
  int LR = 0;
  while (LR < 31 && (1 << LR) < block_rows) ++LR;
  if (N <= 0 || L < 1 || LR < 1 || LR > kMaxLogR || (1 << LR) != block_rows ||
      N % block_rows != 0)
    return cudaErrorInvalidValue;
  const int cols = cta_columns(LR);
  const int threads = kMaxThreads;
  const size_t smem = (size_t)8 * cols * block_rows;
  const long long columns = N / block_rows * L;
  const long long grid = (columns + cols - 1) / cols;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  int log_cols = 0;
  while ((1 << log_cols) < cols) ++log_cols;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = L % 4 == 0 && cols % 4 == 0 && aligned(keys) && aligned(pays) &&
                  aligned(out_keys) && aligned(out_pays);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Kernel kernel = kKernels[LR];
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  if (info != nullptr) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int* out = static_cast<int*>(info);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = per_sm;
    out[3] = threads;
    out[4] = (int)smem;
    out[5] = cols;
    return cudaSuccess;
  }
  kernel<<<(unsigned)grid, (unsigned)threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(pays),
      static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_pays), columns, L,
      log_cols, vec);
  return static_cast<int>(cudaGetLastError());
}
