// Sweep-select kernel (K9) for NVIDIA Hopper (sm_90a): the union sweep's
// select of `kernel` mode, a tile of lanes per block, each lane's rows split
// across a group of threads.
//
// Replaces ptx/ops/sweep_kernel.py:164 build_sweep_select, the Pallas TPU
// kernel (_kernel :112, pallas_call :204).  Its plain PyTorch version is
// ptx_torch/ops/sweep_kernel.py sweep_select_reference; the wrapper,
// sweep_select in the same module, checks the inputs and allocates the
// outputs.  ptx_torch/geom/fasthit.py UnionSweepHit calls it once per hit in
// `kernel` mode: with sort = 1 on the unsorted intervals up to
// sweep_kernel.SORT_INSIDE_ROWS padded rows, else with sort = 0 on starts
// sorted by torch.sort.
//
// What it computes, per ray, from the S pooled coverage intervals (s, e) of
// the union (valid-masked: s = 3e20, e = -3e20 where invalid) and the L raw
// leaf intervals (t0, t1):
// - the exclusive prefix max P of e over the rows sorted by s;
// - a break at row k iff s < 2e20 and s > P (touching intervals merge);
// - te = min s over breaks with s >= eps, tx = min P over breaks with
//   P >= eps, and the last chain's exit max(e) when >= eps;
// - entering = te <= tx, t_star = min(te, tx), found = t_star < 2e20;
// - the payload: the least leaf whose raw t0 (m_start), and the least whose
//   raw t1 (m_end), equals t_star bit for bit; L where none does.
// Only compares, selects, max and min: the outputs equal the plain version's
// bit for bit.
//
// What bounds it on this card: bytes.  It reads (2S + 2L) x B floats and
// writes 14 B a ray; at S = L = 256 and B = 65,536 that is 268 MB, 80 us of
// HBM time at 3.35 TB/s.  One thread per ray leaves too few loads in flight
// on narrow bounces and walks S rows serially.  Design:
// - A block of 256 threads takes a tile of bw lanes; thread (x, y) is lane
//   x of the tile and segment y of g = 256 / bw.  bw is picked from B
//   (sweep_kernel.lane_tile) so that the grid puts several blocks on each
//   of the 132 SMs at every width.
// - sort = 0 (rows sorted by s): a chunk is g segments of 16 rows; each
//   thread loads its segment's rows of (s, e) straight into registers, all
//   32 loads issued before the first is used, a warp reading whole 32-byte
//   sectors of a row; the sweep_lane.cuh segment arithmetic then runs on
//   them (segment max, the exclusive max-scan over the segments through
//   shared memory, the re-walk from the incoming prefix, the minima),
//   carrying the prefix and the minima from chunk to chunk.  (A shared-memory
//   tile a chunk drained the loads in flight at every block barrier and
//   lost to one thread a lane above 65,536 lanes: PERF.md.)
// - sort = 1 (the TPU kernel's in-kernel sort): the block copies its lanes'
//   columns of S rows of (s, e) into shared memory (room for Sv = max(32,
//   Sp) rows); one warp takes a lane's column, moves the rows with s < 2e20
//   to its front (a ballot and a prefix count a row: the others are never
//   breaks and sort after all of them, so only their max of e counts, in
//   the last exit), sorts those n rows in registers (a bitonic network over
//   the least power of 2 >= max(n, 32) rows, 1 to Sv / 32 entries a thread:
//   in-thread stages as register swaps, cross-thread stages through
//   __shfl_xor_sync, strict compares so (s, e) stays a permutation under
//   ties, no block barrier a stage) and writes them back; then the segment
//   sweep runs on the n sorted rows of each column.  The sweep's outputs do
//   not depend on the order of equal starts (ptx/ops/sweep_kernel.py:28-32),
//   so the unstable network gives the stable sort's answer.
// - The payload: thread (x, y) scans leaf rows y, y + g, ... of lane x,
//   coalesced across the tile, four rows a step, folding its matches into
//   the lane's least in shared memory (an atomic min) and reading no row at
//   or past the least known, as the serial loop reads t0 up to its match and
//   t1 up to its; the least is the serial loop's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_lane.cuh"

namespace {

using ptx_sweep::kNeg;
using ptx_sweep::kPad;

constexpr int kThreads = 256;
constexpr int kSegRows = 16;             // a segment's rows of a chunk, in registers (sort = 0)
constexpr int kMaxSortRows = 1024;       // Sv: a lane's column, 32 entries a thread at most
constexpr int kSortTileBytes = 73728;    // a sort = 1 block's (s, e) columns at most

// Per-block reduction rows: the segments' values of each lane of the tile,
// and each lane's least payload matches.
struct Red {
  float m[kThreads], te[kThreads], tx[kThreads];
  int ms[32], me[32];
};

// One pass of the segment sweep over `rows` rows held in shared memory (row
// k of lane x at ss[x * xs + k * ks]): segment y's max, the scan over the
// segments before it from the carried prefix P, its re-walk, and P moved
// past the rows.
__device__ __forceinline__ void sweep_rows(const float* ss, const float* se, int xs, int ks,
                                           int rows, int g, int x, int y, int bw, float eps,
                                           Red& red, float& P, float& te, float& tx) {
  int k0, k1;
  ptx_sweep::segment(rows, g, y, k0, k1);
  const float* s = ss + x * xs;
  const float* e = se + x * xs;
  red.m[y * bw + x] = ptx_sweep::segment_max(e, k0, k1, ks);
  __syncthreads();
  float pin = P, total = P;
  for (int j = 0; j < g; ++j) {
    const float mj = red.m[j * bw + x];
    if (j < y) pin = fmaxf(pin, mj);
    total = fmaxf(total, mj);
  }
  ptx_sweep::segment_sweep(s, e, k0, k1, ks, pin, eps, te, tx);
  P = total;
  __syncthreads();
}

// The segments' minima combined, the selection, the payload split over the
// segments, and the outputs written by segment 0.
__device__ __forceinline__ void select_and_write(
    const float* __restrict__ t0, const float* __restrict__ t1, int L, int B, int lane, int g,
    int x, int y, int bw, float eps, Red& red, float P, float te, float tx,
    float* __restrict__ t_star_out, uint8_t* __restrict__ entering_out,
    int* __restrict__ m_start_out, int* __restrict__ m_end_out,
    uint8_t* __restrict__ found_out) {
  red.te[y * bw + x] = te;
  red.tx[y * bw + x] = tx;
  if (y == 0) red.ms[x] = red.me[x] = L;
  __syncthreads();
  float te_all = kPad, tx_all = kPad;
  for (int j = 0; j < g; ++j) {
    te_all = fminf(te_all, red.te[j * bw + x]);
    tx_all = fminf(tx_all, red.tx[j * bw + x]);
  }
  float t_star;
  bool entering, found;
  ptx_sweep::finish(te_all, tx_all, P, eps, t_star, entering, found);
  if (lane < B)
    ptx_sweep::payload_first(t0 + lane, t1 + lane, y, g, L, (size_t)B, t_star, &red.ms[x],
                             &red.me[x]);
  __syncthreads();
  if (y != 0 || lane >= B) return;
  t_star_out[lane] = t_star;
  entering_out[lane] = entering;
  m_start_out[lane] = red.ms[x];
  m_end_out[lane] = red.me[x];
  found_out[lane] = found;
}

// sort = 0: BW lanes a block, G = 256 / BW segments a lane; a chunk is G
// segments of kSegRows rows, each segment's rows loaded straight into its
// thread's registers, every load issued before the first is used.
template <int BW>
__global__ void __launch_bounds__(kThreads)
sweep_select_kernel(const float* __restrict__ s, const float* __restrict__ e, int S,
                    const float* __restrict__ t0, const float* __restrict__ t1, int L, int B,
                    float eps, float* __restrict__ t_star, uint8_t* __restrict__ entering,
                    int* __restrict__ m_start, int* __restrict__ m_end,
                    uint8_t* __restrict__ found) {
  constexpr int G = kThreads / BW, R = kSegRows;
  __shared__ Red red;
  const int x = threadIdx.x % BW, y = threadIdx.x / BW;
  const int lane = blockIdx.x * BW + x;
  const bool live = lane < B;
  float P = kNeg, te = kPad, tx = kPad;
  for (int c0 = 0; c0 < S; c0 += G * R) {
    const int k0 = c0 + y * R;
    const float* sk = s + (size_t)k0 * B + lane;
    const float* ek = e + (size_t)k0 * B + lane;
    float a[R], b[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool in = live && k0 + j < S;
      a[j] = in ? sk[(size_t)j * B] : kPad;
      b[j] = in ? ek[(size_t)j * B] : kNeg;
    }
    red.m[threadIdx.x] = ptx_sweep::segment_max_regs<R>(b);
    __syncthreads();
    float pin = P, total = P;
    for (int j = 0; j < G; ++j) {
      const float mj = red.m[j * BW + x];
      if (j < y) pin = fmaxf(pin, mj);
      total = fmaxf(total, mj);
    }
    ptx_sweep::segment_sweep_regs<R>(a, b, pin, eps, te, tx);
    P = total;
    __syncthreads();
  }
  select_and_write(t0, t1, L, B, lane, G, x, y, BW, eps, red, P, te, tx, t_star, entering,
                   m_start, m_end, found);
}

// A lane's column of 32 * N (s, e) pairs, entry r of thread t at row
// r * 32 + t, sorted by s ascending in place by a bitonic network.
template <int N>
__device__ __forceinline__ void warp_bitonic(float (&a)[N], float (&b)[N], int t) {
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {                           // partner in the same thread
        const int jr = j >> 5;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if (r & jr) continue;
          const int r2 = r | jr;
          const bool asc = ((r * 32) & size) == 0;
          if (asc ? (a[r2] < a[r]) : (a[r2] > a[r])) {
            const float sa = a[r], sb = b[r];
            a[r] = a[r2];
            b[r] = b[r2];
            a[r2] = sa;
            b[r2] = sb;
          }
        }
      } else {                                 // partner in thread t ^ j
        const bool lower = (t & j) == 0;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const float pa = __shfl_xor_sync(0xffffffffu, a[r], j);
          const float pb = __shfl_xor_sync(0xffffffffu, b[r], j);
          const bool asc = ((r * 32 + t) & size) == 0;
          const float lo = lower ? a[r] : pa, hi = lower ? pa : a[r];
          if (asc ? (hi < lo) : (hi > lo)) {
            a[r] = pa;
            b[r] = pb;
          }
        }
      }
    }
  }
}

// A lane's column of n32 rows (32 to 32 * N, a power of 2) at cs / ce,
// sorted in place by one warp: the least register sort that holds it.
template <int N>
__device__ __forceinline__ void sort_column(float* cs, float* ce, int n32, int t) {
  if constexpr (N > 1) {
    if (n32 <= 16 * N) {
      sort_column<N / 2>(cs, ce, n32, t);
      return;
    }
  }
  float a[N], b[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    a[r] = cs[r * 32 + t];
    b[r] = ce[r * 32 + t];
  }
  warp_bitonic<N>(a, b, t);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < N; ++r) {
    cs[r * 32 + t] = a[r];
    ce[r * 32 + t] = b[r];
  }
}

// sort = 1: bw lanes a block, each lane's column of S <= Sv = 32 * N rows
// at stride Sv + 1 in dynamic shared memory, s then e.  A lane's warp moves
// its rows with s < 2e20 to the column's front (the others are never
// breaks and, sorted, come after them all: only their e counts, in the
// last exit's max) and sorts those n rows, padded to a power of 2 of at
// least 32, in registers; the segments then sweep the n rows.
template <int N>
__global__ void __launch_bounds__(kThreads)
sweep_sort_select_kernel(const float* __restrict__ s, const float* __restrict__ e, int S,
                         const float* __restrict__ t0, const float* __restrict__ t1, int L,
                         int B, int bw, float eps, float* __restrict__ t_star,
                         uint8_t* __restrict__ entering, int* __restrict__ m_start,
                         int* __restrict__ m_end, uint8_t* __restrict__ found) {
  constexpr int SV = 32 * N, XS = SV + 1;
  extern __shared__ float sh[];
  __shared__ Red red;
  __shared__ int kept[32];                      // a lane's rows with s < 2e20
  __shared__ float dropped[32];                 // the max of the others' e
  float* ss = sh;
  float* se = sh + (size_t)bw * XS;
  const int g = kThreads / bw;
  const int x = threadIdx.x % bw, y = threadIdx.x / bw;
  const size_t lane0 = (size_t)blockIdx.x * bw;
  const int lane = (int)lane0 + x;
  const int live = B - (int)lane0 < bw ? B - (int)lane0 : bw;
#pragma unroll 8
  for (int i = threadIdx.x; i < S * bw; i += kThreads) {
    const int k = i / bw, xx = i % bw;
    const bool in = xx < live;
    ss[xx * XS + k] = in ? s[(size_t)k * B + lane0 + xx] : kPad;
    se[xx * XS + k] = in ? e[(size_t)k * B + lane0 + xx] : kNeg;
  }
  if (threadIdx.x < 32) {
    kept[threadIdx.x] = 0;
    dropped[threadIdx.x] = kNeg;
  }
  __syncthreads();
  const int t = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < live; l += kThreads / 32) {
    float* cs = ss + l * XS;
    float* ce = se + l * XS;
    float a[N], b[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {                // rows past S: padding, never kept
      const bool in = r * 32 + t < S;
      a[r] = in ? cs[r * 32 + t] : kPad;
      b[r] = in ? ce[r * 32 + t] : kNeg;
    }
    __syncwarp();
    int n = 0;
    float drop = kNeg;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r * 32 >= S) break;
      const bool keep = a[r] < ptx_sweep::kFound;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int pos = n + __popc(m & ((1u << t) - 1u));
        cs[pos] = a[r];
        ce[pos] = b[r];
      } else {
        drop = fmaxf(drop, b[r]);
      }
      n += __popc(m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) drop = fmaxf(drop, __shfl_xor_sync(0xffffffffu, drop, o));
    if (n > 0) {
      int n32 = 32;
      while (n32 < n) n32 <<= 1;
      for (int k = n + t; k < n32; k += 32) {
        cs[k] = kPad;
        ce[k] = kNeg;
      }
      __syncwarp();
      sort_column<N>(cs, ce, n32, t);
    }
    if (t == 0) {
      kept[l] = n;
      dropped[l] = drop;
    }
  }
  __syncthreads();
  float P = kNeg, te = kPad, tx = kPad;
  sweep_rows(ss, se, XS, 1, kept[x], g, x, y, bw, eps, red, P, te, tx);
  P = fmaxf(P, dropped[x]);
  select_and_write(t0, t1, L, B, lane, g, x, y, bw, eps, red, P, te, tx, t_star, entering,
                   m_start, m_end, found);
}

template <int BW>
int launch_sorted(const float* s, const float* e, int S, const float* t0, const float* t1,
                  int L, int B, float eps, float* t_star, uint8_t* entering, int* m_start,
                  int* m_end, uint8_t* found, cudaStream_t st) {
  const int blocks = (B + BW - 1) / BW;
  sweep_select_kernel<BW><<<blocks, kThreads, 0, st>>>(s, e, S, t0, t1, L, B, eps, t_star,
                                                       entering, m_start, m_end, found);
  return (int)cudaGetLastError();
}

template <int N>
int launch_sort(const float* s, const float* e, int S, const float* t0, const float* t1,
                int L, int B, float eps, int bw, float* t_star, uint8_t* entering,
                int* m_start, int* m_end, uint8_t* found, cudaStream_t st) {
  const int smem = (int)(2 * sizeof(float) * (size_t)bw * (32 * N + 1));
  static int opted = 48 * 1024;                 // the opt-in, once per size
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_sort_select_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const int blocks = (B + bw - 1) / bw;
  sweep_sort_select_kernel<N><<<blocks, kThreads, smem, st>>>(
      s, e, S, t0, t1, L, B, bw, eps, t_star, entering, m_start, m_end, found);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.  bw is
// the tile's lanes, a power of 2: 32, 16 or 8 with sort = 0, where (s, e)
// must be sorted by s along rows; at most 32 with sort = 1, where they are
// sorted here in columns of Sp rows (a power of 2, S <= Sp <= 1024) whose
// tile fits kSortTileBytes.
extern "C" int ptx_sweep_select(const float* s, const float* e, int S, const float* t0,
                                const float* t1, int L, int B, float eps, int sort, int Sp,
                                int bw, float* t_star, uint8_t* entering, int* m_start,
                                int* m_end, uint8_t* found, void* stream) {
  if (S < 1 || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!sort) {
    auto go = bw == 32 ? &launch_sorted<32> : bw == 16 ? &launch_sorted<16>
            : bw == 8 ? &launch_sorted<8> : nullptr;
    if (go == nullptr) return (int)cudaErrorInvalidValue;
    return go(s, e, S, t0, t1, L, B, eps, t_star, entering, m_start, m_end, found, st);
  }
  const int sv = Sp < 32 ? 32 : Sp;
  if (Sp < S || (Sp & (Sp - 1)) != 0 || sv > kMaxSortRows || bw < 1 || bw > 32 ||
      (bw & (bw - 1)) != 0 || 2 * sizeof(float) * bw * (sv + 1) > (size_t)kSortTileBytes)
    return (int)cudaErrorInvalidValue;
  auto go = sv == 32 ? &launch_sort<1> : sv == 64 ? &launch_sort<2>
          : sv == 128 ? &launch_sort<4> : sv == 256 ? &launch_sort<8>
          : sv == 512 ? &launch_sort<16> : &launch_sort<32>;
  return go(s, e, S, t0, t1, L, B, eps, bw, t_star, entering, m_start, m_end, found, st);
}
