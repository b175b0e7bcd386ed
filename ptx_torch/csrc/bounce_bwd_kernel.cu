// Replay backward kernel (K2) for NVIDIA Hopper (sm_90a): the decision-frozen
// VJP of one wavefront bounce, one thread per lane.
//
// Replaces ptx/ops/bounce_kernel.py:578 build_bounce_bwd_kernel, the Pallas
// TPU kernel that ran jax.vjp on replay_lane_math inside its body.  Here the
// adjoint is written by hand (replay_lane.cuh).  Its plain PyTorch version is
// ptx_torch/ops/bounce_kernel.py BounceBwdKernel.reference (autograd through
// replay_lane_math, then the per-material fold below).
//
// Per lane: reads o, d, thr, u_sel and the three carry cotangents (21 floats),
// evt and four flag bytes (8 bytes); writes d(o), d(d), d(thr) (9 floats):
// 128 bytes.  Per scene: d_packed, the cotangent of pack_bwd's vector (the
// L x 26 leaf rows, then M x 8 material scalars).
//
// What bounds it on this card.  At B = 65,536 the lane traffic is ~8.4 MB,
// ~2.5 us at 3.35 TB/s, and the arithmetic ~400 float operations per lane,
// ~0.4 us at 67 TFLOP/s: far below a launch.  So the kernel is latency- and
// register-bound: one long dependent chain per thread (forward replay, then
// the reverse sweep) and a block reduction per tile.  Its device time is
// ~5.8x the bound.  What the design does:
// - the scene (pack_bwd: L*26 + M*8 floats) and the per-leaf kind, parity and
//   material sit in shared memory; a lane reads its leaf's row by index from
//   evt (the Pallas kernel's one-hot select chain existed for the TPU's vector
//   unit);
// - lanes that do not continue return after three copies, so deep bounces,
//   mostly dead or filler lanes, cost little;
// - the per-leaf reduction is deterministic, in two passes, with no atomics:
//   each block walks a fixed set of 128-lane tiles; per tile the continuing
//   lanes' 34 cotangents go to shared memory, listed in lane order, and the
//   thread that owns entry (leaf, column) adds them up in that order into a
//   register; each block writes its partial sums, and a second launch sums
//   the partials of every entry in a fixed tree.  The same inputs give the
//   same bits;
// - the second launch (replay_reduce.cuh, shared with K6) writes the scene
//   vector's cotangent itself: the leaf rows' entries, and, after a grid
//   barrier, each material's entries as the sum of its leaves' material
//   columns in ascending leaf order (the JAX package's one-hot leaf ->
//   material product, done here in the reduction).  The wrapper so
//   hands autograd one vector per bounce, and the caller (trace_rays) maps
//   the sum over bounces to the params once per call, through the packing's
//   VJP, in place of a params mapping per bounce.
// Later work: structure-of-arrays inputs for 16-byte loads; a warp-level
// segmented reduction instead of the owned-entry loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "replay_lane.cuh"
#include "replay_reduce.cuh"

namespace {

using ptx_replay::kCols;
using ptx_replay::kMat;
using ptx_replay::kRow;
using ptx_replay::V3;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 24;
constexpr int kMaxOwned = (kMaxLeaves * kCols + kThreads - 1) / kThreads;
constexpr int kStride = kCols + 1;        // odd lane stride: no bank conflicts

__device__ __forceinline__ V3 load3(const float* p, int lane) {
  return {p[3 * lane], p[3 * lane + 1], p[3 * lane + 2]};
}

__device__ __forceinline__ void store3(float* p, int lane, V3 v) {
  p[3 * lane] = v.x;
  p[3 * lane + 1] = v.y;
  p[3 * lane + 2] = v.z;
}

__global__ void __launch_bounds__(kThreads)
bounce_bwd_kernel(const float* __restrict__ scene, int scene_words, int L,
                  const float* __restrict__ aux, const float* __restrict__ o_in,
                  const float* __restrict__ d_in, const float* __restrict__ thr_in,
                  const int* __restrict__ evt_in, const uint8_t* __restrict__ hit_in,
                  const uint8_t* __restrict__ entering_in,
                  const uint8_t* __restrict__ transmit_in,
                  const uint8_t* __restrict__ scatter_in,
                  const float* __restrict__ u_sel_in, const float* __restrict__ ct_o2,
                  const float* __restrict__ ct_d2, const float* __restrict__ ct_t2, int B,
                  float* __restrict__ d_o, float* __restrict__ d_d,
                  float* __restrict__ d_thr, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* s_scene = smem;                                // scene_words
  float* s_aux = s_scene + scene_words;                 // L x (sphere, parity, material)
  float* s_val = s_aux + 3 * L;                         // kThreads x kStride
  int* s_list = reinterpret_cast<int*>(s_val + kThreads * kStride);   // kThreads
  int* s_leaf = s_list + kThreads;                      // kThreads
  int* s_wcount = s_leaf + kThreads;                    // kWarps
  for (int i = threadIdx.x; i < scene_words; i += kThreads) s_scene[i] = scene[i];
  for (int i = threadIdx.x; i < 3 * L; i += kThreads) s_aux[i] = aux[i];
  __syncthreads();

  const int E = L * kCols;
  const int tid = threadIdx.x, wid = tid / 32, lid = tid % 32;
  float acc[kMaxOwned];
#pragma unroll
  for (int j = 0; j < kMaxOwned; ++j) acc[j] = 0.f;

  const int n_tiles = (B + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int lane = tile * kThreads + tid;
    int leaf = -1;
    if (lane < B) {
      const int evt = evt_in[lane];
      const int k = evt >= L ? evt - L : evt;
      const float* a = s_aux + 3 * k;
      const float* row = s_scene + kRow * k;
      const float* ms = s_scene + kRow * L + kMat * (int)a[2];
      float* g = s_val + tid * kStride;
      V3 go, gd, gt;
      const bool contrib = ptx_replay::replay_lane_vjp(
          row, ms, a[0] != 0.f, a[1], evt < L, hit_in[lane] != 0, entering_in[lane] != 0,
          transmit_in[lane] != 0, scatter_in[lane] != 0, load3(o_in, lane),
          load3(d_in, lane), load3(thr_in, lane), load3(u_sel_in, lane),
          load3(ct_o2, lane), load3(ct_d2, lane), load3(ct_t2, lane), go, gd, gt, g,
          g + kRow);
      store3(d_o, lane, go);
      store3(d_d, lane, gd);
      store3(d_thr, lane, gt);
      if (contrib) leaf = k;
    }
    // list the continuing lanes in lane order (warp ballots, no atomics)
    const unsigned ballot = __ballot_sync(0xffffffffu, leaf >= 0);
    if (lid == 0) s_wcount[wid] = __popc(ballot);
    s_leaf[tid] = leaf;
    __syncthreads();
    int base = 0, n = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += w < wid ? s_wcount[w] : 0;
      n += s_wcount[w];
    }
    if (leaf >= 0) s_list[base + __popc(ballot & ((1u << lid) - 1u))] = tid;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOwned; ++j) {
      const int e = tid + j * kThreads;
      if (e < E) {
        const int k = e / kCols, c = e - k * kCols;
        float sum = acc[j];
        for (int i = 0; i < n; ++i) {
          const int t = s_list[i];
          if (s_leaf[t] == k) sum += s_val[t * kStride + c];
        }
        acc[j] = sum;
      }
    }
    __syncthreads();              // s_val / s_list are rewritten by the next tile
  }
#pragma unroll
  for (int j = 0; j < kMaxOwned; ++j) {
    const int e = tid + j * kThreads;
    if (e < E) partial[(size_t)blockIdx.x * E + e] = acc[j];
  }
}

}  // namespace

// Shared memory one block of K2 needs for a scene buffer of `scene_words`
// floats and L leaves (the wrapper checks it against the card's limit).
extern "C" int ptx_bounce_backward_smem(int scene_words, int L) {
  return (int)(sizeof(float) * (scene_words + 3 * L + kThreads * kStride) +
               sizeof(int) * (2 * kThreads + kWarps));
}

// C entry point (ctypes): two launches on `stream` (per-block partial sums,
// then their reduction into d_packed, the cotangent of the scene vector's
// L*26 + M*8 words), no synchronisation; returns cudaGetLastError().
// `partial` holds n_blocks * L * 34 floats, then L * 8 of scratch;
// mat_start (M + 1) and mat_leaves (L) list each material's leaves in
// ascending order.
extern "C" int ptx_bounce_backward(
    const float* scene, int scene_words, int L, const float* aux, const float* o,
    const float* d, const float* thr, const int* evt, const uint8_t* hit,
    const uint8_t* entering, const uint8_t* take_transmit, const uint8_t* scatter_alive,
    const float* u_sel, const float* ct_o2, const float* ct_d2, const float* ct_thr2,
    int B, float* d_o, float* d_d, float* d_thr, float* partial, int n_blocks,
    const int* mat_start, const int* mat_leaves, int M, float* d_packed, void* stream) {
  if (L < 1 || L > kMaxLeaves || B < 1 || n_blocks < 1 || M < 0 ||
      scene_words != L * kRow + M * kMat)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ptx_bounce_backward_smem(scene_words, L);
  cudaStream_t s = (cudaStream_t)stream;
  bounce_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(
      scene, scene_words, L, aux, o, d, thr, evt, hit, entering, take_transmit,
      scatter_alive, u_sel, ct_o2, ct_d2, ct_thr2, B, d_o, d_d, d_thr, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce_partials(partial, n_blocks, L, M, mat_start, mat_leaves, d_packed, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
