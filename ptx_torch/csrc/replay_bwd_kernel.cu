// Row-fed replay backward (K6) for NVIDIA Hopper (sm_90a): the
// decision-frozen VJP of one wavefront bounce at any leaf count, one thread
// per lane, with the per-leaf reduction in the kernel.
//
// Replaces ptx/ops/replay_bwd.py:47 build_replay_bwd, the Pallas TPU kernel
// (a row gathered per lane in XLA, jax.vjp of replay_lane_math inside the
// kernel, an MXU one-hot contraction into per-leaf rows).  Its plain
// PyTorch version is ptx_torch/ops/bounce_kernel.py BounceBwdKernel.reference
// (bounce_bwd_lanes_reference, then fold_packed), as for K2: K6 has K2's
// contract (ptx_torch/ops/replay_bwd.py RowFedReplayBwd) without K2's
// 24-leaf cap.
//
// Per lane it reads o, d, thr, u_sel and the three carry cotangents (21
// floats), evt and four flag bytes, and writes d(o), d(d), d(thr): 128 bytes,
// as K2.  Per scene: d_packed, the cotangent of pack_bwd's vector (the L x 26
// leaf rows, then M x 8 material scalars), which the caller (trace_rays)
// sums over a call's bounces and maps to the params once.
//
// What bounds it on this card.  At 4,194,304 lanes the lane traffic is
// ~537 MB (~0.16 ms at 3.35 TB/s); the arithmetic, ~450 operations per
// continuing lane, is less.  K2's reduction owned L * 34 / 128 entries per
// thread in registers and stops at 24 leaves (72 entries a thread at 268).
// What the design does:
// - pack_bwd's vector and the static (L, 3) leaf aux (sphere, parity,
//   material id) sit in shared memory, the layout K2 reads; a lane reads its
//   leaf's row by index from evt and its material's 8 scalars through the
//   leaf's material id; the (B, 36) row gather of the TPU version (its VMEM
//   could not select per lane), ~600 MB at 4.19 M lanes, is not made;
// - the per-leaf sums also live in shared memory, (L, 34), so the leaf count
//   is bounded by shared memory only (the wrapper checks it): each block walks
//   a fixed set of 128-lane tiles; per tile the continuing lanes' 34
//   cotangents are listed in lane order, and thread c < 34 adds column c of
//   each listed lane into its leaf's entry, in that order; each block writes
//   its partial (L, 34);
// - the second launch is K2's (replay_reduce.cuh): the partials summed in a
//   fixed tree and, after a grid barrier, folded onto the materials.  No
//   atomics: the same inputs give the same bits;
// - pad and filler lanes carry evt 0, leaf 0's real row (never a zero row,
//   whose ior = 0 would put 0 * inf into the adjoint), and add nothing;
// - the kernel is opted in to more than 48 KB of shared memory once per
//   process and device, not once per call.
// Later work: a warp-level segmented reduction instead of 34 serial column
// owners; structure-of-arrays lane inputs for 16-byte loads.

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
constexpr int kStride = kCols + 1;        // odd lane stride: no bank conflicts
constexpr int kMaxDevices = 64;

__device__ __forceinline__ V3 load3(const float* p, int lane) {
  return {p[3 * lane], p[3 * lane + 1], p[3 * lane + 2]};
}

__device__ __forceinline__ void store3(float* p, int lane, V3 v) {
  p[3 * lane] = v.x;
  p[3 * lane + 1] = v.y;
  p[3 * lane + 2] = v.z;
}

__global__ void __launch_bounds__(kThreads)
replay_bwd_kernel(const float* __restrict__ scene, int scene_words, int L,
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
  float* s_acc = s_aux + 3 * L;                         // L x 34
  float* s_val = s_acc + L * kCols;                     // kThreads x kStride
  int* s_list = reinterpret_cast<int*>(s_val + kThreads * kStride);   // kThreads
  int* s_leaf = s_list + kThreads;                      // kThreads
  int* s_wcount = s_leaf + kThreads;                    // kWarps
  const int E = L * kCols;
  for (int i = threadIdx.x; i < scene_words; i += kThreads) s_scene[i] = scene[i];
  for (int i = threadIdx.x; i < 3 * L; i += kThreads) s_aux[i] = aux[i];
  for (int i = threadIdx.x; i < E; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  const int tid = threadIdx.x, wid = tid / 32, lid = tid % 32;
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
    if (tid < kCols) {
      for (int i = 0; i < n; ++i) {
        const int t = s_list[i];
        s_acc[s_leaf[t] * kCols + tid] += s_val[t * kStride + tid];
      }
    }
    __syncthreads();              // s_val / s_list are rewritten by the next tile
  }
  for (int e = tid; e < E; e += kThreads) partial[(size_t)blockIdx.x * E + e] = s_acc[e];
}

// The largest dynamic shared memory K6 has been opted in to, per device (0:
// not yet): set once per process and device to the block's limit.
int g_smem_optin[kMaxDevices];

}  // namespace

// Shared memory one block of K6 needs for a scene vector of `scene_words`
// floats and L leaves (the wrapper checks it against the card's limit).
extern "C" int ptx_replay_bwd_smem(int scene_words, int L) {
  return (int)(sizeof(float) * (scene_words + 3 * L + L * kCols + kThreads * kStride) +
               sizeof(int) * (2 * kThreads + kWarps));
}

// C entry point (ctypes), K2's (bounce_bwd_kernel.cu ptx_bounce_backward)
// without its leaf cap: two launches on `stream` (per-block partial sums,
// then their reduction into d_packed, the cotangent of the scene vector's
// L*26 + M*8 words), no synchronisation; returns cudaGetLastError().
// `partial` holds n_blocks * L * 34 floats, then L * 8 of scratch;
// mat_start (M + 1) and mat_leaves (L) list each material's leaves in
// ascending order.
extern "C" int ptx_replay_bwd(
    const float* scene, int scene_words, int L, const float* aux, const float* o,
    const float* d, const float* thr, const int* evt, const uint8_t* hit,
    const uint8_t* entering, const uint8_t* take_transmit, const uint8_t* scatter_alive,
    const float* u_sel, const float* ct_o2, const float* ct_d2, const float* ct_thr2,
    int B, float* d_o, float* d_d, float* d_thr, float* partial, int n_blocks,
    const int* mat_start, const int* mat_leaves, int M, float* d_packed, void* stream) {
  if (L < 1 || B < 1 || n_blocks < 1 || M < 0 || scene_words != L * kRow + M * kMat)
    return (int)cudaErrorInvalidValue;
  const int smem = ptx_replay_bwd_smem(scene_words, L);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_smem_optin[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(replay_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    g_smem_optin[dev] = optin;
  }
  if (smem > g_smem_optin[dev]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  replay_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(
      scene, scene_words, L, aux, o, d, thr, evt, hit, entering, take_transmit,
      scatter_alive, u_sel, ct_o2, ct_d2, ct_thr2, B, d_o, d_d, d_thr, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce_partials(partial, n_blocks, L, M, mat_start, mat_leaves, d_packed, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
