// Image-gather transpose kernels for NVIDIA Hopper (sm_90a):
//   d_img[y, x, c] = sum over lanes with inb of ct[lane, c] where (yi, xi) = (y, x)
// for an (H, W, C) float32 image, the backward of the nearest-texel gather.
// Two kernels' entry points, routed by image size in ptx_torch/ops/imagegrad.py
// hist:
//
// K3, for images whose H*W*C floats fit one block's shared memory (at most
// 227 KB).  Replaces ptx/ops/imagegrad.py:91 _build_hist / _hist_kernel
// (:45), the Pallas TPU kernel that built one-hot matrices for the MXU with a
// hi/lo bf16 split; that is a TPU workaround and is not carried over.
// - Bound (chip_smoke.py bound_k3): every lane's inb (1 B), the C floats
//   of cotangent of an in-bounds lane and the two int64 indices of a lane
//   that adds (in bounds, a nonzero cotangent); the output is written once.
//   A train step's widest sky input (4,194,304 lanes, 218,852 adding) is
//   about 11 MB, some 3.4 us at 3.35 TB/s.  One add per channel of an
//   in-bounds lane.  What limits it instead is the launch and host work at
//   chunk width, and at train width the contention of many lanes on few
//   texels (the demo's 64x128 sky, config 4's 8x8 checker).
// - Both regimes first merge the lanes of a warp that add into one texel
//   (__match_any_sync on the texel, a shuffle tree to the group's lowest
//   lane, sum_peers in hist_warp.cuh, which K7's backward shares), so
//   each warp issues one add per distinct texel it touches; lanes with inb
//   false or an all-zero cotangent add nothing and load no index.
// - Direct (hist_direct_kernel; fewer than 1,024 lanes per image entry: the
//   demo's sky at every width): one pass, the leader of each group adds
//   straight into the output in device memory (128 KB: it stays in L2),
//   with one 16-byte atomic at C = 4 (atomicAdd(float4*, float4), a
//   red.global.add.v4.f32: REDG.E.ADD.F32x4.FTZ, which flushes a subnormal
//   sum, below 1.2e-38, to 0), else one scalar atomic per nonzero channel.
//   The grid covers every lane, at most four blocks an SM.
// - Private (hist_private_kernel; 1,024 lanes per image entry or more:
//   config 4's 8x8 checker): the sums are privatised in shared memory, one
//   copy of the image a block; a leader adds with scalar shared-memory
//   atomics, and after a block barrier the block adds its nonzero texels to
//   the output, with 16-byte atomics at C = 4.  As many blocks an SM as
//   their copies leave room for, at most four (four for the checker's 1 KB).
// - The plan (imagegrad.k3_plan) rests on chip_smoke.py phase 10, the
//   wrapper back to back in each regime (NVIDIA H100 80GB HBM3 at 700 W):
//   - a train step's widest sky input (4,194,304 lanes, 218,852 adding on
//     6,232 texels, 1.82 distinct texels a warp, 128 lanes an entry):
//     direct 0.0391 ms, private 0.1069 ms (one 128 KB copy a block, one
//     block an SM);
//   - config 4's widest checker input (4,194,304 lanes, 2,527,518 adding on
//     26 texels, 1.52 a warp, 16,384 an entry): private 0.0510 ms, direct
//     0.0877 ms, K8's pass without the warp merge 1.6972 ms;
//   - the demo chunk (65,536 lanes, 29,908 adding on 1,433 texels, 2.37 a
//     warp, 2 an entry): every variant 0.014-0.019 ms, the host's time.
//   So the copy pays only where lanes crowd onto few entries; 1,024 lanes
//   an entry lies between the two measured densities.  Splitting the copy
//   over a thread-block cluster of 2, 4 or 8 blocks (distributed shared
//   memory, each texel flushed once a cluster) was measured in the same
//   runs and never paid where the plan routes: 0.0621-0.1157 ms on the
//   checker; on the sky 0.0540-0.0723 ms, still slower than direct.  So
//   each block holds a whole copy.
// - Host work: at the demo chunk's width the card's work is ~2 us and the
//   call is host-bound, so the wrapper allocates the output uninitialised
//   and the direct regime zero-fills it in its one cooperative launch, a
//   grid barrier between the zeros and the adds, with no memset call before
//   it; the private regime, which runs at widths where the card's work
//   dominates, memsets it first.  The device's shared-memory limit is read,
//   and the private kernels opted in to it, once per process and device.
//
// K8, hist_atomic_kernel, for every larger image (the 1536x3072x4 probe sky
// is 75.5 MB).  Replaces ptx/ops/imagegrad.py:218 _build_banded_hist /
// _binned_kernel (:156, pallas_call :274).
// - Why no sort: the TPU has no scatter-add, so the JAX package sorts the
//   lanes into 64x512 image blocks outside Pallas (imagegrad.py:229-256) and
//   each grid step owns one block.  Hopper adds into device memory with
//   atomics, 16 bytes at once since sm_90 (atomicAdd(float4*, float4), a
//   red.global.add.v4.f32), so the lanes need no order: one thread per lane
//   adds its C cotangents straight into its texel of the output.
// - Bound: bound_k3's count, as for K3: every lane's inb, the C floats of
//   an in-bounds lane's cotangent, the two int64 indices of a lane that
//   adds, plus one write of the image (75.5 MB for the probe, 23 us at
//   3.35 TB/s, before the lanes).  The wrapper zero-fills the output (one
//   memset); the adds land in the 50 MB L2 as atomics, scattered over 4.7 M
//   texels.
// - Design: one thread per lane in a grid-stride loop; lanes with inb false
//   or an all-zero cotangent make no atomic; at C = 4 (a 16-byte aligned ct)
//   one 16-byte load and one vector atomic a lane (it compiles to
//   REDG.E.ADD.F32x4.FTZ: a subnormal sum, below 1.2e-38, is flushed to 0),
//   else scalar loads and one atomicAdd per nonzero channel.  No scratch, no
//   shared memory, no sort, no row table.  Summing the lanes of a warp that
//   hit the same texel first (__match_any_sync, then shuffles) was measured
//   slower on the probe's lanes (0.1250 against 0.1158 ms a call, NVIDIA
//   H100 80GB HBM3 at 700 W) and is not done.

// Float atomics add in a varying order, so both results vary in the last
// bits from run to run: a texel of n lanes is within the reordered-sum
// bound 2*n*2^-24*sum|ct| of the exact sum, the tolerance the checks use.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_warp.cuh"

namespace cg = cooperative_groups;

namespace {

using ptx_hist::add4;
using ptx_hist::kFull;
using ptx_hist::nonzero;
using ptx_hist::sum_peers;

constexpr int kThreads = 512;
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;

// Channels c0 .. c0 + 3 of lane `lane`'s cotangent, 0 past C; kVec: C = 4 and
// ct on a 16-byte boundary, one 16-byte load.
template <bool kVec>
__device__ __forceinline__ float4 load_ct(const float* __restrict__ ct, int lane, int C,
                                          int c0) {
  if (kVec) return reinterpret_cast<const float4*>(ct)[lane];
  const float* r = ct + (size_t)lane * C + c0;
  const int n = C - c0;
  return make_float4(r[0], n > 1 ? r[1] : 0.f, n > 2 ? r[2] : 0.f, n > 3 ? r[3] : 0.f);
}

// Lane `lane`'s texel y * W + x and its first four channels in v, or -1 when
// the lane adds nothing: past N, inb false or, at C <= 4, a zero cotangent.
// The indices are loaded only for a lane that adds.
template <bool kVec>
__device__ __forceinline__ int lane_texel(const int64_t* __restrict__ yi,
                                          const int64_t* __restrict__ xi,
                                          const uint8_t* __restrict__ inb,
                                          const float* __restrict__ ct, long long lane,
                                          int N, int W, int C, float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane >= N || !inb[lane]) return -1;
  v = load_ct<kVec>(ct, (int)lane, C, 0);
  if (C <= kMaxC && !nonzero(v)) return -1;
  return (int)yi[lane] * W + (int)xi[lane];       // < 2^31: the entry checks
}

// The lane loop both K3 regimes share: warps walk the lanes 32 at a time
// (a grid-stride loop over warps, so the trip count is warp-uniform); each
// group of lanes with one texel is summed into its leader, which calls
// add(texel, c0, v) per group of four channels.
template <bool kVec, typename Add>
__device__ __forceinline__ void for_each_texel_sum(
    const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
    const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N, int W, int C,
    Add add) {
  const int lid = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x - lid; base < N;
       base += stride) {
    const long long lane = base + lid;
    float4 v;
    const int t = lane_texel<kVec>(yi, xi, inb, ct, lane, N, W, C, v);
    if (__ballot_sync(kFull, t >= 0) == 0u) continue;
    const unsigned peers = __match_any_sync(kFull, t);
    const unsigned group = t >= 0 ? peers : 1u << lid;
    const bool lead = t >= 0 && lid == __ffs(peers) - 1;
    for (int c0 = 0;;) {
      v = sum_peers(group, lid, v);
      if (lead) add(t, c0, v);
      c0 += kMaxC;
      if (c0 >= C) break;
      v = t >= 0 ? load_ct<false>(ct, (int)lane, C, c0) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// K3, direct regime: the output zero-filled by the grid, a grid-wide barrier
// (a cooperative launch: every block is resident, at most four an SM, which
// the launch bounds keep within the SM's registers), then the warp-merged
// sums straight into it.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
hist_direct_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                   const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                   int W, int C, int entries, float* __restrict__ out) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < entries; i += gridDim.x * kThreads)
    out[i] = 0.f;
  cg::this_grid().sync();
  for_each_texel_sum<kVec>(yi, xi, inb, ct, N, W, C, [&](int t, int c0, float4 v) {
    add4<kVec>(out + (size_t)t * C + c0, v, C - c0);
  });
}

// K3, private regime: the warp-merged sums into the block's private copy
// of the image in shared memory, then its nonzero texels into the output.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_private_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                    const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                    int W, int C, int texels, float* __restrict__ out) {
  extern __shared__ float4 s_mem[];
  float* s_hist = reinterpret_cast<float*>(s_mem);          // texels x C
  for (int i = threadIdx.x; i < texels * C; i += kThreads) s_hist[i] = 0.f;
  __syncthreads();
  for_each_texel_sum<kVec>(yi, xi, inb, ct, N, W, C, [&](int t, int c0, float4 v) {
    add4<false>(s_hist + t * C + c0, v, C - c0);
  });
  __syncthreads();                                          // every add of the block is in
  for (int j = threadIdx.x; j < texels; j += kThreads) {
    float* dst = out + (size_t)j * C;
    if (kVec) {
      const float4 v = s_mem[j];
      if (nonzero(v)) atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = s_hist[j * C + c];
        if (v != 0.f) atomicAdd(dst + c, v);
      }
    }
  }
}

// K8: one thread per lane, each adding into the output (module comment).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_atomic_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                   const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                   int W, int C, float* __restrict__ out) {
  for (int lane = blockIdx.x * kThreads + threadIdx.x; lane < N;
       lane += gridDim.x * kThreads) {
    if (!inb[lane]) continue;
    const float4 v = load_ct<kVec>(ct, lane, C, 0);
    if (!nonzero(v)) continue;
    add4<kVec>(out + ((int)yi[lane] * W + (int)xi[lane]) * C, v, C);   // < 2^31: the entry checks
  }
}

// Per device, read and set once per process: the opt-in shared memory of a
// block, to which the private kernels are opted in (0: not yet).
int g_smem_optin[kMaxDevices];

int opt_in_private(int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_smem_optin[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hist_private_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hist_private_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    g_smem_optin[dev] = optin;
  }
  *smem_optin = g_smem_optin[dev];
  return (int)cudaSuccess;
}

}  // namespace

// C entry point of K3 (ctypes): fills `out` (H*W*C floats, uninitialised)
// on `stream`, no synchronisation; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.  private_copy 0 is
// the direct regime: one cooperative launch of `blocks` blocks (at most four
// an SM) that zero-fills `out` itself.  private_copy 1 is the private
// regime: a memset of `out`, then one launch of `blocks` blocks, each with
// its copy of the image in shared memory.  The wrapper chooses both
// (imagegrad.k3_plan).
extern "C" int ptx_image_hist(const int64_t* yi, const int64_t* xi, const uint8_t* inb,
                              const float* ct, int N, int H, int W, int C, float* out,
                              int private_copy, int blocks, void* stream) {
  const long long entries = (long long)H * W * C;
  if (N < 1 || H < 1 || W < 1 || C < 1 || entries >= (1LL << 31) || private_copy < 0 ||
      private_copy > 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = C == 4 && ((uintptr_t)ct & 15) == 0 && ((uintptr_t)out & 15) == 0;
  if (!private_copy) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        vec ? cudaLaunchKernelEx(&cfg, hist_direct_kernel<true>, yi, xi, inb, ct, N, W, C,
                                 (int)entries, out)
            : cudaLaunchKernelEx(&cfg, hist_direct_kernel<false>, yi, xi, inb, ct, N, W, C,
                                 (int)entries, out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  int smem_optin = 0;
  const int opt = opt_in_private(&smem_optin);
  if (opt != (int)cudaSuccess) return opt;
  const size_t smem = sizeof(float) * (size_t)entries;
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(out, 0, smem, s);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    hist_private_kernel<true><<<blocks, kThreads, smem, s>>>(yi, xi, inb, ct, N, W, C,
                                                             H * W, out);
  else
    hist_private_kernel<false><<<blocks, kThreads, smem, s>>>(yi, xi, inb, ct, N, W, C,
                                                              H * W, out);
  return (int)cudaGetLastError();
}

// C entry point of K8 (ctypes): one launch on `stream` adding into `out`
// (zeroed by the caller), no synchronisation; returns cudaGetLastError(),
// or cudaErrorInvalidValue for C past 4 or an image of 2^31 floats or more.
extern "C" int ptx_image_hist_atomic(const int64_t* yi, const int64_t* xi,
                                     const uint8_t* inb, const float* ct, int N, int H,
                                     int W, int C, float* out, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC ||
      (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int blocks = (N + kThreads - 1) / kThreads;
  blocks = blocks < 4 * sms ? blocks : 4 * sms;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4 && ((uintptr_t)ct & 15) == 0)
    hist_atomic_kernel<true><<<blocks, kThreads, 0, s>>>(yi, xi, inb, ct, N, W, C, out);
  else
    hist_atomic_kernel<false><<<blocks, kThreads, 0, s>>>(yi, xi, inb, ct, N, W, C, out);
  return (int)cudaGetLastError();
}
