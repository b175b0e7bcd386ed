// Image-gather transpose kernels for NVIDIA Hopper (sm_90a):
//   d_img[y, x, c] = sum over lanes with inb of ct[lane, c] where (yi, xi) = (y, x)
// for an (H, W, C) float32 image, the backward of the nearest-texel gather.
// Two kernels, routed by image size in ptx_torch/ops/imagegrad.py hist:
//
// K3, hist_shared_kernel, for images whose H*W*C floats fit one block's
// shared memory (at most 227 KB, opted in above 48 KB).  Replaces
// ptx/ops/imagegrad.py:91 _build_hist / _hist_kernel (:45), the Pallas TPU
// kernel that built one-hot matrices for the MXU with a hi/lo bf16 split;
// that is a TPU workaround and is not carried over.
// - Bound: per lane it reads yi, xi (int64), inb (1 B) and C floats of
//   cotangent, 33 B at C = 4; the output is written once.  For the ~91 k
//   sky-select lanes of a 65,536-ray chunk that is ~3 MB, ~1 us at
//   3.35 TB/s.  One add per channel: bound by memory latency and by atomic
//   contention on popular texels.
// - Design: each block zeroes a private histogram, adds its share of the
//   lanes with shared-memory atomics, then adds the nonzero texels to the
//   output (zeroed by the wrapper) with global atomics.  The demo's
//   64x128x4 sky is 128 KB, one block per SM; the grid is at most one block
//   per SM and at least 4,096 lanes per block, so the flush (one global
//   atomic per touched texel per block) stays small beside the lanes.
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
// - Bound: unchanged, bound_k3's count: per lane yi, xi (int64), inb and C
//   floats of cotangent, (17 + 4C) B, plus one write of the image.  For the
//   probe's 4,194,304 sky-select lanes at C = 4 that is 138 MB + 75.5 MB,
//   64 us at 3.35 TB/s.  The wrapper zero-fills the output (one memset);
//   the adds land in the 50 MB L2 as atomics, scattered over 4.7 M texels.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinLanesPerBlock = 4096;
constexpr int kMaxC = 4;

__global__ void __launch_bounds__(kThreads)
hist_shared_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                   const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                   int W, int C, int texels, float* __restrict__ out) {
  extern __shared__ float s_hist[];
  for (int i = threadIdx.x; i < texels; i += kThreads) s_hist[i] = 0.f;
  __syncthreads();
  for (int lane = blockIdx.x * kThreads + threadIdx.x; lane < N;
       lane += gridDim.x * kThreads) {
    if (!inb[lane]) continue;
    const int base = ((int)yi[lane] * W + (int)xi[lane]) * C;
    for (int c = 0; c < C; ++c) {
      const float v = ct[(size_t)lane * C + c];
      if (v != 0.f) atomicAdd(&s_hist[base + c], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < texels; i += kThreads) {
    const float v = s_hist[i];
    if (v != 0.f) atomicAdd(&out[i], v);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_atomic_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                   const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                   int W, int C, float* __restrict__ out) {
  for (int lane = blockIdx.x * kThreads + threadIdx.x; lane < N;
       lane += gridDim.x * kThreads) {
    if (!inb[lane]) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec) {
      v = reinterpret_cast<const float4*>(ct)[lane];
    } else {
      const float* r = ct + (size_t)lane * C;
      v.x = r[0];
      if (C > 1) v.y = r[1];
      if (C > 2) v.z = r[2];
      if (C > 3) v.w = r[3];
    }
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    float* dst = out + ((int)yi[lane] * W + (int)xi[lane]) * C;   // < 2^31: the entry checks
    if (kVec) {
      atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      if (v.x != 0.f) atomicAdd(dst, v.x);
      if (C > 1 && v.y != 0.f) atomicAdd(dst + 1, v.y);
      if (C > 2 && v.z != 0.f) atomicAdd(dst + 2, v.z);
      if (C > 3 && v.w != 0.f) atomicAdd(dst + 3, v.w);
    }
  }
}

}  // namespace

// C entry point of K3 (ctypes): one launch on `stream` adding into `out`
// (zeroed by the caller), no synchronisation; returns cudaGetLastError(),
// or cudaErrorInvalidValue for an image past the block's shared memory.
extern "C" int ptx_image_hist(const int64_t* yi, const int64_t* xi, const uint8_t* inb,
                              const float* ct, int N, int H, int W, int C, float* out,
                              void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long texels = (long long)H * W * C;
  const size_t smem = sizeof(float) * (size_t)texels;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hist_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (N + kMinLanesPerBlock - 1) / kMinLanesPerBlock;
  blocks = blocks < sms ? blocks : sms;
  hist_shared_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      yi, xi, inb, ct, N, W, C, (int)texels, out);
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
