// Image-gather transpose kernel (K3) for NVIDIA Hopper (sm_90a):
//   d_img[y, x, c] = sum over lanes with inb of ct[lane, c] where (yi, xi) = (y, x)
// for an (H, W, C) float32 image, the backward of the nearest-texel gather.
//
// Replaces ptx/ops/imagegrad.py:91 _build_hist / _hist_kernel (:45), the Pallas
// TPU kernel that built one-hot matrices for the MXU with a hi/lo bf16 split;
// that is a TPU workaround and is not carried over.  Its plain PyTorch version
// is ptx_torch/ops/imagegrad.py hist_reference; the wrapper is HistKernel.
//
// What bounds it on this card.  Per lane it reads yi, xi (int64), inb (1 B)
// and C floats of cotangent: 33 B at C = 4; the output is written once.  For
// the ~91 k sky-select lanes of a 65,536-ray chunk that is ~3 MB, ~1 us at
// 3.35 TB/s.  The arithmetic is one add per channel, so the kernel is bound by
// memory latency and by atomic contention on popular texels.
//
// Design.
// - Images whose H*W*C floats fit a block's shared memory (at most 227 KB,
//   opted in above 48 KB) take the shared path: each block zeroes a private
//   histogram, adds its share of the lanes with shared-memory atomics, then
//   adds the nonzero texels to the output with global atomics.  The demo's
//   64x128x4 sky is 128 KB, one block per SM; the grid is at most one block
//   per SM and at least 4,096 lanes per block, so the flush (one global atomic
//   per touched texel per block) stays small beside the lanes.
// - Larger images take the global path: every lane adds straight into the
//   output (L2-resident up to the TPU kernel's 8 MB eligibility).
// - The wrapper zeroes the output.  Float atomics add in a varying order, so
//   the result varies in the last bits from run to run: a texel's error is
//   bounded by its sum of |ct| times a few ulps, the tolerance the checks use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinLanesPerBlock = 4096;

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

__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const int64_t* __restrict__ yi, const int64_t* __restrict__ xi,
                   const uint8_t* __restrict__ inb, const float* __restrict__ ct, int N,
                   int W, int C, float* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= N || !inb[lane]) return;
  const size_t base = ((size_t)yi[lane] * W + (size_t)xi[lane]) * C;
  for (int c = 0; c < C; ++c) {
    const float v = ct[(size_t)lane * C + c];
    if (v != 0.f) atomicAdd(&out[base + c], v);
  }
}

}  // namespace

// C entry point (ctypes): one launch on `stream` adding into `out` (zeroed by
// the caller), no synchronisation; returns cudaGetLastError().  Sets
// *used_shared to 1 when the shared-memory path ran.
extern "C" int ptx_image_hist(const int64_t* yi, const int64_t* xi, const uint8_t* inb,
                              const float* ct, int N, int H, int W, int C, float* out,
                              int* used_shared, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, smem_max = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long texels = (long long)H * W * C;
  const size_t smem = sizeof(float) * (size_t)texels;
  if (smem <= (size_t)smem_max) {
    cudaError_t err = cudaFuncSetAttribute(
        hist_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = (N + kMinLanesPerBlock - 1) / kMinLanesPerBlock;
    blocks = blocks < sms ? blocks : sms;
    hist_shared_kernel<<<blocks, kThreads, smem, s>>>(yi, xi, inb, ct, N, W, C,
                                                      (int)texels, out);
    *used_shared = 1;
  } else {
    hist_global_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        yi, xi, inb, ct, N, W, C, out);
    *used_shared = 0;
  }
  return (int)cudaGetLastError();
}
