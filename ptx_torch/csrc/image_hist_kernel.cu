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
// K8, hist_banded_kernel, for every larger image (the 1536x3072x4 probe sky
// is 75.5 MB).  Replaces ptx/ops/imagegrad.py:218 _build_banded_hist /
// _binned_kernel (:156, pallas_call :274).
// - Bound: the output, written once (75.5 MB for the probe: 22.5 us at
//   3.35 TB/s), plus (2 + C) floats per lane of the sorted rows.
// - Design: the wrapper sorts the lanes by image block (bin id per lane,
//   skipped lanes last, a stable argsort, searchsorted for the per-block
//   offsets, one packed row gather), as the JAX package does outside Pallas.
//   One block per image block of kBH x kBW texels zeroes its tile in shared
//   memory, walks its contiguous lane range with all threads adding by
//   shared-memory atomics, and writes its tile once.  Every texel is owned by
//   exactly one block: no global atomics and no separate zero-fill of the
//   output.  The TPU's 64x512 block is 512 KB at C = 4, over the 227 KB a
//   block can have; 32x256 is 128 KB at C = 4 (96 KB at C = 3), which leaves
//   one block per SM and 576 blocks for the probe (4.4 waves on 132 SMs).
//
// Float atomics add in a varying order, so both results vary in the last
// bits from run to run: a texel's error is bounded by its sum of |ct| times
// a few ulps, the tolerance the checks use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinLanesPerBlock = 4096;
constexpr int kBH = 32;         // K8's image block: kBH x kBW texels (BLOCK_H,
constexpr int kBW = 256;        // BLOCK_W in ptx_torch/ops/imagegrad.py)
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

// rows: (n, 2 + C) float32 sorted by image block, [y, x, ct_0 .. ct_{C-1}];
// offs: (n_by * n_bx + 1) lane offsets of the blocks in that order.
__global__ void __launch_bounds__(kThreads)
hist_banded_kernel(const float* __restrict__ rows, const int* __restrict__ offs, int H,
                   int W, int C, int n_bx, float* __restrict__ out) {
  extern __shared__ float s_tile[];                 // kBH x kBW x C
  const int b = blockIdx.x;
  const int y0 = (b / n_bx) * kBH, x0 = (b % n_bx) * kBW;
  const int tile = kBH * kBW * C;
  for (int i = threadIdx.x; i < tile; i += kThreads) s_tile[i] = 0.f;
  __syncthreads();
  const int lo = offs[b], hi = offs[b + 1];
  const int stride = 2 + C;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float* r = rows + (size_t)i * stride;
    const int base = (((int)r[0] - y0) * kBW + ((int)r[1] - x0)) * C;
    for (int c = 0; c < C; ++c) {
      const float v = r[2 + c];
      if (v != 0.f) atomicAdd(&s_tile[base + c], v);
    }
  }
  __syncthreads();
  const int rows_in = min(kBH, H - y0), cols_in = min(kBW, W - x0);
  const int row_words = cols_in * C;
  for (int i = threadIdx.x; i < rows_in * row_words; i += kThreads) {
    const int ty = i / row_words, rest = i - ty * row_words;
    out[((size_t)(y0 + ty) * W + x0) * C + rest] = s_tile[ty * kBW * C + rest];
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

// C entry point of K8 (ctypes): one launch on `stream` writing every texel of
// `out` (no zero-fill needed), no synchronisation; returns
// cudaGetLastError().
extern "C" int ptx_image_hist_banded(const float* rows, const int* offs, int H, int W,
                                     int C, float* out, void* stream) {
  if (H < 1 || W < 1 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int n_by = (H + kBH - 1) / kBH, n_bx = (W + kBW - 1) / kBW;
  const int smem = (int)sizeof(float) * kBH * kBW * C;
  cudaError_t err = cudaFuncSetAttribute(
      hist_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  hist_banded_kernel<<<n_by * n_bx, kThreads, smem, (cudaStream_t)stream>>>(
      rows, offs, H, W, C, n_bx, out);
  return (int)cudaGetLastError();
}

