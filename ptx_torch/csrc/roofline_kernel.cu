// Roofline kernels for NVIDIA Hopper (sm_90a): the card's two ceilings that
// the port's kernels are placed against, measured by python -m
// ptx_torch.roofline.
//
// K10, the FP32 chain.  Replaces tools/roofline.py:48 measure_vpu_peak, the
// Pallas TPU kernel (body :62-68, pallas_call :69): per element, R passes of
// a 256-step unrolled chain x <- x + x*x*c.  Its plain PyTorch version is
// ptx_torch/ops/roofline_kernel.py fma_chain_reference.
// - What bounds it on this card: operations.  Each step is three dependent
//   float32 operations; built with -fmad=false (the port's flags) they issue
//   as a multiply, a multiply and an add, each rounded on its own, in the
//   plain version's order, so the result equals the plain version's bit for
//   bit.  An SM issues 128 such operations a clock: 33.5 T a second on an
//   H100 SXM at its 1.98 GHz boost, half the published 67 TFLOP/s, which
//   counts a fused multiply-add as two.
// - Design: one thread an element, x in a register, the 256 steps unrolled
//   and the R loop inside the kernel, so nothing but the first load and the
//   last store touches memory.  The TPU kept a (512, 128) block in VMEM;
//   here (8192, 128) elements give 1 M threads, 64 warps on every SM, far
//   more than the ~4 warps a sub-partition needs to hide the ~4-cycle
//   latency of the dependent chain.
//
// K11, the HBM copy.  Replaces tools/roofline.py:109 measure_hbm_bw_pallas,
// the Pallas TPU kernel (body :124-125, pallas_call :127): o = x + 1 over
// (32768, 1024) float32 (128 MiB) in 2 MiB blocks, chained R times.  Its
// plain PyTorch version is ptx_torch/ops/roofline_kernel.py
// copy_plus_one_reference.
// - What bounds it on this card: bytes, each element read once and written
//   once: 2 x 128 MiB a pass, 80 us at 3.35 TB/s.  Two such buffers exceed
//   the 50 MB L2, so a chain of passes streams from HBM.
// - Design: one 16-byte (float4) load and store a thread, as many
//   256-thread blocks as the float4s need (32,768 at 128 MiB), the first
//   n mod 4 threads also taking the last n mod 4 elements; the wrapper
//   checks that both pointers are 16-byte aligned.  A grid-stride loop over
//   as many blocks as the SMs hold at once took 0.098 ms a pass at 128 MiB
//   against this grid's 0.091 ms, with one float4 in flight a thread or
//   four, and twice or four times the blocks narrowed the gap only in part
//   (on an H100 SXM at 700 W, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 256;              // the TPU kernel's K: steps unrolled a pass
constexpr int kCopyThreads = 256;        // K11's block at most

__global__ void fma_chain_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                                 int reps, float c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) v = v + v * v * c;
  }
  o[i] = v;
}

__global__ void __launch_bounds__(kCopyThreads)
copy_plus_one_kernel(const float4* __restrict__ x4, float4* __restrict__ o4, int64_t n4,
                     const float* __restrict__ x, float* __restrict__ o, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    float4 v = x4[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    o4[i] = v;
  }
  if (i < n - 4 * n4) o[4 * n4 + i] = x[4 * n4 + i] + 1.f;   // the last n mod 4 elements
}

}  // namespace

// C entry points (ctypes): each launches on `stream`, does not synchronise,
// and returns cudaGetLastError() — nonzero when the launch was refused (a
// block of more than 1,024 threads, for one, or for K11 more than 256).

extern "C" int ptx_fma_chain(const float* x, float* o, int n, int reps, float c, int block,
                             void* stream) {
  if (n < 1 || reps < 0 || block < 1) return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(x, o, n, reps,
                                                                                c);
  return (int)cudaGetLastError();
}

extern "C" int ptx_copy_plus_one(const float* x, float* o, int64_t n, int block,
                                 void* stream) {
  if (n < 1 || block < 4) return (int)cudaErrorInvalidValue;   // the tail: 3 threads
  const int64_t n4 = n / 4;
  const int64_t blocks = n4 < block ? 1 : (n4 + block - 1) / block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  copy_plus_one_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n4, x, o, n);
  return (int)cudaGetLastError();
}
