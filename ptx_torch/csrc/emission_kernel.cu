// Fused emission kernel (K7) for NVIDIA Hopper (sm_90a): one dynamic emissive
// chain ([transform] -> [multiply] -> spherical or mirror-ball map -> image)
// plus the constant emissive row of every other material, forward and
// backward, one launch each.
//
// Replaces ptx/ops/emission_kernel.py:98 build_emission_fn (kernel :125,
// pallas_call :263) and its custom VJP bwd2 (:346-388).  The plain versions
// are ptx_torch/ops/emission_kernel.py lanes_reference and
// backward_reference (the material table's eval_emissive is the
// independent check); the wrapper is EmissionKernel there.
//
// Forward (emission_forward_kernel), one thread a lane.
// - Bound (chip_smoke.py bound_k7): per lane it reads pos (12 B) and the
//   material id (8 B) and writes em (12 B) and one int32 bin (4 B): 36 B,
//   plus the image once; ~90 operations with a transcendental or two.  At a
//   train step's 16.9 M records that is ~607 MB, ~0.18 ms of HBM time:
//   bytes-bound.
// - What the design does about it: the scene is read in the kernel (the
//   chain's transform and factor rows, each material's const row and the
//   const table, through pointers into the params and the read-only cache),
//   so the wrapper is one launch with no packing; the only residual is the
//   bin the backward adds into (emission_lane.cuh lane_bin): the backward
//   reads the texel again from the image, whose bits the forward read; only
//   a chain lane maps its position and reads its texel (one 16-byte load
//   where C = 4).  No shared memory and no barrier: a warp's stride-3 words
//   of pos and em fall on a few cache lines, which the L1 merges, and
//   staging them through shared memory a block was measured slower (0.3065
//   against 0.2070 ms queued at 16.9 M records, chip_smoke.py on an NVIDIA
//   H100 80GB HBM3 at 700 W: the barriers stall each block between its
//   loads and its stores).
// - The TPU kernel's hi/lo bf16 split of the image and its one-hot MXU
//   gather are TPU workarounds: here the texel is a plain load, and the
//   image has no size limit (the TPU's was VMEM's).
//
// Backward (emission_backward_kernel), one cooperative launch.
// - It adds ct * factor of a chain lane into its texel's bin and the raw ct
//   of another lane into its constant row's bin of one flat (H*W + R) x 3
//   histogram, written straight into d_img (H, W, C: channels past 3 stay 0)
//   and d_const (R, 3); and it reduces d_factor = sum of ct * texel over the
//   chain's lanes (a warp's shuffles, a block's shared memory, one atomic a
//   block and channel).
// - Bound (chip_smoke.py bound_k7_bwd): ct for every lane (12 B), the bin of
//   a lane whose ct is not zero (4 B; the others add nothing and load none),
//   the image once, the three outputs written once.  A train step's 16.9 M
//   records, 4.3 M with a nonzero ct, are ~220 MB, ~0.07 ms.
// - What limits it instead is contention and latency.  Every live lane of
//   another material adds into one of a few constant rows, so the constant
//   rows' sums are always private to a block, in shared memory, flushed
//   once a block; the lanes of a warp that add into one bin are first merged
//   (hist_warp.cuh, K3's warp merge).  The image bins take K3's two regimes
//   (imagegrad.k3_plan's rule, lanes per image entry): direct, the merged
//   sums straight into d_img with device-memory atomics (16 bytes at once
//   where C = 4: the zero fourth channel adds nothing), or private, the
//   whole flat histogram in a block's shared memory.  A warp loads its ct
//   (stride 3, straight to registers) and its bins together: staging ct
//   through shared memory (0.2485 against 0.1310 ms queued at 16.9 M
//   records, chip_smoke.py, same card), or loading a bin only after its ct
//   proved nonzero, was measured slower.
// - The outputs are zero-filled by the grid before a grid-wide barrier, so
//   the backward is one launch (as K3's direct regime); the grid is as many
//   blocks as can be resident, a grid-stride loop over warps of lanes.
// - Float atomics add in a varying order: each sum is within the
//   reordered-sum bound 2*n*2^-24*sum|term| of the exact sum, and
//   chip_smoke.py holds it within 1e-4 of sum|term| of the float64 sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "emission_lane.cuh"
#include "hist_warp.cuh"

namespace cg = cooperative_groups;

namespace {

using ptx_hist::add4;
using ptx_hist::warp_merged_add;

constexpr int kThreads = 256;           // forward
constexpr int kBwdThreads = 512;        // backward
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxDevices = 64;

// One thread a lane; kVec: the image has C = 4 on a 16-byte boundary, a
// texel is one 16-byte load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
emission_forward_kernel(const float* __restrict__ xform, const float* __restrict__ factor,
                        const float* __restrict__ cst, const int* __restrict__ const_row,
                        const float* __restrict__ img, int H, int W, int C,
                        const float* __restrict__ pos, const int64_t* __restrict__ mid,
                        int N, int dyn_mi, int mirror, float* __restrict__ em,
                        int* __restrict__ bin) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= N) return;
  const int m = (int)mid[lane];
  const size_t o = 3 * (size_t)lane;
  const bool chain = m == dyn_mi;
  float e0, e1, e2;
  int texel = -1, r = 0;
  if (chain) {
    texel = ptx_emission::chain_texel(xform, mirror, H, W, pos[o], pos[o + 1], pos[o + 2]);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (texel >= 0 && kVec) {
      t = __ldg(reinterpret_cast<const float4*>(img) + texel);
    } else if (texel >= 0) {
      t.x = __ldg(img + (size_t)texel * C);
      t.y = __ldg(img + (size_t)texel * C + 1);
      t.z = __ldg(img + (size_t)texel * C + 2);
    }
    e0 = t.x * (factor ? __ldg(factor) : 1.f);      // texel * factor, as the plain
    e1 = t.y * (factor ? __ldg(factor + 1) : 1.f);  // version (0 out of bounds)
    e2 = t.z * (factor ? __ldg(factor + 2) : 1.f);
  } else {                                  // another material's constant row
    r = __ldg(const_row + m);
    e0 = __ldg(cst + 3 * r);
    e1 = __ldg(cst + 3 * r + 1);
    e2 = __ldg(cst + 3 * r + 2);
  }
  em[o] = e0;
  em[o + 1] = e1;
  em[o + 2] = e2;
  bin[lane] = ptx_emission::lane_bin(chain, texel, H * W, r);
}

// kPrivate: the image bins in shared memory too (the private regime), else
// only the constant rows; kVec: the image and d_img have C = 4 on 16-byte
// boundaries (a texel is one 16-byte load, an image bin's add one atomic).
template <bool kPrivate, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 2)
emission_backward_kernel(const float* __restrict__ ct, const int* __restrict__ bin, int N,
                         const float* __restrict__ img, int HW, int C, int R,
                         const float* __restrict__ factor, float* __restrict__ d_img,
                         float* __restrict__ d_const, float* __restrict__ d_factor,
                         int factor_words, int factor_off) {
  extern __shared__ float s_hist[];         // 3 floats a bin: [HW, HW + R), or [0, HW + R)
  __shared__ float s_red[kBwdWarps][3];
  const int tid = threadIdx.x, lid = tid & 31, wid = tid >> 5;
  const int first = kPrivate ? 0 : HW;      // the first bin in shared memory
  const int bins = HW + R - first;
  const size_t gstride = (size_t)gridDim.x * kBwdThreads;
  const size_t gtid = (size_t)blockIdx.x * kBwdThreads + tid;
  for (size_t i = gtid; i < (size_t)HW * C; i += gstride) d_img[i] = 0.f;
  for (size_t i = gtid; i < (size_t)R * 3; i += gstride) d_const[i] = 0.f;
  if (d_factor)
    for (size_t i = gtid; i < (size_t)factor_words; i += gstride) d_factor[i] = 0.f;
  for (int i = tid; i < 3 * bins; i += kBwdThreads) s_hist[i] = 0.f;
  cg::this_grid().sync();                   // the zeros are in (a block barrier too)

  const float f0 = factor ? factor[0] : 1.f, f1 = factor ? factor[1] : 1.f,
              f2 = factor ? factor[2] : 1.f;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;       // this thread's sum of ct * texel
  for (long long w0 = (long long)blockIdx.x * kBwdThreads + 32 * wid; w0 < N;
       w0 += (long long)gstride) {          // warp-uniform: the merge needs every lane
    const long long lane = w0 + lid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    int t = -1;
    if (lane < N) {                         // ct and the bin loaded together
      v.x = ct[3 * lane];
      v.y = ct[3 * lane + 1];
      v.z = ct[3 * lane + 2];
      t = bin[lane];
    }
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f) t = -1;   // adds nothing
    if (t >= 0 && t < HW) {                 // a chain lane in bounds
      float4 tx;
      if (kVec) {
        tx = __ldg(reinterpret_cast<const float4*>(img) + t);
      } else {
        tx.x = __ldg(img + (size_t)t * C);
        tx.y = __ldg(img + (size_t)t * C + 1);
        tx.z = __ldg(img + (size_t)t * C + 2);
      }
      p0 += v.x * tx.x;
      p1 += v.y * tx.y;
      p2 += v.z * tx.z;
      v.x *= f0;
      v.y *= f1;
      v.z *= f2;
    }
    warp_merged_add(t, v, [&](int b, float4 s) {
      if (kPrivate || b >= HW)
        add4<false>(s_hist + 3 * (b - first), s, 3);
      else
        add4<kVec>(d_img + (size_t)b * C, s, 3);
    });
  }

  // d_factor: the block's sum, one atomic a channel
  if (d_factor) {
    for (int o = 16; o > 0; o >>= 1) {
      p0 += __shfl_down_sync(ptx_hist::kFull, p0, o);
      p1 += __shfl_down_sync(ptx_hist::kFull, p1, o);
      p2 += __shfl_down_sync(ptx_hist::kFull, p2, o);
    }
    if (lid == 0) {
      s_red[wid][0] = p0;
      s_red[wid][1] = p1;
      s_red[wid][2] = p2;
    }
  }
  __syncthreads();                          // every add of the block is in
  if (d_factor && tid < 3) {
    float s = 0.f;
    for (int k = 0; k < kBwdWarps; ++k) s += s_red[k][tid];
    if (s != 0.f) atomicAdd(d_factor + factor_off + tid, s);
  }
  for (int i = tid; i < bins; i += kBwdThreads) {
    const float4 s = make_float4(s_hist[3 * i], s_hist[3 * i + 1], s_hist[3 * i + 2], 0.f);
    if (!ptx_hist::nonzero(s)) continue;
    const int b = first + i;
    if (b < HW)
      add4<kVec>(d_img + (size_t)b * C, s, 3);
    else
      add4<false>(d_const + 3 * (b - HW), s, 3);
  }
}

// Per device and regime, read and set once per process: the SM count, the
// most dynamic shared memory the backward was opted in to, and the blocks an
// SM holds at the shared memory of the last call.
int g_sms[kMaxDevices];
int g_optin[kMaxDevices][4];
size_t g_occ_smem[kMaxDevices][4];
int g_occ[kMaxDevices][4];

template <bool kPrivate, bool kVec>
int launch_backward(const float* ct, const int* bin, int N, const float* img, int HW, int C,
                    int R, const float* factor, float* d_img, float* d_const,
                    float* d_factor, int factor_words, int factor_off, size_t smem,
                    cudaStream_t stream) {
  auto kernel = emission_backward_kernel<kPrivate, kVec>;
  const int variant = 2 * kPrivate + kVec;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024 && smem > (size_t)g_optin[dev][variant]) {
    // the opt-in covers dynamic and static shared memory together: ask for
    // what this call needs (refused past the block's limit)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    g_optin[dev][variant] = (int)smem;
  }
  if (g_occ[dev][variant] == 0 || g_occ_smem[dev][variant] != smem) {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBwdThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorInvalidValue;   // the histogram does not fit
    g_occ[dev][variant] = occ;
    g_occ_smem[dev][variant] = smem;
  }
  const long long want = ((long long)N + kBwdThreads - 1) / kBwdThreads;
  const long long most = (long long)g_occ[dev][variant] * g_sms[dev];
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(want < most ? want : most));
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ct, bin, N, img, HW, C, R, factor, d_img, d_const,
                           d_factor, factor_words, factor_off);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the forward (ctypes): launches on `stream`, does not
// synchronise, and returns cudaGetLastError() — nonzero when the launch was
// refused — or cudaErrorInvalidValue for arguments it does not take.  xform
// and factor point at the chain's rows of the params (null where the chain
// has none), cst at the const table, const_row at each material's const row
// (on the device).
extern "C" int ptx_emission_forward(const float* xform, const float* factor, const float* cst,
                                    const int* const_row, const float* img, int H, int W,
                                    int C, const float* pos, const int64_t* mid, int N,
                                    int dyn_mi, int mirror, float* em, int* bin,
                                    void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 3 || (long long)H * W >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4 && ((uintptr_t)img & 15) == 0)
    emission_forward_kernel<true><<<blocks, kThreads, 0, s>>>(
        xform, factor, cst, const_row, img, H, W, C, pos, mid, N, dyn_mi, mirror, em, bin);
  else
    emission_forward_kernel<false><<<blocks, kThreads, 0, s>>>(
        xform, factor, cst, const_row, img, H, W, C, pos, mid, N, dyn_mi, mirror, em, bin);
  return (int)cudaGetLastError();
}

// C entry point (ctypes): sets *fits to 1 when the private regime's flat
// histogram of H*W + R bins, with the kernel's static shared memory, fits
// one block's shared memory on the current device (the most a block can
// opt in to), else 0; returns a CUDA error code.
extern "C" int ptx_emission_backward_private_fits(int H, int W, int R, int* fits) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, emission_backward_kernel<true, true>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * 3 * ((size_t)H * W + R) + attr.sharedSizeBytes;
  *fits = smem <= (size_t)optin;
  return (int)cudaSuccess;
}

// C entry point of the backward (ctypes): one cooperative launch on
// `stream` that fills d_img (H*W*C floats), d_const (R*3) and, where not
// null, d_factor (factor_words floats; the chain's row at factor_off), all
// uninitialised; no synchronisation.  private_copy 1 keeps the image bins in
// shared memory too (the wrapper's plan).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int ptx_emission_backward(const float* ct, const int* bin, int N, const float* img,
                                     int H, int W, int C, int R, const float* factor,
                                     float* d_img, float* d_const, float* d_factor,
                                     int factor_words, int factor_off, int private_copy,
                                     void* stream) {
  const long long HW = (long long)H * W;
  if (N < 1 || H < 1 || W < 1 || C < 3 || R < 1 || HW * C >= (1LL << 31) ||
      HW + R >= (1LL << 30) || private_copy < 0 || private_copy > 1 ||
      (d_factor && (factor_off < 0 || factor_off + 3 > factor_words)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * (size_t)(private_copy ? HW + R : R);
  const bool vec = C == 4 && ((uintptr_t)d_img & 15) == 0 && ((uintptr_t)img & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto launch) {
    return launch(ct, bin, N, img, (int)HW, C, R, factor, d_img, d_const, d_factor,
                  factor_words, factor_off, smem, s);
  };
  if (private_copy)
    return vec ? run(launch_backward<true, true>) : run(launch_backward<true, false>);
  return vec ? run(launch_backward<false, true>) : run(launch_backward<false, false>);
}
