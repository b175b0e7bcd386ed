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
//
// The sky bank (sky_bank_*_kernel, below K7): a trace_rays call's emission
// where every dynamic emitter is the one terminal sky chain (the demo's and
// config 4's skies), which K7 does not serve.  Its plain version is
// ptx_torch/ops/sky_bank.py reference, trace.py's mat-sum + sky-select:
// ~270 PyTorch launches a call forward (a where, sum, mul and add per
// material and phase; an argmax, two gathers and the chain's texture
// arithmetic a phase) and ~140 backward.
// - Forward (sky_bank_forward_kernel), one launch a call: one thread a lane
//   of every phase (the phases' tensors travel by pointer in the launch's
//   arguments), which walks its records in bounce order
//   (sky_bank_lane.cuh lane_forward) and writes the lane's contribution
//   and two int32 (the picked record, its texel) for the backward.
// - Backward (sky_bank_backward_kernel), one cooperative launch: d_thr of
//   every record, the image's gradient by K7's direct regime (hist_warp.cuh:
//   warp-merged device-memory atomics, the image zero-filled by the grid
//   before a grid-wide barrier), and each block's sums of the emissive rows' and the factor's
//   gradients; sky_bank_reduce_kernel, one block, sums the blocks' partials
//   in a fixed order and writes d_const (rows that share a const entry add
//   up, in ascending material order) and d_factor.  Only the image's
//   atomics vary from run to run.
// - Bound: bytes (chip_smoke.py bound_sky_bank).  Per record thr (12 B),
//   mid (8 B), live (1 B); per lane the picked position, the contribution,
//   the pick and its texel (32 B).  The backward reads the records too,
//   writes d_thr (12 B a record), reads per lane the cotangent, the pick and
//   its texel (20 B), and writes the image's gradient once.  A demo train
//   step's 16.86 M records over 5.85 M lanes: 0.54 GB forward, 0.67 GB
//   backward, 0.162 / 0.201 ms at 3.35 TB/s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "emission_lane.cuh"
#include "hist_warp.cuh"
#include "sky_bank_lane.cuh"

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

// ---------------------------------------------------------------------------
// The sky bank
// ---------------------------------------------------------------------------

constexpr int kMaxPhases = 8;           // phases a trace_rays call
constexpr int kBankThreads = 256;       // forward
constexpr int kBankBwdThreads = 512;    // backward
constexpr int kBankBwdWarps = kBankBwdThreads / 32;
constexpr int kReduceThreads = 256;
using ptx_skybank::kMaxMats;
using ptx_skybank::kSums;

// One phase of a call: its records (nb, Bp), its first lane in the call's
// flat lane index, the lanes' cotangent (backward), and where the kernel
// writes: the contribution (Bp, 3) forward, d_thr (nb, Bp, 3) backward.
struct Phase {
  const float* pos;
  const float* thr;
  const int64_t* mid;
  const bool* live;
  const float* ct;
  float* out;
  int64_t first, Bp;
  int nb;
};

struct Phases {
  Phase p[kMaxPhases];
  int n;
};

// The phase of flat lane g (the phases in order of `first`).
__device__ __forceinline__ const Phase& phase_of(const Phases& ph, int64_t g) {
  int k = 0;
  while (k + 1 < ph.n && g >= ph.p[k + 1].first) ++k;
  return ph.p[k];
}

__global__ void __launch_bounds__(kBankThreads)
sky_bank_forward_kernel(const __grid_constant__ Phases ph, int64_t lanes,
                        const ptx_skybank::Scene s, int* __restrict__ sel) {
  const int64_t g = (int64_t)blockIdx.x * kBankThreads + threadIdx.x;
  if (g >= lanes) return;
  const Phase& P = phase_of(ph, g);
  const int64_t lane = g - P.first;
  const ptx_skybank::Records r = {P.pos, P.thr, P.mid, P.live, P.nb, P.Bp};
  float c[3];
  int texel;
  const int pick = ptx_skybank::lane_forward(s, r, lane, c, &texel);
  P.out[3 * lane] = c[0];
  P.out[3 * lane + 1] = c[1];
  P.out[3 * lane + 2] = c[2];
  sel[2 * g] = pick;
  sel[2 * g + 1] = texel;
}

// The image's gradient by warp-merged device-memory atomics (K7's direct
// regime).  kVec: the image's gradient has C = 4 on a 16-byte boundary (an
// add is one 16-byte atomic).
template <bool kVec>
__global__ void __launch_bounds__(kBankBwdThreads, 2)
sky_bank_backward_kernel(const __grid_constant__ Phases ph, int64_t lanes,
                         const ptx_skybank::Scene s, const int* __restrict__ sel,
                         float* __restrict__ d_img, float* __restrict__ partial) {
  __shared__ float s_red[kBankBwdWarps][kSums];
  const int tid = threadIdx.x, lid = tid & 31, wid = tid >> 5;
  const int HW = s.H * s.W;
  const int64_t gstride = (int64_t)gridDim.x * kBankBwdThreads;
  for (int64_t i = (int64_t)blockIdx.x * kBankBwdThreads + tid; i < (int64_t)HW * s.C;
       i += gstride)
    d_img[i] = 0.f;
  cg::this_grid().sync();                   // the zeros are in

  float q[kMaxMats][3], pf[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxMats; ++k) q[k][0] = q[k][1] = q[k][2] = 0.f;
  for (int64_t w0 = (int64_t)blockIdx.x * kBankBwdThreads + 32 * wid; w0 < lanes;
       w0 += gstride) {                     // warp-uniform: the merge needs every lane
    const int64_t g = w0 + lid;
    int t = -1;
    float v[3] = {0.f, 0.f, 0.f};
    if (g < lanes) {
      const Phase& P = phase_of(ph, g);
      const int64_t lane = g - P.first;
      const ptx_skybank::Records r = {P.pos, P.thr, P.mid, P.live, P.nb, P.Bp};
      const float ct[3] = {P.ct[3 * lane], P.ct[3 * lane + 1], P.ct[3 * lane + 2]};
      t = ptx_skybank::lane_backward(s, r, P.out, lane, ct, sel[2 * g], sel[2 * g + 1], q,
                                     pf, v);
    }
    const float4 v4 = make_float4(v[0], v[1], v[2], 0.f);
    if (!ptx_hist::nonzero(v4)) t = -1;     // adds nothing
    warp_merged_add(t, v4, [&](int b, float4 x) { add4<kVec>(d_img + (size_t)b * s.C, x, 3); });
  }

  // the block's sums: a shuffle tree a warp, the warps in order
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float x = j < 3 * kMaxMats ? q[j / 3][j % 3] : pf[j - 3 * kMaxMats];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(ptx_hist::kFull, x, o);
    if (lid == 0) s_red[wid][j] = x;
  }
  __syncthreads();
  if (tid < kSums) {
    float x = 0.f;
    for (int k = 0; k < kBankBwdWarps; ++k) x += s_red[k][tid];
    partial[(size_t)blockIdx.x * kSums + tid] = x;
  }
}

// One block: the backward's n_blocks partials summed in a fixed order (a
// warp an entry: a stride per lane, a shuffle tree), then d_const (R, 3),
// each row the sum of its materials' entries in ascending material order,
// and d_factor (factor_words floats, zero but the chain's row), both
// written whole.
__global__ void __launch_bounds__(kReduceThreads)
sky_bank_reduce_kernel(const float* __restrict__ partial, int n_blocks,
                       const int64_t* __restrict__ const_row, int M, int sky, int R,
                       float* __restrict__ d_const, float* __restrict__ d_factor,
                       int factor_words, int factor_off) {
  __shared__ float tot[kSums];
  const int lid = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int j = wid; j < kSums; j += kReduceThreads / 32) {
    float x = 0.f;
    for (int b = lid; b < n_blocks; b += 32) x += partial[(size_t)b * kSums + j];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(ptx_hist::kFull, x, o);
    if (lid == 0) tot[j] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * R; i += kReduceThreads) {
    const int row = i / 3, c = i - 3 * row;
    float x = 0.f;
    for (int m = 0; m < M; ++m)
      if (m != sky && const_row[m] == row) x += tot[3 * m + c];
    d_const[i] = x;
  }
  if (d_factor)
    for (int i = threadIdx.x; i < factor_words; i += kReduceThreads)
      d_factor[i] = i >= factor_off && i < factor_off + 3
                        ? tot[3 * kMaxMats + i - factor_off] : 0.f;
}

// Per device and variant, read once per process: the blocks an SM holds.
int g_bank_occ[kMaxDevices][2];

template <bool kVec>
int launch_bank_backward(const Phases& ph, int64_t lanes, const ptx_skybank::Scene& s,
                         const int* sel, float* d_img, float* partial, int max_blocks,
                         int* n_blocks, cudaStream_t stream) {
  auto kernel = sky_bank_backward_kernel<kVec>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (g_bank_occ[dev][kVec] == 0) {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBankBwdThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorInvalidValue;
    g_bank_occ[dev][kVec] = occ;
  }
  const int64_t want = (lanes + kBankBwdThreads - 1) / kBankBwdThreads;
  int64_t blocks = (int64_t)g_bank_occ[dev][kVec] * g_sms[dev];
  if (want < blocks) blocks = want;
  if (blocks > max_blocks) blocks = max_blocks;
  *n_blocks = (int)blocks;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kBankBwdThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ph, lanes, s, sel, d_img, partial);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The call's phases from the C arrays: per phase 6 pointers (pos, thr, mid,
// live, ct, out) and 2 sizes (nb, Bp); false where they do not fit.
bool read_phases(int n_phases, void* const* ptrs, const int64_t* dims, Phases* ph,
                 int64_t* lanes) {
  if (n_phases < 1 || n_phases > kMaxPhases) return false;
  *ph = Phases{};
  ph->n = n_phases;
  int64_t first = 0;
  for (int k = 0; k < n_phases; ++k) {
    Phase& P = ph->p[k];
    P.pos = (const float*)ptrs[6 * k];
    P.thr = (const float*)ptrs[6 * k + 1];
    P.mid = (const int64_t*)ptrs[6 * k + 2];
    P.live = (const bool*)ptrs[6 * k + 3];
    P.ct = (const float*)ptrs[6 * k + 4];
    P.out = (float*)ptrs[6 * k + 5];
    P.nb = (int)dims[2 * k];
    P.Bp = dims[2 * k + 1];
    if (dims[2 * k] < 1 || dims[2 * k] >= (1 << 20) || P.Bp < 1 || P.Bp >= (1LL << 31))
      return false;
    P.first = first;
    first += P.Bp;
  }
  *lanes = first;
  return first < (1LL << 31);
}

bool scene_ok(int M, int sky, int H, int W, int C) {
  return M >= 1 && M <= kMaxMats && sky >= 0 && sky < M && H >= 1 && W >= 1 && C >= 3 &&
         (long long)H * W * C < (1LL << 31);
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

// C entry point of the sky bank's forward (ctypes): one launch on `stream`
// over the lanes of every phase (ptrs: 6 a phase, pos thr mid live ct out,
// ct unused; dims: nb and Bp a phase), which writes each phase's
// contribution (Bp, 3) to its `out` and two int32 a lane (the picked record,
// its texel; -1 for none) to sel.  xform and factor point at the chain's
// rows (null where it has none), cst at the const table, const_row at each
// material's emissive row (int64, on the device).  No synchronisation; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int ptx_sky_bank_forward(int n_phases, void* const* ptrs, const int64_t* dims,
                                    const float* xform, const float* factor, const float* cst,
                                    const int64_t* const_row, int M, int sky, const float* img,
                                    int H, int W, int C, int mirror, int* sel, void* stream) {
  Phases ph;
  int64_t lanes = 0;
  if (!read_phases(n_phases, ptrs, dims, &ph, &lanes) || !scene_ok(M, sky, H, W, C))
    return (int)cudaErrorInvalidValue;
  const ptx_skybank::Scene s = {cst, const_row, xform, factor, img, M, sky, H, W, C, mirror};
  const int64_t blocks = (lanes + kBankThreads - 1) / kBankThreads;
  sky_bank_forward_kernel<<<(unsigned)blocks, kBankThreads, 0, (cudaStream_t)stream>>>(
      ph, lanes, s, sel);
  return (int)cudaGetLastError();
}

// C entry point of the sky bank's backward (ctypes): two launches on
// `stream`.  The first (cooperative) reads each phase's cotangent `ct` and
// writes its d_thr to `out` (nb, Bp, 3), fills d_img (H, W, C), and leaves
// a block's sums in `partial` (at most max_blocks blocks of kSums floats);
// the second writes d_const (R, 3) and, where not null, d_factor
// (factor_words floats, the chain's row at factor_off).  No output needs
// zeros beforehand; no synchronisation.  Returns a CUDA error code.
extern "C" int ptx_sky_bank_backward(int n_phases, void* const* ptrs, const int64_t* dims,
                                     const float* factor, const float* cst,
                                     const int64_t* const_row, int M, int sky, int R,
                                     const float* img, int H, int W, int C, const int* sel,
                                     float* d_img, float* d_const, float* d_factor,
                                     int factor_words, int factor_off, float* partial,
                                     int max_blocks, void* stream) {
  Phases ph;
  int64_t lanes = 0;
  if (!read_phases(n_phases, ptrs, dims, &ph, &lanes) || !scene_ok(M, sky, H, W, C) ||
      R < 1 || max_blocks < 1 ||
      (d_factor && (factor_off < 0 || factor_off + 3 > factor_words)))
    return (int)cudaErrorInvalidValue;
  const ptx_skybank::Scene s = {cst, const_row, nullptr, factor, img, M, sky, H, W, C, 0};
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = C == 4 && ((uintptr_t)d_img & 15) == 0;
  int n_blocks = 0;
  const int err = (vec ? launch_bank_backward<true> : launch_bank_backward<false>)(
      ph, lanes, s, sel, d_img, partial, max_blocks, &n_blocks, st);
  if (err) return err;
  sky_bank_reduce_kernel<<<1, kReduceThreads, 0, st>>>(partial, n_blocks, const_row, M, sky, R,
                                                       d_const, d_factor, factor_words,
                                                       factor_off);
  return (int)cudaGetLastError();
}
