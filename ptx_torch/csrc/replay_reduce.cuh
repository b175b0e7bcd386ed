// The second launch of both replay backward kernels, K2
// (bounce_bwd_kernel.cu) and K6 (replay_bwd_kernel.cu): the first launch's
// per-block partial sums of the (L, 34) per-leaf cotangents, reduced and
// folded into d_packed, the cotangent of pack_bwd's scene vector (the L x 26
// leaf rows, then M x 8 material scalars).  A fixed order of adds and no
// atomics: the same inputs give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "replay_lane.cuh"

namespace {

constexpr int kReduceThreads = 256;
constexpr int kReduceDevices = 64;

// One cooperative launch in two steps.  First a group of `wpe` warps takes
// each of the L * 34 per-leaf entries (a block's groups neighbouring
// entries, so their loads share sectors): the entry's n_blocks partials
// (each E = L * 34 floats) are summed by a fixed stride per lane, a fixed
// shuffle tree per warp and the group's warps in order; a leaf-row entry
// (k, c < 26) goes to d_packed[26k + c], a material column to
// leaf_sums[8k + c - 26] (scratch).  After a grid barrier, material m's
// column c is the sum of its leaves' leaf_sums in ascending leaf order
// (mat_leaves[mat_start[m] .. mat_start[m + 1]]), fold_packed's order; a
// material without leaves gets an exact 0.  (Folding each partial before
// the sum put n_blocks x leaves loads into one block: 150 leaves share one
// material in S2, and that block outlasted all the others.)
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial, int n_blocks, int L, int M,
                       const int* __restrict__ mat_start,
                       const int* __restrict__ mat_leaves, int wpe,
                       float* __restrict__ leaf_sums, float* __restrict__ d_packed) {
  using ptx_replay::kCols;
  using ptx_replay::kMat;
  using ptx_replay::kRow;
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ float s[kWarps];
  const int E = L * kCols, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kWarps / wpe, rank = warp % wpe;
  for (int e0 = blockIdx.x * groups; e0 < E; e0 += gridDim.x * groups) {
    const int e = e0 + warp / wpe;
    float sum = 0.f;
    if (e < E) {
#pragma unroll 4
      for (int b = rank * 32 + lane; b < n_blocks; b += 32 * wpe)
        sum += partial[(size_t)b * E + e];
    }
    for (int h = 16; h > 0; h /= 2) sum += __shfl_down_sync(0xffffffffu, sum, h);
    if (lane == 0) s[warp] = sum;
    __syncthreads();
    if (rank == 0 && lane == 0 && e < E) {
      float total = s[warp];
      for (int i = 1; i < wpe; ++i) total += s[warp + i];
      const int k = e / kCols, c = e - k * kCols;
      if (c < kRow)
        d_packed[k * kRow + c] = total;
      else
        leaf_sums[k * kMat + c - kRow] = total;
    }
    __syncthreads();              // s is rewritten for the next entries
  }
  cooperative_groups::this_grid().sync();
  for (int j = blockIdx.x * kReduceThreads + threadIdx.x; j < M * kMat;
       j += gridDim.x * kReduceThreads) {
    const int m = j / kMat, c = j - m * kMat;
    float sum = 0.f;
    for (int i = mat_start[m]; i < mat_start[m + 1]; ++i)
      sum += leaf_sums[mat_leaves[i] * kMat + c];
    d_packed[L * kRow + j] = sum;
  }
}

// Blocks of the reduction resident on the card at once, read once per
// process and device (0: not yet).
int g_reduce_resident[kReduceDevices];

// The second launch on `stream`: the cooperative reduce-and-fold above, on
// at most as many blocks as are resident at once.  `partial` holds n_blocks
// * L * 34 floats, then L * 8 of scratch.
cudaError_t launch_reduce_partials(float* partial, int n_blocks, int L, int M,
                                   const int* mat_start, const int* mat_leaves,
                                   float* d_packed, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kReduceDevices) return cudaErrorInvalidDevice;
  if (g_reduce_resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_partials_kernel,
                                                        kReduceThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_reduce_resident[dev] = per_sm * sms;
  }
  // warps an entry: the fewest (a power of two, at most a block's) that
  // give a lane at most 8 partials to load
  int wpe = 1;
  while (wpe < kReduceThreads / 32 && 32 * wpe * 8 < n_blocks) wpe *= 2;
  const int E = L * ptx_replay::kCols, groups = kReduceThreads / 32 / wpe;
  const int wanted = (E + groups - 1) / groups;
  const int blocks = wanted < g_reduce_resident[dev] ? wanted : g_reduce_resident[dev];
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* sums = partial;
  return cudaLaunchKernelEx(&cfg, reduce_partials_kernel, sums, n_blocks, L, M, mat_start,
                            mat_leaves, wpe, partial + (size_t)n_blocks * E, d_packed);
}

}  // namespace
