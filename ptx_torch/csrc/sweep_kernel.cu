// Sweep-select kernel (K9) for NVIDIA Hopper (sm_90a): the post-sort stage
// of the union sweep's `kernel` mode, one thread per ray.
//
// Replaces ptx/ops/sweep_kernel.py:164 build_sweep_select, the Pallas TPU
// kernel (_kernel :112, pallas_call :204).  Its plain PyTorch version is
// ptx_torch/ops/sweep_kernel.py sweep_select_reference; the wrapper,
// sweep_select in the same module, checks the inputs and allocates the
// outputs.  ptx_torch/geom/fasthit.py UnionSweepHit calls it once per hit in
// `kernel` mode, on starts sorted by torch.sort.
//
// What it computes, per ray, from the S pooled coverage intervals (s, e) of
// the union (valid-masked: s = 3e20, e = -3e20 where invalid) and the L raw
// leaf intervals (t0, t1):
// - the exclusive prefix max P of e over the rows sorted by s;
// - a break at row k iff s < 2e20 and s > P (touching intervals merge);
// - te = min s over breaks with s >= eps, tx = min P over breaks with
//   P >= eps, and the last chain's exit max(e) when >= eps;
// - entering = te <= tx, t_star = min(te, tx), found = t_star < 2e20;
// - the payload: the least leaf whose raw t0 (m_start), and the least whose
//   raw t1 (m_end), equals t_star bit for bit; L where none does.
// Only compares, selects, max and min: the outputs equal the plain version's
// bit for bit.
//
// What bounds it on this card: bytes.  It reads (2S + 2L) x B floats and
// writes 14 B a ray; at S = L = 256 and B = 65,536 that is 268 MB, 80 us of
// HBM time at 3.35 TB/s, against ~6 compares per (row, ray).  Design:
// - sort = 0 (the path's call): thread b walks the S sorted rows of column
//   b of the row-major (S, B) tensors, so a warp reads 128 contiguous bytes
//   per row, then the L rows of t0 / t1 for the payload, stopping once both
//   matches are found.  No shared memory.
// - sort = 1 (the TPU kernel's own in-kernel sort, kept as in the JAX
//   package for small S): a block holds a tile of bw lanes x Sp rows of
//   (s, e) in dynamic shared memory (Sp a power of 2, padded with 3e20 /
//   -3e20), runs the bitonic network over rows with a barrier between
//   stages and strict compares (so (s, e) stays a permutation under ties,
//   as _bitonic_by_s does), then one thread per lane runs the same sweep
//   from shared memory.  The sweep's outputs do not depend on the order of
//   equal starts (ptx/ops/sweep_kernel.py:28-32), so the unstable network
//   gives the stable sort's answer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPad = 3e20f;
constexpr float kNeg = -3e20f;
constexpr float kFound = 2e20f;
constexpr int kThreads = 256;

// The sweep of one lane over S rows of (s, e) at stride `rs`, then the
// payload match over L rows of (t0, t1) at stride `ts`.
__device__ __forceinline__ void sweep_lane(const float* s, const float* e, int S, size_t rs,
                                           const float* t0, const float* t1, int L, size_t ts,
                                           float eps, float* t_star_out, uint8_t* entering_out,
                                           int* m_start_out, int* m_end_out,
                                           uint8_t* found_out) {
  float p = kNeg;               // exclusive prefix max of e
  float te = kPad, tx = kPad;
  for (int k = 0; k < S; ++k) {
    const float sk = s[k * rs];
    const float ek = e[k * rs];
    if (sk < kFound && sk > p) {
      if (sk >= eps) te = fminf(te, sk);
      if (p >= eps) tx = fminf(tx, p);
    }
    p = fmaxf(p, ek);
  }
  if (p >= eps) tx = fminf(tx, p);        // the last chain's exit
  const float t_star = fminf(te, tx);
  int ms = L, me = L;
  for (int l = 0; l < L && (ms == L || me == L); ++l) {
    if (ms == L && t0[l * ts] == t_star) ms = l;
    if (me == L && t1[l * ts] == t_star) me = l;
  }
  *t_star_out = t_star;
  *entering_out = te <= tx;
  *m_start_out = ms;
  *m_end_out = me;
  *found_out = t_star < kFound;
}

__global__ void __launch_bounds__(kThreads)
sweep_select_kernel(const float* __restrict__ s, const float* __restrict__ e, int S,
                    const float* __restrict__ t0, const float* __restrict__ t1, int L, int B,
                    float eps, float* __restrict__ t_star, uint8_t* __restrict__ entering,
                    int* __restrict__ m_start, int* __restrict__ m_end,
                    uint8_t* __restrict__ found) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  sweep_lane(s + lane, e + lane, S, (size_t)B, t0 + lane, t1 + lane, L, (size_t)B, eps,
             t_star + lane, entering + lane, m_start + lane, m_end + lane, found + lane);
}

// Block (bw, kThreads / bw): threadIdx.x the lane in the tile, threadIdx.y
// the row group.  Shared memory: s then e, each Sp rows of bw lanes.
__global__ void __launch_bounds__(kThreads)
sweep_sort_select_kernel(const float* __restrict__ s, const float* __restrict__ e, int S,
                         int Sp, const float* __restrict__ t0, const float* __restrict__ t1,
                         int L, int B, float eps, float* __restrict__ t_star,
                         uint8_t* __restrict__ entering, int* __restrict__ m_start,
                         int* __restrict__ m_end, uint8_t* __restrict__ found) {
  extern __shared__ float sh[];
  const int bw = blockDim.x, groups = blockDim.y;
  float* ss = sh;
  float* se = sh + (size_t)Sp * bw;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = blockIdx.x * bw + tx;
  const bool live = lane < B;
  for (int k = ty; k < Sp; k += groups) {
    const bool in = live && k < S;
    ss[k * bw + tx] = in ? s[(size_t)k * B + lane] : kPad;
    se[k * bw + tx] = in ? e[(size_t)k * B + lane] : kNeg;
  }
  // bitonic network over rows: pair p of a stage joins rows i and i + stride
  for (int size = 2; size <= Sp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = ty; p < (Sp >> 1); p += groups) {
        const int i = 2 * stride * (p / stride) + (p % stride);
        const int j = i + stride;
        const bool asc = (i & size) == 0;
        const float si = ss[i * bw + tx], sj = ss[j * bw + tx];
        if (asc ? (sj < si) : (sj > si)) {
          ss[i * bw + tx] = sj;
          ss[j * bw + tx] = si;
          const float ei = se[i * bw + tx];
          se[i * bw + tx] = se[j * bw + tx];
          se[j * bw + tx] = ei;
        }
      }
    }
  }
  __syncthreads();
  if (ty != 0 || !live) return;
  sweep_lane(ss + tx, se + tx, Sp, (size_t)bw, t0 + lane, t1 + lane, L, (size_t)B, eps,
             t_star + lane, entering + lane, m_start + lane, m_end + lane, found + lane);
}

}  // namespace

// Dynamic shared memory of the sort = 1 kernel for Sp rows of bw lanes.
extern "C" int ptx_sweep_select_smem(int Sp, int bw) {
  return (int)(2 * sizeof(float) * (size_t)Sp * bw);
}

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.  With
// sort = 0 (s, e) must be sorted by s along rows; with sort = 1 they are
// sorted here, in tiles of bw lanes (32, 16 or 8; Sp a power of 2 >= S).
extern "C" int ptx_sweep_select(const float* s, const float* e, int S, const float* t0,
                                const float* t1, int L, int B, float eps, int sort, int Sp,
                                int bw, float* t_star, uint8_t* entering, int* m_start,
                                int* m_end, uint8_t* found, void* stream) {
  if (S < 1 || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!sort) {
    const int blocks = (B + kThreads - 1) / kThreads;
    sweep_select_kernel<<<blocks, kThreads, 0, st>>>(s, e, S, t0, t1, L, B, eps, t_star,
                                                     entering, m_start, m_end, found);
    return (int)cudaGetLastError();
  }
  if (Sp < S || (Sp & (Sp - 1)) != 0 || (bw != 32 && bw != 16 && bw != 8))
    return (int)cudaErrorInvalidValue;
  const int smem = ptx_sweep_select_smem(Sp, bw);
  cudaError_t err = cudaFuncSetAttribute(sweep_sort_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(bw, kThreads / bw);
  const int blocks = (B + bw - 1) / bw;
  sweep_sort_select_kernel<<<blocks, block, smem, st>>>(s, e, S, Sp, t0, t1, L, B, eps,
                                                        t_star, entering, m_start, m_end,
                                                        found);
  return (int)cudaGetLastError();
}
