// Hit-only kernel (K4) for NVIDIA Hopper (sm_90a): the CSG first hit of one
// wavefront, one thread per ray.
//
// Replaces ptx/ops/fasthit_kernel.py:233 build_hit_kernel, the Pallas TPU
// kernel (hit_fold :173, pallas_call :293).  Its plain PyTorch version is
// ptx_torch/geom/fasthit.py compile_fast_hit (the dense hit); the wrapper,
// ptx_torch/ops/fasthit_kernel.py HitKernel, packs the scene buffer and
// decodes the outputs.  The unfused bounce (scenes whose non-emissive slots
// are textures, such as BASELINE config 4) calls it once per bounce.
//
// What bounds it on this card.  Per lane it reads o and d (24 B) and writes
// t, the normal, flags and the event index (24 B): at B = 65,536 that is
// 3.1 MB, ~1 us of HBM time at 3.35 TB/s.  The arithmetic is the membership
// fold, 2L x L x 2 compares per ray, ~25 operations per leaf interval and a
// normal: a few microseconds at L = 9 over 65,536 rays, so one launch is
// latency-bound, as K1 is.  The design does nothing more about that in this
// first version: the fold is K1's (hit_fold.cuh), so both kernels run one
// copy of it and agree with the plain hit to the last bit.
//
// Design.
// - The scene buffer (geometry + tape, no material scalars: on a scene with
//   textured slots those are per-lane values) is copied to shared memory by
//   every block.
// - Outputs: t (0 on a miss), the signed normal, flags (bit 0 hit, bit 1
//   entering) and the winning event index (0 on a miss), as int32: no
//   f32-encoded masks.
// - Built with -fmad=false in the plain version's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_fold.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
first_hit_kernel(const float* __restrict__ scene, int scene_words, int L, int tape_off,
                 int tape_len, const float* __restrict__ o_in,
                 const float* __restrict__ d_in, int B, float* __restrict__ t_out,
                 float* __restrict__ n_out, int* __restrict__ flags_out,
                 int* __restrict__ evt_out) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < scene_words; i += blockDim.x) s[i] = scene[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const ptx_hit::Vec3 o = {o_in[3 * lane], o_in[3 * lane + 1], o_in[3 * lane + 2]};
  const ptx_hit::Vec3 d = {d_in[3 * lane], d_in[3 * lane + 1], d_in[3 * lane + 2]};
  const ptx_hit::FirstHit h = ptx_hit::first_hit(s, L, tape_off, tape_len, o, d);
  t_out[lane] = h.hit ? h.t : 0.f;
  n_out[3 * lane] = h.normal.x;
  n_out[3 * lane + 1] = h.normal.y;
  n_out[3 * lane + 2] = h.normal.z;
  flags_out[lane] = (h.hit ? 1 : 0) | (h.entering ? 2 : 0);
  evt_out[lane] = h.hit ? h.event : 0;
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.
extern "C" int ptx_first_hit(const float* scene, int scene_words, int L, int tape_off,
                             int tape_len, const float* o, const float* d, int B,
                             float* t, float* normal, int* flags, int* evt, void* stream) {
  if (L < 1 || L > ptx_hit::kMaxLeaves || B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (size_t)scene_words;
  first_hit_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      scene, scene_words, L, tape_off, tape_len, o, d, B, t, normal, flags, evt);
  return (int)cudaGetLastError();
}
