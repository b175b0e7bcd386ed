// Hit-only kernel (K4) for NVIDIA Hopper (sm_90a): the CSG first hit of one
// wavefront, one thread per ray.
//
// Replaces ptx/ops/fasthit_kernel.py:233 build_hit_kernel, the Pallas TPU
// kernel (hit_fold :173, pallas_call :293).  Its plain PyTorch version is
// ptx_torch/geom/fasthit.py compile_fast_hit (the dense hit); the wrapper,
// ptx_torch/ops/fasthit_kernel.py HitKernel, checks the inputs and allocates
// the outputs.  The unfused bounce (scenes whose non-emissive slots are
// textures, such as BASELINE config 4) calls it once per bounce.
//
// What bounds it on this card.  Per lane it reads o and d (24 B) and writes
// the first-hit dict (t, normal, mat_id as int64, evt, hit and entering as
// bytes: 30 B): at B = 65,536 that is 3.5 MB, ~1.1 us of HBM time at
// 3.35 TB/s.  The arithmetic is the fold, hit_fold.cuh's walk in time
// order, which K1 runs too: the leaf intervals, then the tape once a
// distinct event time until the first boundary, most lanes at their first
// (PERF.md).  Masks over all 2L events (the TPU kernel's fold) cost ~4L^2
// compares a lane whatever its answer: twice the walk's device time over a
// config 4 train step.
//
// Design.
// - The scene buffer (geometry + tape, no material scalars: on a scene with
//   textured slots those are per-lane values) is copied to shared memory by
//   every block; the entry point picks the fold's leaf bucket.
// - The kernel writes the dense hit's dict itself: t (0 on a miss), the
//   signed normal, mat_id (the winning leaf record's material word, 0 on a
//   miss), evt (0 on a miss), hit and entering; a call is one launch.
// - Built with -fmad=false in the plain version's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_fold.cuh"

namespace {

constexpr int kThreads = 128;

template <int LB>
__global__ void __launch_bounds__(kThreads)
first_hit_kernel(const float* __restrict__ scene, int scene_words, int L, int tape_off,
                 int tape_len, const float* __restrict__ o_in, const float* __restrict__ d_in,
                 int B, float* __restrict__ t_out, float* __restrict__ n_out,
                 int64_t* __restrict__ mat_out, uint8_t* __restrict__ ent_out,
                 uint8_t* __restrict__ hit_out, int* __restrict__ evt_out) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < scene_words; i += blockDim.x) s[i] = scene[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const ptx_hit::Vec3 o = {o_in[3 * lane], o_in[3 * lane + 1], o_in[3 * lane + 2]};
  const ptx_hit::Vec3 d = {d_in[3 * lane], d_in[3 * lane + 1], d_in[3 * lane + 2]};
  const ptx_hit::FirstHit h = ptx_hit::first_hit_walk<LB>(s, L, tape_off, tape_len, o, d);
  t_out[lane] = h.hit ? h.t : 0.f;
  n_out[3 * lane] = h.normal.x;
  n_out[3 * lane + 1] = h.normal.y;
  n_out[3 * lane + 2] = h.normal.z;
  mat_out[lane] = ptx_hit::hit_material(s, h);
  ent_out[lane] = h.entering;
  hit_out[lane] = h.hit;
  evt_out[lane] = h.hit ? h.event : 0;
}

template <int LB>
int launch(const float* scene, int scene_words, int L, int tape_off, int tape_len,
           const float* o, const float* d, int B, float* t, float* normal, int64_t* mat_id,
           uint8_t* entering, uint8_t* hit, int* evt, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)scene_words;
  first_hit_kernel<LB><<<(B + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      scene, scene_words, L, tape_off, tape_len, o, d, B, t, normal, mat_id, entering, hit,
      evt);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.
extern "C" int ptx_first_hit(const float* scene, int scene_words, int L, int tape_off,
                             int tape_len, const float* o, const float* d, int B, float* t,
                             float* normal, int64_t* mat_id, uint8_t* entering, uint8_t* hit,
                             int* evt, void* stream) {
  if (L < 1 || L > ptx_hit::kMaxLeaves || B < 1) return (int)cudaErrorInvalidValue;
  const int lb = ptx_hit::leaf_bucket(L);
  auto go = lb == 8 ? &launch<8> : lb == 16 ? &launch<16> : &launch<24>;
  return go(scene, scene_words, L, tape_off, tape_len, o, d, B, t, normal, mat_id, entering,
            hit, evt, (cudaStream_t)stream);
}
