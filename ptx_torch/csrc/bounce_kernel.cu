// Fused bounce kernel (K1) for NVIDIA Hopper (sm_90a): first hit + shade +
// scatter + carry update for one wavefront bounce, one thread per ray.
//
// Replaces ptx/ops/bounce_kernel.py:236 build_bounce_kernel, the Pallas TPU
// kernel (with fasthit_kernel.hit_fold and shade_lane_math; the shading is
// shade_lane.cuh, which K5 shares).  Its plain
// PyTorch version is ptx_torch/ops/bounce_kernel.py bounce_reference; the
// wrapper there (BounceKernel) checks the inputs and allocates the outputs.
//
// What bounds it on this card.  Per lane it reads ~61 B (o, d, thr 36 B;
// strength, u_coin 8 B; u3 12 B; alive 1 B) and writes 73 B (t, o2, d2,
// thr2, strength2, u_sel, evt; five decision bytes; mat_id as int64).  At
// B = 65536 that is ~9 MB per bounce: ~2.7 us of HBM time at 3.35 TB/s.
// The arithmetic is the fold (the tape once a distinct event time up to the
// first boundary: most lanes stop at their first; the TPU kernel's masks
// take 2L x L x 2 compares a ray, 676 pairs at the demo's L = 13), plus a
// dozen transcendentals.
//
// Design.
// - The scene arrives as one float32 buffer (< 8 KB for L <= 24), copied to
//   shared memory by every block: the geometry and CSG tape of K4's buffer
//   (hit_fold.cuh), then the material scalars.  One kernel serves every
//   eligible scene; nothing is generated per scene.
// - The first hit is hit_fold.cuh's walk in time order, the same code K4
//   runs: a template on the leaf bucket (8, 16, 24), its intervals in
//   registers and the tape's stack two registers of bits, so that no array
//   sits in local memory.  The entry point picks the bucket.
// - The kernel writes what the fused bounce returns: hit, entering,
//   take_transmit, scatter_alive and alive2 as bytes, evt, and mat_id as
//   int64 from the leaf records' material word, so a bounce is the
//   wrapper's checks, its allocations and one launch.
// - The uniforms are inputs, drawn by ptx_torch.core.rng exactly as the JAX
//   package draws them: the kernel and the plain version see the same
//   numbers.
// - Every expression follows the plain version's operation order and is
//   built with -fmad=false, so each operation rounds once, as PyTorch's
//   separate elementwise ops do; sqrtf, division, acosf, cosf and sinf are
//   the CUDA math library's, which PyTorch's CUDA ops call too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_fold.cuh"
#include "shade_lane.cuh"

namespace {

using ptx_hit::FirstHit;
using ptx_hit::Vec3;
using ptx_hit::kMaxLeaves;
using ptx_shade::kMatStride;

constexpr int kThreads = 128;

template <int LB>
__global__ void __launch_bounds__(kThreads)
bounce_forward_kernel(const float* __restrict__ scene, int scene_words, int L,
                      int mat_off, int tape_off, int tape_len,
                      const float* __restrict__ o_in, const float* __restrict__ d_in,
                      const float* __restrict__ thr_in,
                      const float* __restrict__ strength_in,
                      const uint8_t* __restrict__ alive_in,
                      const float* __restrict__ u_coin_in,
                      const float* __restrict__ u3_in, int in_depth, int B,
                      float* __restrict__ t_out, float* __restrict__ o_out,
                      float* __restrict__ d_out, float* __restrict__ thr_out,
                      float* __restrict__ strength_out, uint8_t* __restrict__ hit_out,
                      uint8_t* __restrict__ ent_out, uint8_t* __restrict__ tt_out,
                      uint8_t* __restrict__ sa_out, uint8_t* __restrict__ alive_out,
                      int* __restrict__ evt_out, int64_t* __restrict__ mat_out,
                      float* __restrict__ u_sel_out) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < scene_words; i += blockDim.x) s[i] = scene[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  const Vec3 o = {o_in[3 * lane], o_in[3 * lane + 1], o_in[3 * lane + 2]};
  const Vec3 d = {d_in[3 * lane], d_in[3 * lane + 1], d_in[3 * lane + 2]};
  const Vec3 thr = {thr_in[3 * lane], thr_in[3 * lane + 1], thr_in[3 * lane + 2]};
  const float strength = strength_in[lane];
  const bool alive = alive_in[lane] != 0;
  const float u_coin = u_coin_in[lane];
  const float u0 = u3_in[3 * lane], u1 = u3_in[3 * lane + 1], u2 = u3_in[3 * lane + 2];

  // ---- first hit -----------------------------------------------------------
  const FirstHit h = ptx_hit::first_hit_walk<LB>(s, L, tape_off, tape_len, o, d);
  const bool hit = h.hit;
  const float t = hit ? h.t : 0.f;
  const int mat = ptx_hit::hit_material(s, h);
  const ptx_shade::Shaded r =
      ptx_shade::shade_lane(hit, h.entering, t, h.normal, s + mat_off + kMatStride * mat, o,
                            d, thr, strength, alive, u_coin, u0, u1, u2, in_depth);

  t_out[lane] = t;
  o_out[3 * lane] = r.o2.x;
  o_out[3 * lane + 1] = r.o2.y;
  o_out[3 * lane + 2] = r.o2.z;
  d_out[3 * lane] = r.d2.x;
  d_out[3 * lane + 1] = r.d2.y;
  d_out[3 * lane + 2] = r.d2.z;
  thr_out[3 * lane] = r.thr2.x;
  thr_out[3 * lane + 1] = r.thr2.y;
  thr_out[3 * lane + 2] = r.thr2.z;
  strength_out[lane] = r.strength2;
  hit_out[lane] = (r.flags & 1) != 0;
  ent_out[lane] = (r.flags & 2) != 0;
  tt_out[lane] = (r.flags & 4) != 0;
  sa_out[lane] = (r.flags & 8) != 0;
  alive_out[lane] = (r.flags & 16) != 0;
  evt_out[lane] = hit ? h.event : 0;
  mat_out[lane] = mat;
  u_sel_out[3 * lane] = r.u.x;
  u_sel_out[3 * lane + 1] = r.u.y;
  u_sel_out[3 * lane + 2] = r.u.z;
}

template <int LB>
int launch(const float* scene, int scene_words, int L, int mat_off, int tape_off,
           int tape_len, const float* o, const float* d, const float* thr,
           const float* strength, const uint8_t* alive, const float* u_coin,
           const float* u3, int in_depth, int B, float* t, float* o2, float* d2,
           float* thr2, float* strength2, uint8_t* hit, uint8_t* entering,
           uint8_t* take_transmit, uint8_t* scatter_alive, uint8_t* alive2, int* evt,
           int64_t* mat_id, float* u_sel, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)scene_words;
  bounce_forward_kernel<LB><<<(B + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      scene, scene_words, L, mat_off, tape_off, tape_len, o, d, thr, strength, alive, u_coin,
      u3, in_depth, B, t, o2, d2, thr2, strength2, hit, entering, take_transmit,
      scatter_alive, alive2, evt, mat_id, u_sel);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.
extern "C" int ptx_bounce_forward(
    const float* scene, int scene_words, int L, int mat_off, int tape_off, int tape_len,
    const float* o, const float* d, const float* thr, const float* strength,
    const uint8_t* alive, const float* u_coin, const float* u3, int in_depth, int B,
    float* t, float* o2, float* d2, float* thr2, float* strength2, uint8_t* hit,
    uint8_t* entering, uint8_t* take_transmit, uint8_t* scatter_alive, uint8_t* alive2,
    int* evt, int64_t* mat_id, float* u_sel, void* stream) {
  if (L < 1 || L > kMaxLeaves || B < 1) return (int)cudaErrorInvalidValue;
  const int lb = ptx_hit::leaf_bucket(L);
  auto go = lb == 8 ? &launch<8> : lb == 16 ? &launch<16> : &launch<24>;
  return go(scene, scene_words, L, mat_off, tape_off, tape_len, o, d, thr, strength, alive,
            u_coin, u3, in_depth, B, t, o2, d2, thr2, strength2, hit, entering, take_transmit,
            scatter_alive, alive2, evt, mat_id, u_sel, (cudaStream_t)stream);
}

extern "C" const char* ptx_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
