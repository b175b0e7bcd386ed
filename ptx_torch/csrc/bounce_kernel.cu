// Fused bounce kernel (K1) for NVIDIA Hopper (sm_90a): first hit + shade +
// scatter + carry update for one wavefront bounce, one thread per ray.
//
// Replaces ptx/ops/bounce_kernel.py:236 build_bounce_kernel, the Pallas TPU
// kernel (with fasthit_kernel.hit_fold and shade_lane_math).  Its plain
// PyTorch version is ptx_torch/ops/bounce_kernel.py bounce_reference; the
// wrapper there packs the scene buffer and decodes the outputs.
//
// What bounds it on this card.  Per lane it reads ~61 B (o, d, thr 36 B;
// strength, u_coin 8 B; u3 12 B; alive 1 B) and writes 64 B (t, o2, d2, thr2,
// strength2, flags, evt, u_sel).  At B = 65536 that is ~8 MB per bounce:
// ~2.5 us of HBM time at 3.35 TB/s, less than a launch, so a bounce is
// launch- and latency-bound.  The arithmetic is the membership fold, 2L x L
// x 2 compares per ray (2,304 at L = 24), plus a dozen transcendentals.
// What later work would do about it: structure-of-arrays or vectorised
// 16-byte loads instead of the 12-byte AoS rows; a persistent grid that
// keeps the wavefront on chip across bounces; CUDA graphs over the bounce
// chain to remove the per-launch host cost.
//
// Design.
// - The scene arrives as one float32 buffer (< 8 KB for L <= 24), copied to
//   shared memory by every block: the geometry and CSG tape of K4's buffer
//   (hit_fold.cuh), then the material scalars.  One kernel serves every
//   eligible scene; nothing is generated per scene.
// - The first hit is hit_fold.cuh's first_hit, the same code K4 runs.
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

namespace {

using ptx_hit::FirstHit;
using ptx_hit::Vec3;
using ptx_hit::dot3;
using ptx_hit::kEps;
using ptx_hit::kLeafStride;
using ptx_hit::kMaxLeaves;

constexpr int kMatStride = 9;               // rfl3, scatter_f, tr3, transmit_reflect_f, ior
constexpr int kThreads = 128;

// linalg.normalize: zero vectors pass through
__device__ __forceinline__ Vec3 normalize3(Vec3 v) {
  float m2 = dot3(v, v);
  float s = sqrtf(m2 == 0.f ? 1.f : m2);
  return {v.x / s, v.y / s, v.z / s};
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

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
                      float* __restrict__ strength_out, int* __restrict__ flags_out,
                      int* __restrict__ evt_out, float* __restrict__ u_sel_out) {
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
  const FirstHit h = ptx_hit::first_hit(s, L, tape_off, tape_len, o, d);
  const bool hit = h.hit;
  const Vec3 normal = h.normal;
  const bool entering = h.entering;
  const float t = hit ? h.t : 0.f;
  const int mat = hit ? (int)s[kLeafStride * h.leaf + 3] : 0;
  const float* mt = s + mat_off + kMatStride * mat;
  const Vec3 rfl = {mt[0], mt[1], mt[2]};
  const float scatter_f = mt[3];
  const Vec3 tr = {mt[4], mt[5], mt[6]};
  const float trc_f = mt[7];
  const float ior = mt[8];

  // ---- shade: trace._bounce_live ------------------------------------------
  const Vec3 pos = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  const bool cont = alive && hit && in_depth && (strength >= kEps);
  const float eta = entering ? 1.f / ior : ior;

  // refract_strength / refract (linalg, vector3d.h:191-214)
  const Vec3 n_unit = normalize3(normal);
  const Vec3 iv = normalize3(d);
  const float idn = dot3(iv, n_unit);
  const float arg = 1.f - eta * eta * (1.f - idn * idn);
  const bool base_ok = (eta > kEps) && (eta < 1000.f) && (dot3(normal, normal) > 0.f) &&
                       (dot3(d, d) > 0.f);
  const bool rs_ok = base_ok && (arg > 0.f);
  const float rstrength = rs_ok ? sqrtf(sqrtf(arg)) : 0.f;
  const bool rd_ok = base_ok && (arg >= 0.f);
  const float kk = eta * idn + sqrtf(rd_ok ? fmaxf(arg, 1e-20f) : 1.f);
  Vec3 refr = normalize3({eta * iv.x - kk * n_unit.x, eta * iv.y - kk * n_unit.y,
                          eta * iv.z - kk * n_unit.z});
  if (!rd_ok) refr = {0.f, 0.f, 0.f};

  const float trc = clampf(trc_f, 0.f, 1.f);
  const float refract_factor = trc * rstrength;
  const bool refr_ok = (refract_factor > kEps) &&
                       (refr.x != 0.f || refr.y != 0.f || refr.z != 0.f);
  const float p_transmit = refr_ok ? refract_factor : 0.f;
  const bool take_transmit = (u_coin < p_transmit) && cont;
  const float add_factor = 1.f - p_transmit;
  bool scatter_alive = cont && !take_transmit && (add_factor >= kEps);

  // exact ball-cap scatter sampler (trace.sample_scatter_dir)
  const float two_dn = 2.f * dot3(d, n_unit);
  const Vec3 reflected = {d.x - two_dn * n_unit.x, d.y - two_dn * n_unit.y,
                          d.z - two_dn * n_unit.z};
  const float sc = clampf(scatter_f, 0.f, 1.f);
  const bool specular = sc <= kEps;
  const float bias_s = 1.f / (specular ? 1.f : sc) - 1.f;
  const Vec3 bias = {bias_s * reflected.x, bias_s * reflected.y, bias_s * reflected.z};
  const float m2 = dot3(normal, normal);
  const float mg = sqrtf(m2 == 0.f ? 1.f : m2);
  const Vec3 nh = {normal.x / mg, normal.y / mg, normal.z / mg};
  const float c = (kEps - dot3(normal, bias)) / mg;
  const bool feasible = c < 1.f;
  const float cc = clampf(c, -1.f, 1.f);
  const float g_cc = cc - cc * cc * cc * (1.f / 3.f);
  const float G = g_cc + u0 * (2.f / 3.f - g_cc);
  const float carg = clampf(-1.5f * G, -1.f, 1.f);
  float z = 2.f * cosf(acosf(carg) * (1.f / 3.f) - 2.0943951023931953f);
  z = fminf(fmaxf(z, cc), 1.f);
  const float rr = sqrtf(fmaxf(1.f - z * z, 0.f) * u1);
  const float phi = 6.283185307179586f * u2;
  const float xx = rr * cosf(phi), yy = rr * sinf(phi);
  const float s_ = nh.z >= 0.f ? 1.f : -1.f;
  const float a_ = -1.f / (s_ + nh.z);
  const float b_ = nh.x * nh.y * a_;
  const Vec3 e1 = {1.f + s_ * nh.x * nh.x * a_, s_ * b_, -s_ * nh.x};
  const Vec3 e2 = {b_, s_ + nh.y * nh.y * a_, -nh.y};
  const Vec3 u = {xx * e1.x + yy * e2.x + z * nh.x, xx * e1.y + yy * e2.y + z * nh.y,
                  xx * e1.z + yy * e2.z + z * nh.z};
  const Vec3 scat = specular ? reflected
                             : normalize3({u.x + bias.x, u.y + bias.y, u.z + bias.z});
  scatter_alive = scatter_alive && (specular || feasible);
  const float factor = 1.f - (1.f - dot3(scat, normal)) * sc;

  const bool new_alive = take_transmit || scatter_alive;
  const Vec3 new_dir = take_transmit ? refr : scat;
  const Vec3 tint = take_transmit ? tr : Vec3{factor * rfl.x, factor * rfl.y, factor * rfl.z};

  // strength bookkeeping with the virtual fan-out (trace._virtual_fanout)
  const float tr_strength = strength * refract_factor * sqrtf(dot3(tr, tr));
  float vcount = floorf(10000.f * strength * add_factor * sc);
  vcount = (sc <= kEps || vcount < 1.f) ? 1.f : vcount;
  const float sc_strength = strength / vcount * add_factor * factor * sqrtf(dot3(rfl, rfl));
  const float new_strength = take_transmit ? tr_strength : sc_strength;

  t_out[lane] = t;
  const Vec3 o2 = new_alive ? pos : o;
  const Vec3 d2 = new_alive ? new_dir : d;
  const Vec3 thr2 = new_alive ? Vec3{thr.x * tint.x, thr.y * tint.y, thr.z * tint.z} : thr;
  o_out[3 * lane] = o2.x;
  o_out[3 * lane + 1] = o2.y;
  o_out[3 * lane + 2] = o2.z;
  d_out[3 * lane] = d2.x;
  d_out[3 * lane + 1] = d2.y;
  d_out[3 * lane + 2] = d2.z;
  thr_out[3 * lane] = thr2.x;
  thr_out[3 * lane + 1] = thr2.y;
  thr_out[3 * lane + 2] = thr2.z;
  strength_out[lane] = new_alive ? new_strength : strength;
  flags_out[lane] = (hit ? 1 : 0) | (entering ? 2 : 0) | (take_transmit ? 4 : 0) |
                    (scatter_alive ? 8 : 0) | (new_alive ? 16 : 0);
  evt_out[lane] = hit ? h.event : 0;
  u_sel_out[3 * lane] = u.x;
  u_sel_out[3 * lane + 1] = u.y;
  u_sel_out[3 * lane + 2] = u.z;
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.
extern "C" int ptx_bounce_forward(
    const float* scene, int scene_words, int L, int mat_off, int tape_off, int tape_len, const float* o, const float* d, const float* thr,
    const float* strength, const uint8_t* alive, const float* u_coin, const float* u3,
    int in_depth, int B, float* t, float* o2, float* d2, float* thr2, float* strength2,
    int* flags, int* evt, float* u_sel, void* stream) {
  if (L < 1 || L > kMaxLeaves || B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (size_t)scene_words;
  bounce_forward_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      scene, scene_words, L, mat_off, tape_off, tape_len, o, d, thr, strength,
      alive, u_coin, u3, in_depth, B, t, o2, d2, thr2, strength2, flags, evt, u_sel);
  return (int)cudaGetLastError();
}

extern "C" const char* ptx_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
