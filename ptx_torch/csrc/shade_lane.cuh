// The shade-and-scatter half of a fused bounce, shared by K1
// (bounce_kernel.cu, after its CSG fold) and K5 in bounce mode
// (megasweep_kernel.cu, after its union sweep): one lane, given its first
// hit.  It is the port of ptx/ops/bounce_kernel.py shade_lane_math; its plain
// PyTorch version is ptx_torch/shade/bounce.py _bounce_live after the hit.
//
// - The material arrives as 9 scalars (shade/materials.py BOUNCE_ROW):
//   reflect (3), mean scatter, transmit (3), mean transmit_reflect, ior.
// - The uniforms are inputs, drawn by ptx_torch.core.rng exactly as the JAX
//   package draws them: the kernels and the plain version see the same
//   numbers.
// - Every expression follows the plain version's operation order and the
//   sources are built with -fmad=false, so each operation rounds once, as
//   PyTorch's separate elementwise ops do; sqrtf, division, acosf, cosf and
//   sinf are the CUDA math library's, which PyTorch's CUDA ops call too.

#pragma once

#include "hit_fold.cuh"

namespace ptx_shade {

using ptx_hit::Vec3;
using ptx_hit::dot3;
using ptx_hit::kEps;

constexpr int kMatStride = 9;               // rfl3, scatter_f, tr3, transmit_reflect_f, ior

// linalg.normalize: zero vectors pass through
__device__ __forceinline__ Vec3 normalize3(Vec3 v) {
  float m2 = dot3(v, v);
  float s = sqrtf(m2 == 0.f ? 1.f : m2);
  return {v.x / s, v.y / s, v.z / s};
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The new carry of one lane; `flags` holds the bits hit, entering,
// take_transmit, scatter_alive, alive2; `u` is the accepted scatter draw.
struct Shaded {
  Vec3 o2, d2, thr2, u;
  float strength2;
  int flags;
};

// One lane's shading, given its first hit: `t` (0 on a miss), the signed
// `normal`, `hit`, `entering` and the material scalars `mt` of its material
// (material 0 on a miss).
__device__ __forceinline__ Shaded shade_lane(bool hit, bool entering, float t, Vec3 normal,
                                             const float* mt, Vec3 o, Vec3 d, Vec3 thr,
                                             float strength, bool alive, float u_coin,
                                             float u0, float u1, float u2, int in_depth) {
  const Vec3 rfl = {mt[0], mt[1], mt[2]};
  const float scatter_f = mt[3];
  const Vec3 tr = {mt[4], mt[5], mt[6]};
  const float trc_f = mt[7];
  const float ior = mt[8];

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

  // exact ball-cap scatter sampler (bounce.sample_scatter_dir)
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

  // strength bookkeeping with the virtual fan-out (bounce._virtual_fanout)
  const float tr_strength = strength * refract_factor * sqrtf(dot3(tr, tr));
  float vcount = floorf(10000.f * strength * add_factor * sc);
  vcount = (sc <= kEps || vcount < 1.f) ? 1.f : vcount;
  const float sc_strength = strength / vcount * add_factor * factor * sqrtf(dot3(rfl, rfl));
  const float new_strength = take_transmit ? tr_strength : sc_strength;

  Shaded out;
  out.o2 = new_alive ? pos : o;
  out.d2 = new_alive ? new_dir : d;
  out.thr2 = new_alive ? Vec3{thr.x * tint.x, thr.y * tint.y, thr.z * tint.z} : thr;
  out.strength2 = new_alive ? new_strength : strength;
  out.flags = (hit ? 1 : 0) | (entering ? 2 : 0) | (take_transmit ? 4 : 0) |
              (scatter_alive ? 8 : 0) | (new_alive ? 16 : 0);
  out.u = u;
  return out;
}

}  // namespace ptx_shade
