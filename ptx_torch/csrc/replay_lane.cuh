// Per-lane decision-frozen bounce replay and its hand-written adjoint: the
// arithmetic of K2 (bounce_bwd_kernel.cu), one lane at a time.
//
// The forward is ptx_torch/ops/bounce_kernel.py replay_lane_math (the
// selected-boundary recompute of geom/hitreplay.py, then the differentiable
// half of integrate/trace.py _bounce_replay); the adjoint below is its
// reverse sweep, written line by line.  The Pallas kernel this replaces
// (ptx/ops/bounce_kernel.py:578) ran jax.vjp on the same math while it was
// traced; CUDA has no such thing.
//
// The adjoint takes the derivative of the GUARDED expressions, exactly as
// autograd does on the plain version:
// - a `where` sends the cotangent to the branch that was taken only, so an
//   untaken branch is never differentiated (and never read);
// - normalize(v) at v = 0 divides by the guard 1: the cotangent passes as is;
// - sqrt(disc) only where disc_raw > 1e-12, sqrt(max(arg, 1e-20)) on the
//   refraction (a compaction filler lane reaches arg == 0 exactly), 1/a, 1/r
//   and 1/mag only at their nonzero guards;
// - |t| >= MAX_VALUE (a plane's sentinel boundary) passes no cotangent to t;
// - clip(scatter_f, 0, 1) splits the cotangent in half at 0 and at 1, as
//   JAX's and PyTorch's minimum / maximum do at ties.
// A lane whose carry does not continue (alive2 false: dead lanes, compaction
// fillers, misses) passes its cotangents through and adds nothing to the
// per-leaf sums, so it can never produce a NaN.
//
// The header has no CUDA-only construct: without nvcc it compiles as plain
// C++ (PTX_HD becomes `inline`), which lets a host build check the adjoint
// against autograd.

#pragma once

#ifdef __CUDACC__
#define PTX_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define PTX_HD inline
#endif

namespace ptx_replay {

constexpr float kEps = 1e-3f;
constexpr float kEps2 = 1e-6f;                // EPS * EPS
constexpr float kMaxValue = 1e20f;
constexpr int kRow = 26;                      // hitreplay.leaf_rows columns
constexpr int kMat = 8;                       // reflect3 scatter_f transmit3 ior
constexpr int kCols = kRow + kMat;            // per-leaf cotangent columns

struct V3 {
  float x, y, z;
};

PTX_HD V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
PTX_HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
PTX_HD V3 mul(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
PTX_HD V3 hadamard(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
PTX_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// linalg.normalize: v / sqrt(|v|^2), the zero vector divided by 1
PTX_HD V3 normalize(V3 v) {
  const float m2 = dot(v, v);
  const float s = sqrtf(m2 == 0.f ? 1.f : m2);
  return {v.x / s, v.y / s, v.z / s};
}

// cotangent of v for y = normalize(v): (gy - y (gy.y)) / |v|; gy itself at 0
PTX_HD V3 normalize_vjp(V3 v, V3 gy) {
  const float m2 = dot(v, v);
  if (m2 == 0.f) return gy;
  const float s = sqrtf(m2);
  const V3 y = {v.x / s, v.y / s, v.z / s};
  const float gyy = dot(gy, y);
  return {(gy.x - gyy * y.x) / s, (gy.y - gyy * y.y) / s, (gy.z - gyy * y.z) / s};
}

// One lane.  `row` is the leaf's 26-word row, `ms` its material's 8 scalars;
// `sph`, `par` the leaf's kind and parity; `is_start` whether the event is
// the leaf's start boundary; the four flags are the frozen decisions.  g_o2,
// g_d2, g_t2 are the cotangents of the carry outputs.  Writes g_o, g_d, g_thr
// and returns whether the lane continued; only then are g_row (26) and g_ms
// (8) written, in full.
PTX_HD bool replay_lane_vjp(const float* row, const float* ms, bool sph, float par,
                            bool is_start, bool hit, bool entering, bool take_transmit,
                            bool scatter_alive, V3 o, V3 d, V3 thr, V3 u_sel, V3 g_o2,
                            V3 g_d2, V3 g_t2, V3& g_o, V3& g_d, V3& g_thr, float* g_row,
                            float* g_ms) {
  if (!(take_transmit || scatter_alive)) {   // o2 = o, d2 = d, thr2 = thr
    g_o = g_o2;
    g_d = g_d2;
    g_thr = g_t2;
    return false;
  }
  for (int i = 0; i < kRow; ++i) g_row[i] = 0.f;
  for (int i = 0; i < kMat; ++i) g_ms[i] = 0.f;

  // ---- forward: selected-boundary recompute (hitreplay.recompute_flat) -----
  const float* w = row + 5;                  // world->object affine, 3x4
  const float* nm = row + 17;                // A^-T, 3x3
  const V3 lo = {w[0] * o.x + w[1] * o.y + w[2] * o.z + w[3],
                 w[4] * o.x + w[5] * o.y + w[6] * o.z + w[7],
                 w[8] * o.x + w[9] * o.y + w[10] * o.z + w[11]};
  const V3 ld = {w[0] * d.x + w[1] * d.y + w[2] * d.z,
                 w[4] * d.x + w[5] * d.y + w[6] * d.z,
                 w[8] * d.x + w[9] * d.y + w[10] * d.z};
  const V3 g4 = {row[0], row[1], row[2]};   // sphere centre | plane normal
  const float r4 = row[3];                   // radius | plane d
  // sphere terms
  V3 oc = {0.f, 0.f, 0.f}, p_s = {0.f, 0.f, 0.f};
  float a = 0.f, b = 0.f, cc2 = 0.f, sq = 1.f, sa = 1.f, t_s = 0.f, inv_r = 1.f;
  bool disc_ok = false;
  // plane terms
  float sdiv = 1.f, t_p = 0.f;
  bool flat = false;
  float t_sel;
  V3 n0;
  if (sph) {
    oc = sub(lo, g4);
    a = ld.x * ld.x + ld.y * ld.y + ld.z * ld.z;
    b = oc.x * ld.x + oc.y * ld.y + oc.z * ld.z;
    cc2 = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z - r4 * r4;
    const float disc_raw = b * b - a * cc2;
    disc_ok = disc_raw > 1e-12f;
    sq = sqrtf(disc_ok ? disc_raw : 1.f);
    sa = a == 0.f ? 1.f : a;
    t_s = (is_start ? (-b - sq) : (-b + sq)) / sa;
    inv_r = 1.f / (r4 == 0.f ? 1.f : r4);
    p_s = add(oc, mul(t_s, ld));
    t_sel = t_s;
    n0 = {p_s.x * inv_r, p_s.y * inv_r, p_s.z * inv_r};
  } else {
    const float divisor = ld.x * g4.x + ld.y * g4.y + ld.z * g4.z;
    const float numer = -r4 - (lo.x * g4.x + lo.y * g4.y + lo.z * g4.z);
    flat = fabsf(divisor) < kEps2;
    sdiv = flat ? 1.f : divisor;
    t_p = numer / sdiv;
    t_sel = t_p;
    n0 = {g4.x * row[4], g4.y * row[4], g4.z * row[4]};
  }
  const bool sentinel = fabsf(t_sel) >= kMaxValue;
  const V3 wv = {nm[0] * n0.x + nm[1] * n0.y + nm[2] * n0.z,
                 nm[3] * n0.x + nm[4] * n0.y + nm[5] * n0.z,
                 nm[6] * n0.x + nm[7] * n0.y + nm[8] * n0.z};
  const float mag = sqrtf(wv.x * wv.x + wv.y * wv.y + wv.z * wv.z);
  const float minv = 1.f / (mag == 0.f ? 1.f : mag);
  const float sign = par * (entering ? 1.f : -1.f);
  const float t = hit ? t_sel : 0.f;
  const V3 n = hit ? V3{wv.x * minv * sign, wv.y * minv * sign, wv.z * minv * sign}
                   : V3{0.f, 0.f, 1.f};      // constant unit placeholder on a miss

  // ---- forward + reverse of the shading (trace._bounce_replay) -------------
  const V3 nu = normalize(n);
  V3 g_nu = {0.f, 0.f, 0.f}, g_n = {0.f, 0.f, 0.f};
  V3 gd = {0.f, 0.f, 0.f};
  V3 bt;
  const V3 g_pos = g_o2;                     // o2 = pos on a continuing lane
  const V3 g_nd = g_d2;                      // d2 = the new direction
  if (take_transmit) {
    const float ior = ms[7];
    const float rel = entering ? 1.f / ior : ior;
    const V3 iv = normalize(d);
    const float idn = dot(iv, nu);
    const float arg = 1.f - rel * rel * (1.f - idn * idn);
    const bool rd_ok = (rel > kEps) && (rel < 1000.f) && (dot(n, n) > 0.f) &&
                       (dot(d, d) > 0.f) && (arg >= 0.f);
    bt = {ms[4], ms[5], ms[6]};
    const V3 g_bt = hadamard(g_t2, thr);
    g_ms[4] = g_bt.x;
    g_ms[5] = g_bt.y;
    g_ms[6] = g_bt.z;
    float g_rel = 0.f;
    if (rd_ok) {                             // rd = normalize(rd0), else 0
      const float sarg = fmaxf(arg, 1e-20f);
      const float sqa = sqrtf(sarg);
      const float kk = rel * idn + sqa;
      const V3 rd0 = sub(mul(rel, iv), mul(kk, nu));
      const V3 g_rd0 = normalize_vjp(rd0, g_nd);
      g_rel += dot(g_rd0, iv);
      V3 g_iv = mul(rel, g_rd0);
      const float g_kk = -dot(g_rd0, nu);
      g_nu = add(g_nu, mul(-kk, g_rd0));
      g_rel += g_kk * idn;
      float g_idn = g_kk * rel;
      const float g_arg = arg >= 1e-20f ? g_kk * 0.5f / sqa : 0.f;
      g_rel += g_arg * (-2.f * rel * (1.f - idn * idn));
      g_idn += g_arg * (rel * rel * 2.f * idn);
      g_iv = add(g_iv, mul(g_idn, nu));
      g_nu = add(g_nu, mul(g_idn, iv));
      gd = add(gd, normalize_vjp(d, g_iv));
    }
    g_ms[7] = entering ? -g_rel / (ior * ior) : g_rel;
  } else {                                   // scatter, from the saved draw
    const float two_idn = 2.f * dot(d, nu);
    const V3 ref = sub(d, mul(two_idn, nu));
    const float scf = ms[3];
    const float sc = fminf(fmaxf(scf, 0.f), 1.f);
    const bool specular = sc <= kEps;
    const float ssc = specular ? 1.f : sc;
    const float bias_s = 1.f / ssc - 1.f;
    const V3 uv = add(u_sel, mul(bias_s, ref));
    const V3 scd = specular ? ref : normalize(uv);
    const float dn = dot(scd, n);
    const float factor = 1.f - (1.f - dn) * sc;
    const V3 rfl = {ms[0], ms[1], ms[2]};
    bt = mul(factor, rfl);
    const V3 g_bt = hadamard(g_t2, thr);
    const float g_factor = dot(g_bt, rfl);
    g_ms[0] = g_bt.x * factor;
    g_ms[1] = g_bt.y * factor;
    g_ms[2] = g_bt.z * factor;
    const float g_dn = g_factor * sc;
    float g_sc = -g_factor * (1.f - dn);
    const V3 g_scd = add(g_nd, mul(g_dn, n));
    g_n = add(g_n, mul(g_dn, scd));
    V3 g_ref;
    if (specular) {
      g_ref = g_scd;
    } else {
      const V3 g_u = normalize_vjp(uv, g_scd);
      g_ref = mul(bias_s, g_u);
      g_sc += -dot(g_u, ref) / (ssc * ssc);
    }
    gd = add(gd, g_ref);
    const float g_two = -dot(g_ref, nu);
    g_nu = add(g_nu, mul(-two_idn, g_ref));
    gd = add(gd, mul(2.f * g_two, nu));
    g_nu = add(g_nu, mul(2.f * g_two, d));
    const float tie = (scf > 0.f && scf < 1.f) ? 1.f : ((scf == 0.f || scf == 1.f) ? 0.5f : 0.f);
    g_ms[3] = g_sc * tie;
  }
  g_thr = hadamard(g_t2, bt);
  g_n = add(g_n, normalize_vjp(n, g_nu));

  // pos = o + t d
  V3 go = g_pos;
  const float g_t = dot(g_pos, d);
  gd = add(gd, mul(t, g_pos));

  // ---- reverse of the boundary recompute ------------------------------------
  if (hit) {
    const float g_tsel = sentinel ? 0.f : g_t;
    const V3 g_wn = mul(sign, g_n);          // n = (wv * minv) * sign
    V3 g_wv = mul(minv, g_wn);
    if (mag != 0.f) {
      const float g_mag = -dot(g_wn, wv) / (mag * mag);
      g_wv = add(g_wv, mul(g_mag / mag, wv));
    }
    const V3 g_n0 = {nm[0] * g_wv.x + nm[3] * g_wv.y + nm[6] * g_wv.z,
                     nm[1] * g_wv.x + nm[4] * g_wv.y + nm[7] * g_wv.z,
                     nm[2] * g_wv.x + nm[5] * g_wv.y + nm[8] * g_wv.z};
    const float gw[3] = {g_wv.x, g_wv.y, g_wv.z};
    const float nv[3] = {n0.x, n0.y, n0.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) g_row[17 + 3 * i + j] = gw[i] * nv[j];

    V3 g_lo, g_ld;
    if (sph) {
      const V3 g_ps = mul(inv_r, g_n0);      // n0 = p_s * inv_r
      const float g_invr = dot(g_n0, p_s);
      if (r4 != 0.f) g_row[3] += -g_invr / (r4 * r4);
      V3 g_oc = g_ps;                        // p_s = oc + t_s ld
      const float g_ts = g_tsel + dot(g_ps, ld);
      g_ld = mul(t_s, g_ps);
      const float g_q = g_ts / sa;           // t_s = q / sa
      float g_a = a == 0.f ? 0.f : -g_ts * t_s / sa;
      float g_b = -g_q;
      const float g_sq = is_start ? -g_q : g_q;
      const float g_dr = disc_ok ? g_sq * 0.5f / sq : 0.f;
      g_b += 2.f * b * g_dr;                 // disc_raw = b b - a cc2
      g_a += -cc2 * g_dr;
      const float g_cc2 = -a * g_dr;
      g_oc = add(g_oc, mul(2.f * g_cc2, oc));   // cc2 = oc.oc - r r
      g_row[3] += -2.f * r4 * g_cc2;
      g_oc = add(g_oc, mul(g_b, ld));        // b = oc.ld
      g_ld = add(g_ld, mul(g_b, oc));
      g_ld = add(g_ld, mul(2.f * g_a, ld));  // a = ld.ld
      g_lo = g_oc;                           // oc = lo - c
      g_row[0] = -g_oc.x;
      g_row[1] = -g_oc.y;
      g_row[2] = -g_oc.z;
    } else {
      const float pim = row[4];
      g_row[0] = g_n0.x * pim;               // n0 = pn * pim
      g_row[1] = g_n0.y * pim;
      g_row[2] = g_n0.z * pim;
      g_row[4] = dot(g_n0, g4);
      const float g_numer = g_tsel / sdiv;   // t_p = numer / sdiv
      const float g_div = flat ? 0.f : -g_tsel * t_p / sdiv;
      g_row[3] = -g_numer;                   // numer = -pd - lo.pn
      g_lo = mul(-g_numer, g4);
      g_row[0] += -g_numer * lo.x + g_div * ld.x;   // divisor = ld.pn
      g_row[1] += -g_numer * lo.y + g_div * ld.y;
      g_row[2] += -g_numer * lo.z + g_div * ld.z;
      g_ld = mul(g_div, g4);
    }
    // lo = W o + w3, ld = W d
    go = add(go, V3{w[0] * g_lo.x + w[4] * g_lo.y + w[8] * g_lo.z,
                    w[1] * g_lo.x + w[5] * g_lo.y + w[9] * g_lo.z,
                    w[2] * g_lo.x + w[6] * g_lo.y + w[10] * g_lo.z});
    gd = add(gd, V3{w[0] * g_ld.x + w[4] * g_ld.y + w[8] * g_ld.z,
                    w[1] * g_ld.x + w[5] * g_ld.y + w[9] * g_ld.z,
                    w[2] * g_ld.x + w[6] * g_ld.y + w[10] * g_ld.z});
    const float glo[3] = {g_lo.x, g_lo.y, g_lo.z};
    const float gld[3] = {g_ld.x, g_ld.y, g_ld.z};
    for (int i = 0; i < 3; ++i) {
      g_row[5 + 4 * i + 0] = glo[i] * o.x + gld[i] * d.x;
      g_row[5 + 4 * i + 1] = glo[i] * o.y + gld[i] * d.y;
      g_row[5 + 4 * i + 2] = glo[i] * o.z + gld[i] * d.z;
      g_row[5 + 4 * i + 3] = glo[i];
    }
  }
  g_o = go;
  g_d = gd;
  return true;
}

}  // namespace ptx_replay
