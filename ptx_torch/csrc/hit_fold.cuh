// The CSG first-hit fold shared by the fused bounce kernel K1
// (bounce_kernel.cu) and the hit-only kernel K4 (fasthit_kernel.cu): one
// copy of the leaf intervals, the 64-bit after/before masks, the postfix
// tape and the first-minimum scan in event order, run by one thread per ray.
// It is the port of ptx/ops/fasthit_kernel.py hit_fold (:173); its plain
// PyTorch version is ptx_torch/geom/fasthit.py compile_fast_hit.
//
// The scene is one float32 buffer in shared memory (ptx_torch/ops/
// fasthit_kernel.py pack_geometry): L leaf records of 5 words (kind 0 sphere
// / 1 plane, geometry offset, has_xform, material id, parity), each leaf's
// geometry (sphere cx cy cz r, plane nx ny nz d inv_mag, then W^-1 (12) and
// W^-T (9) when transformed), and the CSG tape as a postfix program over
// leaf indices (k >= 0 pushes leaf k; -1 union, -2 intersection,
// -3 difference).
//
// - Candidates: leaf k's start time is event k, its end time event L + k.
//   For each leaf the two 64-bit masks after_k / before_k hold, for every
//   event i, whether t_i lies in [t0_k, t1_k) / (t0_k, t1_k].  The postfix
//   tape runs once over those masks (|, &, & ~), giving root membership just
//   after / before every event at once; the root's boundaries are the events
//   where the two differ, kept when t_i >= EPS.
// - The first hit is the minimum candidate, scanned in event order with a
//   strict <, so the first of equal times wins: the leaf order of
//   fasthit.collect_leaves is the coincident-boundary tie-break the demo
//   needs (its diffuse sphere and emissive core coincide).
// - Every expression follows the plain version's operation order; the
//   sources are built with -fmad=false, so each operation rounds once.

#pragma once

#include <stdint.h>

namespace ptx_hit {

constexpr float kEps = 1e-3f;
constexpr float kEps2 = 1e-6f;              // EPS * EPS
constexpr float kMaxValue = 1e20f;
constexpr float kPadT = 3e20f;              // "no boundary"
constexpr int kMaxLeaves = 24;              // 2L events fit one 64-bit mask
constexpr int kMaxStack = 32;               // _MAX_STACK in fasthit_kernel.py
constexpr int kLeafStride = 5;              // kind, geo offset, has_xform, material, parity

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// A leaf's ray in object space (identity when untransformed).
struct LeafRay {
  Vec3 o, d;
};

__device__ __forceinline__ LeafRay leaf_ray(const float* s, int geo, int kind,
                                            bool xf, Vec3 o, Vec3 d) {
  if (!xf) return {o, d};
  const float* w = s + geo + (kind == 0 ? 4 : 5);   // W^-1, 3x4 row-major
  LeafRay r;
  r.o.x = w[0] * o.x + w[1] * o.y + w[2] * o.z + w[3];
  r.o.y = w[4] * o.x + w[5] * o.y + w[6] * o.z + w[7];
  r.o.z = w[8] * o.x + w[9] * o.y + w[10] * o.z + w[11];
  r.d.x = w[0] * d.x + w[1] * d.y + w[2] * d.z;
  r.d.y = w[4] * d.x + w[5] * d.y + w[6] * d.z;
  r.d.z = w[8] * d.x + w[9] * d.y + w[10] * d.z;
  return r;
}

// fasthit._leaf_intervals for one leaf: (t0, t1), kPadT on a miss.
__device__ __forceinline__ void leaf_interval(const float* s, int geo, int kind,
                                              LeafRay r, float& t0, float& t1) {
  const float* g = s + geo;
  if (kind == 0) {
    float ocx = r.o.x - g[0], ocy = r.o.y - g[1], ocz = r.o.z - g[2];
    float rad = g[3];
    float a = r.d.x * r.d.x + r.d.y * r.d.y + r.d.z * r.d.z;
    float b = ocx * r.d.x + ocy * r.d.y + ocz * r.d.z;
    float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    float disc = b * b - a * cc;
    bool ok = (disc > kEps) && (a != 0.f);
    float sq = sqrtf(ok ? disc : 1.f);
    float sa = a == 0.f ? 1.f : a;
    t0 = ok ? (-b - sq) / sa : kPadT;
    t1 = ok ? (-b + sq) / sa : kPadT;
    return;
  }
  float nx = g[0], ny = g[1], nz = g[2], dp = g[3];
  float divisor = r.d.x * nx + r.d.y * ny + r.d.z * nz;
  float numer = -dp - (r.o.x * nx + r.o.y * ny + r.o.z * nz);
  bool flat = fabsf(divisor) < kEps2;
  float t = numer / (flat ? 1.f : divisor);
  bool degenerate = flat || (fabsf(t) >= kMaxValue);
  bool on_boundary = fabsf(numer) < kEps2;
  bool entering_half = divisor < 0.f;
  bool full = degenerate && on_boundary;
  bool miss = degenerate && !on_boundary;
  t0 = miss ? kPadT : (full ? -kMaxValue : (entering_half ? t : -kMaxValue));
  t1 = miss ? kPadT : (full ? kMaxValue : (entering_half ? kMaxValue : t));
}

// Unsigned boundary normal of a leaf at t (world space).
__device__ __forceinline__ Vec3 leaf_normal(const float* s, int geo, int kind,
                                            bool xf, LeafRay r, float t) {
  const float* g = s + geo;
  Vec3 n;
  if (kind == 0) {
    float ocx = r.o.x - g[0], ocy = r.o.y - g[1], ocz = r.o.z - g[2];
    float rad = g[3];
    float inv_r = 1.f / (rad == 0.f ? 1.f : rad);
    n = {(ocx + t * r.d.x) * inv_r, (ocy + t * r.d.y) * inv_r,
         (ocz + t * r.d.z) * inv_r};
  } else {
    float inv_mag = g[4];
    n = {g[0] * inv_mag, g[1] * inv_mag, g[2] * inv_mag};
  }
  if (!xf) return n;
  const float* m = g + (kind == 0 ? 4 : 5) + 12;    // W^-T, 3x3 row-major
  float wx = m[0] * n.x + m[1] * n.y + m[2] * n.z;
  float wy = m[3] * n.x + m[4] * n.y + m[5] * n.z;
  float wz = m[6] * n.x + m[7] * n.y + m[8] * n.z;
  float mag = sqrtf(wx * wx + wy * wy + wz * wz);
  float inv = 1.f / (mag == 0.f ? 1.f : mag);
  return {wx * inv, wy * inv, wz * inv};
}

// The first hit of one ray.  `t` is the winning boundary time, ungated
// (kPadT when there is no candidate); `event` the winning event index (0
// when there is none); `leaf` its leaf; `normal` the signed normal there
// (defined on hit lanes: on a miss it is leaf 0's at kPadT, as in the TPU
// kernel).
struct FirstHit {
  float t;
  int event, leaf;
  bool entering, hit;
  Vec3 normal;
};

__device__ __forceinline__ FirstHit first_hit(const float* s, int L, int tape_off,
                                              int tape_len, Vec3 o, Vec3 d) {
  float t0[kMaxLeaves], t1[kMaxLeaves];
  for (int k = 0; k < L; ++k) {
    const float* rec = s + kLeafStride * k;
    int kind = (int)rec[0], geo = (int)rec[1];
    LeafRay r = leaf_ray(s, geo, kind, rec[2] != 0.f, o, d);
    leaf_interval(s, geo, kind, r, t0[k], t1[k]);
  }

  const int n_ev = 2 * L;
  uint64_t after[kMaxLeaves], before[kMaxLeaves];
  for (int k = 0; k < L; ++k) after[k] = before[k] = 0;
  uint64_t ge_eps = 0;
  for (int i = 0; i < n_ev; ++i) {
    const float ti = i < L ? t0[i] : t1[i - L];
    const uint64_t bit = 1ull << i;
    if (ti >= kEps) ge_eps |= bit;
    for (int k = 0; k < L; ++k) {
      if (t0[k] <= ti && ti < t1[k]) after[k] |= bit;
      if (t0[k] < ti && ti <= t1[k]) before[k] |= bit;
    }
  }

  uint64_t st_a[kMaxStack], st_b[kMaxStack];
  int sp = 0;
  for (int p = 0; p < tape_len; ++p) {
    const int op = (int)s[tape_off + p];
    if (op >= 0) {
      st_a[sp] = after[op];
      st_b[sp] = before[op];
      ++sp;
      continue;
    }
    --sp;
    if (op == -1) {
      st_a[sp - 1] |= st_a[sp];
      st_b[sp - 1] |= st_b[sp];
    } else if (op == -2) {
      st_a[sp - 1] &= st_a[sp];
      st_b[sp - 1] &= st_b[sp];
    } else {
      st_a[sp - 1] &= ~st_a[sp];
      st_b[sp - 1] &= ~st_b[sp];
    }
  }
  const uint64_t root_after = st_a[0];
  const uint64_t cand = (root_after ^ st_b[0]) & ge_eps;

  FirstHit h;
  h.t = kPadT;
  h.event = 0;
  h.entering = false;
  for (uint64_t m = cand; m; m &= m - 1) {
    const int i = __ffsll((long long)m) - 1;
    const float ti = i < L ? t0[i] : t1[i - L];
    if (ti < h.t) {
      h.t = ti;
      h.event = i;
      h.entering = (root_after >> i) & 1;
    }
  }
  h.hit = cand != 0 && !(h.t >= kMaxValue);
  h.leaf = h.event >= L ? h.event - L : h.event;

  const float* rec = s + kLeafStride * h.leaf;
  const int kind = (int)rec[0], geo = (int)rec[1];
  const bool xf = rec[2] != 0.f;
  const float sign = rec[4] * (h.entering ? 1.f : -1.f);
  const Vec3 n = leaf_normal(s, geo, kind, xf, leaf_ray(s, geo, kind, xf, o, d), h.t);
  h.normal = {n.x * sign, n.y * sign, n.z * sign};
  return h;
}

}  // namespace ptx_hit
