// The CSG first-hit fold shared by the fused bounce kernel K1
// (bounce_kernel.cu) and the hit-only kernel K4 (fasthit_kernel.cu): the
// leaf intervals, the postfix tape and the first boundary in time order,
// run by one thread per ray.  It is the port of ptx/ops/fasthit_kernel.py
// hit_fold (:173); its plain PyTorch version is ptx_torch/geom/fasthit.py
// compile_fast_hit.
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
//   An event is a boundary of the root where its membership just after
//   (leaves with t0 <= t < t1) and just before (t0 < t <= t1) differ, kept
//   when t >= EPS.  The first hit is the least boundary time; among events
//   at that time the least index wins, so the leaf order of
//   fasthit.collect_leaves is the coincident-boundary tie-break the demo
//   needs (its diffuse sphere and emissive core coincide).
// - The walk (first_hit_walk): membership depends on the time alone, so the
//   fold visits the distinct event times at or past EPS in ascending order,
//   runs the tape once a visited time over one after / before bit a leaf
//   and stops at the first boundary.  Most lanes stop at their first time
//   (PERF.md); the TPU kernel's masks over all 2L events cost ~4L^2
//   compares a lane whatever its answer.
// - Nothing is indexed at run time in local memory.  The fold is a
//   template on a leaf bucket LB (8, 16 or 24 leaves); its loops are
//   unrolled to LB with the run-time L as a uniform guard, so the intervals
//   sit in registers.  The tape pushes its leaves in descending order
//   (collect_leaves reverses the tape's depth-first order; the wrapper
//   checks it), so leaf k's bits are formed right where the walk over the
//   leaves pushes them; the stack below the top is two registers of bits.
// - Every expression follows the plain version's operation order; the
//   sources are built with -fmad=false (the host build with
//   -ffp-contract=off), so each operation rounds once.
// - The header has no CUDA-only construct: without nvcc it compiles as
//   plain C++ (PTX_HD becomes `inline`), so the CPU tests build it with the
//   host compiler and hold it against the plain fold.

#pragma once

#include <stdint.h>

#ifndef PTX_HD
#ifdef __CUDACC__
#define PTX_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define PTX_HD inline
#endif
#endif

namespace ptx_hit {

constexpr float kEps = 1e-3f;
constexpr float kEps2 = 1e-6f;              // EPS * EPS
constexpr float kMaxValue = 1e20f;
constexpr float kPadT = 3e20f;              // "no boundary"
constexpr int kMaxLeaves = 24;              // the largest leaf bucket (the routing's limit)
constexpr int kLeafStride = 5;              // kind, geo offset, has_xform, material, parity

struct Vec3 {
  float x, y, z;
};

PTX_HD float dot3(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// A leaf's ray in object space (identity when untransformed).
struct LeafRay {
  Vec3 o, d;
};

PTX_HD LeafRay leaf_ray(const float* s, int geo, int kind,
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
PTX_HD void leaf_interval(const float* s, int geo, int kind,
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
PTX_HD Vec3 leaf_normal(const float* s, int geo, int kind,
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

// Every leaf's interval (kPadT past L).
template <int LB>
PTX_HD void leaf_intervals(const float* s, int L, Vec3 o, Vec3 d, float (&t0)[LB],
                           float (&t1)[LB]) {
#pragma unroll
  for (int k = 0; k < LB; ++k) {
    t0[k] = t1[k] = kPadT;
    if (k < L) {
      const float* rec = s + kLeafStride * k;
      const int kind = (int)rec[0], geo = (int)rec[1];
      const LeafRay r = leaf_ray(s, geo, kind, rec[2] != 0.f, o, d);
      leaf_interval(s, geo, kind, r, t0[k], t1[k]);
    }
  }
}

// hit, leaf and the signed normal of a decided first hit (`any`: a
// candidate exists).
PTX_HD void finish_hit(const float* s, int L, Vec3 o, Vec3 d, FirstHit& h, bool any) {
  h.hit = any && !(h.t >= kMaxValue);
  h.leaf = h.event >= L ? h.event - L : h.event;
  const float* rec = s + kLeafStride * h.leaf;
  const int kind = (int)rec[0], geo = (int)rec[1];
  const bool xf = rec[2] != 0.f;
  const float sign = rec[4] * (h.entering ? 1.f : -1.f);
  const Vec3 n = leaf_normal(s, geo, kind, xf, leaf_ray(s, geo, kind, xf, o, d), h.t);
  h.normal = {n.x * sign, n.y * sign, n.z * sign};
}

// Leaf k's bits at time tau: inside just after (t0 <= tau < t1) and just
// before (t0 < tau <= t1); a missed leaf (t0 = t1 = kPadT) in neither.
PTX_HD void leaf_bits(float t0k, float t1k, float tau, bool& a, bool& b) {
  a = t0k <= tau && tau < t1k;
  b = t0k < tau && tau <= t1k;
}

// The root's membership just after (ra) and just before (rb) tau: the
// postfix tape once over the leaves' bits, the stack below its top one bit
// a slot in two registers (the tape is at most 32 deep).
template <int LB>
PTX_HD void root_bits(const float* s, int L, int tape_off, int tape_len, const float (&t0)[LB],
                      const float (&t1)[LB], float tau, bool& ra, bool& rb) {
  uint32_t sa = 0, sb = 0;
  bool ta = false, tb = false;
  int p = 0;
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    const int k = LB - 1 - j;
    if (k < L) {
      if (p > 0) {
        sa = (sa << 1) | (uint32_t)ta;
        sb = (sb << 1) | (uint32_t)tb;
      }
      leaf_bits(t0[k], t1[k], tau, ta, tb);
      for (++p; p < tape_len; ++p) {
        const int op = (int)s[tape_off + p];
        if (op >= 0) break;
        const bool a = sa & 1u, b = sb & 1u;
        sa >>= 1;
        sb >>= 1;
        if (op == -1) {
          ta = a | ta;
          tb = b | tb;
        } else if (op == -2) {
          ta = a & ta;
          tb = b & tb;
        } else {
          ta = a & !ta;
          tb = b & !tb;
        }
      }
    }
  }
  ra = ta;
  rb = tb;
}

// The first hit of one ray, visiting the distinct event times at or past
// EPS in ascending order (each next time an O(L) select above the last) and
// stopping at the first where the root's membership after and before
// differ.  Membership depends on the time alone, so every event at that
// time is a boundary and none before it is: the winner is the lowest event
// index there (the least leaf starting at it, else L plus the least leaf
// ending at it), as a strict-< scan over the events in order picks.  A
// boundary at or past kPadT wins nothing (t kPadT, event 0, entering
// false); without a boundary, entering is event 0's root membership, as the
// plain argmin takes.
template <int LB>
PTX_HD FirstHit first_hit_walk(const float* s, int L, int tape_off, int tape_len, Vec3 o,
                               Vec3 d) {
  float t0[LB], t1[LB];
  leaf_intervals<LB>(s, L, o, d, t0, t1);
  FirstHit h;
  h.t = kPadT;
  h.event = 0;
  h.entering = false;
  bool any = false;
  float last = 0.f;                              // below EPS: the first visit is the least
#pragma unroll 1
  for (int it = 0; it < 2 * L; ++it) {
    bool more = false;
    float tau = 0.f;
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      if (k < L) {
        const float a = t0[k], b = t1[k];
        if (a >= kEps && a > last && (!more || a < tau)) {
          tau = a;
          more = true;
        }
        if (b >= kEps && b > last && (!more || b < tau)) {
          tau = b;
          more = true;
        }
      }
    }
    if (!more) break;
    bool ra, rb;
    root_bits<LB>(s, L, tape_off, tape_len, t0, t1, tau, ra, rb);
    if (ra != rb) {
      any = true;
      if (tau < kPadT) {
        int ev = -1;
#pragma unroll
        for (int k = 0; k < LB; ++k)
          if (k < L && ev < 0 && t0[k] == tau) ev = k;
#pragma unroll
        for (int k = 0; k < LB; ++k)
          if (k < L && ev < 0 && t1[k] == tau) ev = L + k;
        h.t = tau;
        h.event = ev;
        h.entering = ra;
      }
      break;
    }
    last = tau;
  }
  if (!any) {
    bool ra, rb;
    root_bits<LB>(s, L, tape_off, tape_len, t0, t1, t0[0], ra, rb);
    h.entering = ra;                             // event 0's
  }
  finish_hit(s, L, o, d, h, any);
  return h;
}

// The material id of the winning leaf (its record's material word), 0 on a
// miss: the dense hit's mat_id.
PTX_HD int hit_material(const float* s, const FirstHit& h) {
  return h.hit ? (int)s[kLeafStride * h.leaf + 3] : 0;
}

// The leaf bucket of L leaves (the fold's template argument).
inline int leaf_bucket(int L) { return L <= 8 ? 8 : (L <= 16 ? 16 : 24); }

}  // namespace ptx_hit
