// The union sweep's lane arithmetic, shared by both sweep-select kernels of
// K9 (sweep_kernel.cu): the sweep of one lane's rows, sorted by start, split
// into segments that run side by side and are joined by max and min.
//
// The sweep (sweep_kernel.cu's header states what it computes): P is the
// exclusive prefix max of e over the sorted rows; row k breaks a chain iff
// s_k < 2e20 and s_k > P_k; te = min s_k over breaks with s_k >= eps, tx =
// min P_k over breaks with P_k >= eps, and the last chain's exit max(e) when
// >= eps.  Split into segments of consecutive rows:
// - each segment reduces its max of e (segment_max);
// - the max of the maxima of the segments before it is its incoming prefix
//   (the rows before it, chunks before included);
// - each segment re-walks its rows from that prefix (segment_sweep) and
//   takes its break minima; the minima of the segments, min-combined, are
//   the serial sweep's, and the max of all maxima is its last exit.
// Only compares, selects, max and min: any split gives the serial sweep's
// outputs bit for bit.  The payload match (payload_first) splits the L leaf
// rows the same way, strided; the parts fold their matches into the lane's
// least, and skip rows past the least known; the least is the serial
// loop's.
//
// The header has no CUDA-only construct: without nvcc it compiles as plain
// C++ (PTX_HD becomes `inline`), so the CPU tests build it with the host
// compiler and hold it against the plain version
// (tests/test_torch_sweep_lane_host.py).

#pragma once

#include <stddef.h>

#ifndef PTX_HD
#ifdef __CUDACC__
#define PTX_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define PTX_HD inline
#endif
#endif

namespace ptx_sweep {

constexpr float kPad = 3e20f;      // start padding and "no candidate"
constexpr float kNeg = -3e20f;     // end padding: never extends a chain
constexpr float kFound = 2e20f;    // t_star below this is a boundary

// Rows [k0, k1) of segment y of g over n rows: ceil(n / g) each, the last
// ones short or empty.
PTX_HD void segment(int n, int g, int y, int& k0, int& k1) {
  const int r = (n + g - 1) / g;
  k0 = y * r < n ? y * r : n;
  k1 = k0 + r < n ? k0 + r : n;
}

// The max of e over rows [k0, k1) at row stride rs (kNeg when empty).
PTX_HD float segment_max(const float* e, int k0, int k1, size_t rs) {
  float m = kNeg;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) m = fmaxf(m, e[k * rs]);
  return m;
}

// The sweep of rows [k0, k1) entered with prefix max p: folds the breaks'
// minima into te and tx.
PTX_HD void segment_sweep(const float* s, const float* e, int k0, int k1, size_t rs, float p,
                          float eps, float& te, float& tx) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float sk = s[k * rs];
    const float ek = e[k * rs];
    if (sk < kFound && sk > p) {
      if (sk >= eps) te = fminf(te, sk);
      if (p >= eps) tx = fminf(tx, p);
    }
    p = fmaxf(p, ek);
  }
}

// The same two steps for a segment of R rows held in registers (row j in
// s[j], e[j]), rows past the input padded with kPad / kNeg, which change
// neither the max nor the minima.
template <int R>
PTX_HD float segment_max_regs(const float (&e)[R]) {
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < R; ++j) m = fmaxf(m, e[j]);
  return m;
}

template <int R>
PTX_HD void segment_sweep_regs(const float (&s)[R], const float (&e)[R], float p, float eps,
                               float& te, float& tx) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (s[j] < kFound && s[j] > p) {
      if (s[j] >= eps) te = fminf(te, s[j]);
      if (p >= eps) tx = fminf(tx, p);
    }
    p = fmaxf(p, e[j]);
  }
}

// The selection from the combined minima and the total max of e.
PTX_HD void finish(float te, float tx, float total, float eps, float& t_star, bool& entering,
                   bool& found) {
  if (total >= eps) tx = fminf(tx, total);      // the last chain's exit
  t_star = fminf(te, tx);
  entering = te <= tx;
  found = t_star < kFound;
}

// *p = min(*p, v): an atomic in shared memory on the card (the segments of
// a lane share *p), a plain min on the host (one thread runs them in turn).
PTX_HD void min_into(volatile int* p, int v) {
#ifdef __CUDA_ARCH__
  atomicMin((int*)p, v);
#else
  if (v < *p) *p = v;
#endif
}

// The payload of one lane, split over segments: this segment scans leaf
// rows l0, l0 + step, ... < L (at row stride ts) for t0 == t_star and t1 ==
// t_star bit for bit, folding the rows it finds into *ms and *me (the
// lane's least match so far, L where none; shared by its segments and set
// to L before the first starts).  A row at or past the least match known
// is not read: it cannot be the least (the serial loop reads t0 up to its
// match and t1 up to its).  Rows are read kPayloadBatch at a time before
// any is compared, so that a thread keeps that many loads in flight.
constexpr int kPayloadBatch = 4;

PTX_HD void payload_first(const float* t0, const float* t1, int l0, int step, int L,
                          size_t ts, float t_star, volatile int* ms, volatile int* me) {
  for (int l = l0; l < L; l += kPayloadBatch * step) {
    const int ks = *ms, ke = *me;
    if (ks <= l && ke <= l) break;
    float a[kPayloadBatch], b[kPayloadBatch];
#pragma unroll
    for (int j = 0; j < kPayloadBatch; ++j) {
      const int r = l + j * step;
      a[j] = r < L && r < ks ? t0[r * ts] : 0.f;
      b[j] = r < L && r < ke ? t1[r * ts] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPayloadBatch; ++j) {
      const int r = l + j * step;
      if (r < L && r < ks && a[j] == t_star) min_into(ms, r);
      if (r < L && r < ke && b[j] == t_star) min_into(me, r);
    }
  }
}

}  // namespace ptx_sweep
