// The sky bank's lane arithmetic (emission_kernel.cu sky_bank_*_kernel): a
// lane's emission banked from its phase's bounce records, forward and
// backward, where every dynamic emitter of the scene is the one terminal sky
// chain ([transform] -> [multiply] -> spherical or mirror-ball map -> image).
//
// The plain version is ptx_torch/ops/sky_bank.py reference (trace.py's
// mat-sum + sky-select): per record (pos, thr, mid, live) of a lane, in
// bounce order,
// - mat-sum: wsum[m] = the sum of thr over the live records of material m
//   (the sky aside); the lane's contribution starts at
//   sum over m ascending of wsum[m] * em_row[m];
// - sky-select: the first live sky record with |t0| + |t1| + |t2| > 0 (a
//   terminal material zeroes throughput, so there is at most one that
//   counts) adds thr * (texel * factor), its chain evaluated at that record
//   alone (emission_lane.cuh chain_texel, K7's map).
// Built without multiply-add contraction (nvcc -fmad=false, g++
// -ffp-contract=off), each operation rounds as the plain version's; wsum
// adds in bounce order, where the plain dim-0 sum may split.
//
// The header has no CUDA-only construct: without nvcc it compiles as plain
// C++, so the CPU tests build it with the host compiler and hold it against
// the plain version (tests/test_torch_sky_bank_host.py).

#pragma once

#include <stdint.h>

#include "emission_lane.cuh"

// a read-only load: through the read-only cache in device code
#ifndef PTX_LDG
#ifdef __CUDA_ARCH__
#define PTX_LDG(p) __ldg(p)
#else
#define PTX_LDG(p) (*(p))
#endif
#endif

namespace ptx_skybank {

constexpr int kMaxMats = 8;                 // materials a scene may have
constexpr int kSums = 3 * (kMaxMats + 1);   // the backward's sums: d_em rows, then d_factor

// The scene as a lane reads it, through pointers into the params.
struct Scene {
  const float* cst;         // params["const"], (R, 3)
  const int64_t* const_row; // (M,) each material's emissive row of cst
  const float* xform;       // the chain's 3 x 4 transform row, or null
  const float* factor;      // the chain's factor row, or null
  const float* img;         // the chain's image, (H, W, C)
  int M, sky, H, W, C, mirror;
};

// One phase's records: pos, thr (nb, Bp, 3), mid, live (nb, Bp).
struct Records {
  const float* pos;
  const float* thr;
  const int64_t* mid;
  const bool* live;
  int nb;
  int64_t Bp;
};

// The sky's texel t at `texel` (-1: outside the image, black) and its
// emission e, the texel times the factor, as the chain's closure (0 * factor
// out of bounds).
PTX_HD void sky_em(const Scene& s, int texel, float t[3], float e[3]) {
  for (int c = 0; c < 3; ++c) {
    t[c] = texel >= 0 ? PTX_LDG(s.img + (size_t)texel * s.C + c) : 0.f;
    e[c] = t[c] * (s.factor ? PTX_LDG(s.factor + c) : 1.f);
  }
}

// The forward of `lane`: writes its contribution to out and the picked
// record's texel (-1 where none) to *texel; returns the picked record (the
// first live sky record with nonzero throughput), or -1.
PTX_HD int lane_forward(const Scene& s, const Records& r, int64_t lane, float out[3],
                        int* texel) {
  float w[kMaxMats][3];
#pragma unroll
  for (int k = 0; k < kMaxMats; ++k) w[k][0] = w[k][1] = w[k][2] = 0.f;
  int pick = -1;
  float tp[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < r.nb; ++b) {
    const int64_t i = b * r.Bp + lane;
    if (!r.live[i]) continue;
    const int m = (int)r.mid[i];
    const float t0 = r.thr[3 * i], t1 = r.thr[3 * i + 1], t2 = r.thr[3 * i + 2];
    if (m == s.sky) {
      if (pick < 0 && fabsf(t0) + fabsf(t1) + fabsf(t2) > 0.f) {
        pick = b;
        tp[0] = t0;
        tp[1] = t1;
        tp[2] = t2;
      }
      continue;
    }
    // a constant index per sum, so the sums stay in registers
#pragma unroll
    for (int k = 0; k < kMaxMats; ++k) {
      if (k == m) {
        w[k][0] += t0;
        w[k][1] += t1;
        w[k][2] += t2;
      }
    }
  }
  float c[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxMats; ++k) {
    if (k >= s.M || k == s.sky) continue;
    const float* e = s.cst + 3 * s.const_row[k];
    for (int j = 0; j < 3; ++j) c[j] = c[j] + w[k][j] * PTX_LDG(e + j);
  }
  float sky[3] = {0.f, 0.f, 0.f};
  *texel = -1;
  if (pick >= 0) {
    const int64_t i = pick * r.Bp + lane;
    *texel = ptx_emission::chain_texel(s.xform, s.mirror, s.H, s.W, r.pos[3 * i],
                                       r.pos[3 * i + 1], r.pos[3 * i + 2]);
    float t[3], e[3];
    sky_em(s, *texel, t, e);
    for (int j = 0; j < 3; ++j) sky[j] = tp[j] * e[j];
  }
  for (int j = 0; j < 3; ++j) out[j] = c[j] + sky[j];
  return pick;
}

// The backward of `lane`, whose cotangent is ct and whose forward picked
// record `pick` at `texel`: writes d_thr of each of its records (ct *
// em_row[m] on a live record of material m, ct * the sky's emission on the
// pick, 0 elsewhere); adds ct * thr of each live record of material m into
// q[m] (the emissive rows' gradient) and (ct * thr) * texel of the pick into
// pf (the factor's); returns the sky image's bin (the pick's texel, or -1)
// with v = (ct * thr) * factor, what the image's gradient adds there.
PTX_HD int lane_backward(const Scene& s, const Records& r, float* d_thr, int64_t lane,
                         const float ct[3], int pick, int texel, float q[kMaxMats][3],
                         float pf[3], float v[3]) {
  float t[3] = {0.f, 0.f, 0.f}, e[3] = {0.f, 0.f, 0.f};
  if (pick >= 0) sky_em(s, texel, t, e);
  for (int b = 0; b < r.nb; ++b) {
    const int64_t i = b * r.Bp + lane;
    float o[3] = {0.f, 0.f, 0.f};
    if (r.live[i]) {
      const int m = (int)r.mid[i];
      if (m != s.sky) {
        const float* em = s.cst + 3 * s.const_row[m];
        const float t0 = r.thr[3 * i], t1 = r.thr[3 * i + 1], t2 = r.thr[3 * i + 2];
        for (int j = 0; j < 3; ++j) o[j] = ct[j] * PTX_LDG(em + j);
#pragma unroll
        for (int k = 0; k < kMaxMats; ++k) {
          if (k == m) {
            q[k][0] += ct[0] * t0;
            q[k][1] += ct[1] * t1;
            q[k][2] += ct[2] * t2;
          }
        }
      } else if (b == pick) {
        for (int j = 0; j < 3; ++j) o[j] = ct[j] * e[j];
      }
    }
    d_thr[3 * i] = o[0];
    d_thr[3 * i + 1] = o[1];
    d_thr[3 * i + 2] = o[2];
  }
  v[0] = v[1] = v[2] = 0.f;
  if (pick < 0 || texel < 0) return -1;
  const int64_t i = pick * r.Bp + lane;
  for (int j = 0; j < 3; ++j) {
    const float d_em = ct[j] * r.thr[3 * i + j];
    pf[j] += d_em * t[j];
    v[j] = d_em * (s.factor ? PTX_LDG(s.factor + j) : 1.f);
  }
  return texel;
}

}  // namespace ptx_skybank
