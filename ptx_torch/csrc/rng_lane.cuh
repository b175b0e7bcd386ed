// The draw of the rng kernel (rng_kernel.cu): what one thread computes.
//
// uniform_at is jax.random.uniform's float32 at flat index i under the key
// (k1, k2): threefry2x32, 20 rounds, on the counter pair (i >> 32, i mod
// 2^32), the two output words xored, the top 23 bits taken as the mantissa
// of a float in [1, 2), less 1.  The key schedule (k1, k2, k1 ^ k2 ^
// 0x1BD11BDA) stays in registers, each injection's round constant is folded
// into its key add, and the rotation counts are template arguments.  Its
// plain version is ptx_torch/core/rng.py's int64 route of uniform_many.
//
// row_vector is a thread's share of one key's row of n draws: the row's
// elements [i0, i0 + kPerThread) that exist, i0 = kPerThread * t - head for
// thread t, where the row starts head floats past a 16-byte boundary, so
// that every full vector is one aligned 16-byte store.
//
// The header has no CUDA-only construct outside its #ifdefs: without nvcc
// it compiles as plain C++ (PTX_HD becomes `inline`), so the CPU tests build
// it with the host compiler and hold it against the plain version
// (tests/test_torch_rng.py).

#pragma once

#include <stdint.h>

#ifndef PTX_HD
#ifdef __CUDACC__
#define PTX_HD __host__ __device__ __forceinline__
#else
#define PTX_HD inline
#endif
#endif

#ifndef __CUDA_ARCH__
#include <string.h>
#endif

namespace ptx_rng {

constexpr int kPerThread = 4;            // consecutive draws a thread: one float4 store

template <int R>
PTX_HD uint32_t rotl(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, R);
#else
  return (x << R) | (x >> (32 - R));
#endif
}

// Four rounds: x1 += x2; x2 = rotl(x2, r) ^ x1, for r = A, B, C, D.
template <int A, int B, int C, int D>
PTX_HD void rounds4(uint32_t& x1, uint32_t& x2) {
  x1 += x2;
  x2 = rotl<A>(x2) ^ x1;
  x1 += x2;
  x2 = rotl<B>(x2) ^ x1;
  x1 += x2;
  x2 = rotl<C>(x2) ^ x1;
  x1 += x2;
  x2 = rotl<D>(x2) ^ x1;
}

PTX_HD float unit_float(uint32_t bits) {
  const uint32_t f = (bits >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(f) - 1.0f;
#else
  float x;
  memcpy(&x, &f, sizeof x);
  return x - 1.0f;
#endif
}

PTX_HD float uniform_at(uint32_t k1, uint32_t k2, uint64_t i) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t x1 = (uint32_t)(i >> 32) + k1;
  uint32_t x2 = (uint32_t)i + k2;
  rounds4<13, 15, 26, 6>(x1, x2);
  x1 += k2;
  x2 += k3 + 1u;
  rounds4<17, 29, 16, 24>(x1, x2);
  x1 += k3;
  x2 += k1 + 2u;
  rounds4<13, 15, 26, 6>(x1, x2);
  x1 += k1;
  x2 += k2 + 3u;
  rounds4<17, 29, 16, 24>(x1, x2);
  x1 += k2;
  x2 += k3 + 4u;
  rounds4<13, 15, 26, 6>(x1, x2);
  x1 += k3;
  x2 += k1 + 5u;
  return unit_float(x1 ^ x2);
}

// The row's draws [i0, i0 + kPerThread) that lie in [0, n) into r; the
// others of r are left as they are.
PTX_HD void row_vector(uint32_t k1, uint32_t k2, int64_t n, int64_t i0,
                       float (&r)[kPerThread]) {
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t i = i0 + e;
    if (i >= 0 && i < n) r[e] = uniform_at(k1, k2, (uint64_t)i);
  }
}

// The floats past a 16-byte boundary at which a row starts.
PTX_HD int row_head(const float* row) { return (int)(((uintptr_t)row >> 2) & 3); }

}  // namespace ptx_rng
