// The rng kernel for NVIDIA Hopper (sm_90a): ptx_torch/core/rng.py's
// uniform_many on a CUDA device, the float32 uniforms of up to kMaxKeys
// threefry keys over one shape, in one launch.
//
// It replaces no TPU kernel: the JAX package draws with jax.random, whose
// threefry2x32 XLA fuses on the TPU.  The port first drew with the same
// hash on int64 tensors: some 180 elementwise launches a call, each reading
// and writing 8-byte intermediates, and a host-to-device copy of the keys
// (a synchronise).  That route stays as the kernel's plain version,
// rng.py's uniform_many_reference, which the CPU runs.
//
// - What bounds it on this card: integer operations.  A draw is 20 rounds
//   of (add, rotate, xor), 10 key adds, the counter and the mantissa
//   conversion: about 76 int32 operations for 4 bytes written.  An SM
//   dispatches at most 128 a clock (four schedulers, a 32-lane instruction
//   each; adds also go to the FMA pipe as IMAD beside the integer pipe's 64
//   lanes).  A demo train step's phase draws are 67.46 M uniforms: 5.1 G
//   operations, 0.15 ms at 128 x 132 SMs x 1.98 GHz, against 270 MB of
//   output, 0.08 ms at 3.35 TB/s.
// - Design: the keys travel in the launch's arguments (Keys, by value, a
//   __grid_constant__ in the constant bank), so no device tensor of keys
//   is made and nothing is copied or synchronised.  blockIdx.y picks the
//   key, so a block's key is uniform and its schedule sits in registers;
//   each thread takes kPerThread consecutive draws of that key's row
//   (rng_lane.cuh row_vector: four independent hashes in flight) and
//   stores them as one aligned float4, the row's ragged head and tail by
//   single stores.  The wrapper (ptx_torch/ops/rng_kernel.py) makes one
//   launch per kMaxKeys keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng_lane.cuh"

namespace {

constexpr int kMaxKeys = 64;             // keys a launch: the wrapper's CAPACITY
constexpr int kThreads = 256;            // a block at most

struct Keys {
  uint32_t w[2 * kMaxKeys];              // (k1, k2) of key q at w[2q], w[2q + 1]
};

__global__ void __launch_bounds__(kThreads)
uniform_many_kernel(const __grid_constant__ Keys keys, int64_t n, float* __restrict__ out) {
  using ptx_rng::kPerThread;
  const int q = blockIdx.y;
  const uint32_t k1 = keys.w[2 * q], k2 = keys.w[2 * q + 1];
  float* row = out + (int64_t)q * n;
  const int64_t i0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kPerThread -
                     ptx_rng::row_head(row);
  if (i0 >= n) return;
  float r[kPerThread];
  ptx_rng::row_vector(k1, k2, n, i0, r);
  if (i0 >= 0 && i0 + kPerThread <= n) {
    *reinterpret_cast<float4*>(row + i0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (i0 + e >= 0 && i0 + e < n) row[i0 + e] = r[e];
    }
  }
}

}  // namespace

// C entry point (ctypes): the uniforms of `nkeys` keys (1 to kMaxKeys; their
// words in `keys`, k1 then k2 a key, read before this returns) over a row of
// n each, written to out[q * n + i].  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError(): nonzero when the launch was
// refused (for one, a block of more than kThreads threads).

extern "C" int ptx_uniform_many(const uint32_t* keys, int nkeys, int64_t n, float* out,
                                int block, void* stream) {
  if (nkeys < 1 || nkeys > kMaxKeys || n < 1 || block < 1) return (int)cudaErrorInvalidValue;
  Keys k = {};
  for (int w = 0; w < 2 * nkeys; ++w) k.w[w] = keys[w];
  // a row's threads: up to 3 head floats before its first aligned vector
  const int64_t vectors = (n + 3) / ptx_rng::kPerThread + 1;
  const int64_t blocks = (vectors + block - 1) / block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  uniform_many_kernel<<<dim3((unsigned)blocks, (unsigned)nkeys), block, 0,
                        (cudaStream_t)stream>>>(k, n, out);
  return (int)cudaGetLastError();
}
