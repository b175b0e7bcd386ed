// K7's lane arithmetic (emission_kernel.cu): the texel of one dynamic
// emissive chain ([transform] -> spherical or mirror-ball map -> image) at a
// position, and the bin the backward adds the lane's cotangent into.
//
// The map follows the plain version (ptx_torch/shade/textures.py
// _spherical_uv / _mirror_ball_uv, ImageTex's wrap, flip and bounds) in its
// operation order, with atan2f / asinf, not the TPU kernel's _acos
// polynomial (a Mosaic workaround).  Built without multiply-add contraction
// (nvcc -fmad=false, g++ -ffp-contract=off), each operation rounds as the
// plain version's does; the plain transform is an einsum, whose summation
// order the library picks, and a host's libm rounds atan2f / asinf unlike
// PyTorch's CPU kernels in the last bit, so a texel index can differ only
// for a position within rounding of a texel boundary.
//
// The header has no CUDA-only construct: without nvcc it compiles as plain
// C++ (PTX_HD becomes `inline`), so the CPU tests build it with the host
// compiler and hold it against the plain version
// (tests/test_torch_emission_lane_host.py).

#pragma once

#ifndef PTX_HD
#ifdef __CUDACC__
#define PTX_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define PTX_HD inline
#endif
#endif

namespace ptx_emission {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.5707963267948966f;

// The flat texel y * W + x of the chain at position (px, py, pz) on an H x W
// image, or -1 where the texel falls outside it.  w: the chain's 3 x 4
// transform, row-major (texture.h:60-90), or null for none; mirror: the
// mirror-ball map, else equirect.
PTX_HD int chain_texel(const float* w, int mirror, int H, int W, float px, float py,
                       float pz) {
  float qx = px, qy = py, qz = pz;
  if (w) {
    qx = w[0] * px + w[1] * py + w[2] * pz + w[3];
    qy = w[4] * px + w[5] * py + w[6] * pz + w[7];
    qz = w[8] * px + w[9] * py + w[10] * pz + w[11];
  }
  const bool zero = qx == 0.f && qy == 0.f && qz == 0.f;
  const float m2 = qx * qx + qy * qy + qz * qz;
  const float s = sqrtf(m2 == 0.f ? 1.f : m2);
  const float nx = qx / s, ny = qy / s, nz = qz / s;

  float u, v;
  if (!mirror) {                // equirect (transform_texture.h:73-85)
    const float theta = atan2f(ny, nx);
    const float phi = asinf(fminf(fmaxf(nz, -1.f), 1.f));
    // PyTorch's division by a Python scalar multiplies by the float
    // reciprocal; the plain version's `/ math.pi` rounds so
    u = theta * 0.5f * (1.f / kPi) + 0.5f;
    v = phi * (1.f / kHalfPi) * 0.5f + 0.5f;
  } else {                      // mirror ball (transform_texture.h:46-59)
    const float dd = sqrtf(fmaxf(2.f + 2.f * nz, 0.f));
    const bool bad = (nz <= -1.f) || (dd == 0.f);
    const float safe_d = bad ? 1.f : dd;
    u = bad ? 0.f : nx / safe_d * 0.5f + 0.5f;
    v = bad ? 0.5f : ny / safe_d * 0.5f + 0.5f;
  }
  if (zero) u = v = 0.f;

  // ImageTex wrap / flip / bounds (image_texture.h:18-28, image.cpp:366-396)
  const float x = u - floorf(u);
  const float y = 1.f - (v - floorf(v));
  const float xf = floorf(x * (float)W), yf = floorf(y * (float)H);
  const bool inb = xf >= 0.f && xf < (float)W && yf >= 0.f && yf < (float)H;
  return inb ? (int)yf * W + (int)xf : -1;
}

// The backward's bin of a lane: its texel (or -1) for a lane of the chain's
// material, else H*W + the lane's constant emissive row.
PTX_HD int lane_bin(bool chain, int texel, int HW, int row) {
  return chain ? texel : HW + row;
}

}  // namespace ptx_emission
