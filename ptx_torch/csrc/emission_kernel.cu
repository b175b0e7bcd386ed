// Fused emission kernel (K7) for NVIDIA Hopper (sm_90a): one dynamic emissive
// chain ([transform] -> [multiply] -> spherical or mirror-ball map -> image)
// plus the constant emissive row of every other material, one thread per
// lane.
//
// Replaces ptx/ops/emission_kernel.py:98 build_emission_fn (kernel :125,
// pallas_call :263).  Its plain PyTorch version is the material table's
// eval_emissive (ptx_torch/shade/materials.py), differentiated by autograd;
// the wrapper and the backward are ptx_torch/ops/emission_kernel.py.
//
// What bounds it on this card.  Per lane it reads pos (12 B) and the
// material id (8 B), one rgb texel (12 B, through the read-only cache; the
// image is small or its hot texels cached), and writes em (12 B) and the
// residuals the backward needs (texel 12 B, xi, yi, flags, const row 16 B):
// ~72 B a lane, ~90 operations with a transcendental or two.  At the ~1.1 M
// post-scan lanes of a 65,536-ray chunk that is ~80 MB, ~24 us of HBM time:
// bytes-bound.  What the design does about it: one pass, no intermediate in
// device memory, integer residuals instead of f32-encoded ones.
//
// Design.
// - The TPU kernel's hi/lo bf16 split of the image and its one-hot MXU
//   gather are TPU workarounds: here the texel is a plain load.  The TPU
//   kernel's limit H <= 512 and 4 * W_pad <= 4096 is VMEM's (the image had
//   to live on chip); this kernel reads the image from device memory, so it
//   has no image-size limit, and the backward's combined histogram goes to
//   K3 or, past K3's shared memory, K8.
// - The map follows the port's _spherical_uv / _mirror_ball_uv in their
//   operation order, with atan2f / asinf (not the TPU kernel's _acos
//   polynomial, a Mosaic workaround); built with -fmad=false.  The plain
//   version's position transform is an einsum, whose summation order the
//   library picks, so a texel index can differ only for a position within
//   rounding of a texel boundary.
// - The constant emissive rows and their const-table row ids (M <= kMaxMat)
//   sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMat = 256;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.5707963267948966f;

// pp: xform (12, row-major 3x4), factor (3), const emissive rows (M x 3).
__global__ void __launch_bounds__(kThreads)
emission_forward_kernel(const float* __restrict__ pp, const int* __restrict__ const_row,
                        int M, const float* __restrict__ img, int H, int W, int img_c,
                        const float* __restrict__ pos, const int64_t* __restrict__ mid,
                        int N, int dyn_mi, int has_xform, int mirror,
                        float* __restrict__ em, float* __restrict__ texel,
                        int* __restrict__ xi_out, int* __restrict__ yi_out,
                        int* __restrict__ flags_out, int* __restrict__ row_out) {
  __shared__ float s_p[15 + 3 * kMaxMat];
  __shared__ int s_row[kMaxMat];
  for (int i = threadIdx.x; i < 15 + 3 * M; i += blockDim.x) s_p[i] = pp[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) s_row[i] = const_row[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const float px = pos[3 * lane], py = pos[3 * lane + 1], pz = pos[3 * lane + 2];
  const int m = (int)mid[lane];

  // position transform (texture.h:60-90)
  float qx = px, qy = py, qz = pz;
  if (has_xform) {
    const float* w = s_p;
    qx = w[0] * px + w[1] * py + w[2] * pz + w[3];
    qy = w[4] * px + w[5] * py + w[6] * pz + w[7];
    qz = w[8] * px + w[9] * py + w[10] * pz + w[11];
  }
  const bool zero = qx == 0.f && qy == 0.f && qz == 0.f;
  const float m2 = qx * qx + qy * qy + qz * qz;
  const float s = sqrtf(m2 == 0.f ? 1.f : m2);
  const float nx = qx / s, ny = qy / s, nz = qz / s;

  float u, w;
  if (!mirror) {                // equirect (transform_texture.h:73-85)
    const float theta = atan2f(ny, nx);
    const float phi = asinf(fminf(fmaxf(nz, -1.f), 1.f));
    // PyTorch's CUDA division by a Python scalar multiplies by the float
    // reciprocal; the plain version's `/ math.pi` rounds so
    u = theta * 0.5f * (1.f / kPi) + 0.5f;
    w = phi * (1.f / kHalfPi) * 0.5f + 0.5f;
  } else {                      // mirror ball (transform_texture.h:46-59)
    const float dd = sqrtf(fmaxf(2.f + 2.f * nz, 0.f));
    const bool bad = (nz <= -1.f) || (dd == 0.f);
    const float safe_d = bad ? 1.f : dd;
    u = bad ? 0.f : nx / safe_d * 0.5f + 0.5f;
    w = bad ? 0.5f : ny / safe_d * 0.5f + 0.5f;
  }
  if (zero) u = w = 0.f;

  // ImageTex wrap / flip / bounds (image_texture.h:18-28, image.cpp:366-396)
  const float x = u - floorf(u);
  const float y = 1.f - (w - floorf(w));
  const float xf = floorf(x * (float)W), yf = floorf(y * (float)H);
  const bool inb = xf >= 0.f && xf < (float)W && yf >= 0.f && yf < (float)H;
  const int xc = xf < 0.f ? 0 : (xf >= (float)W ? W - 1 : (int)xf);   // clamp, as
  const int yc = yf < 0.f ? 0 : (yf >= (float)H ? H - 1 : (int)yf);   // the gather does
  const float* t = img + ((size_t)yc * W + xc) * img_c;
  const float t0 = inb ? __ldg(t) : 0.f;
  const float t1 = inb ? __ldg(t + 1) : 0.f;
  const float t2 = inb ? __ldg(t + 2) : 0.f;

  const bool sel = m == dyn_mi;
  const float* c = s_p + 15 + 3 * m;
  em[3 * lane] = sel ? t0 * s_p[12] : c[0];
  em[3 * lane + 1] = sel ? t1 * s_p[13] : c[1];
  em[3 * lane + 2] = sel ? t2 * s_p[14] : c[2];
  texel[3 * lane] = t0;
  texel[3 * lane + 1] = t1;
  texel[3 * lane + 2] = t2;
  xi_out[lane] = xc;
  yi_out[lane] = yc;
  flags_out[lane] = (sel ? 1 : 0) | (inb ? 2 : 0);
  row_out[lane] = s_row[m];
}

}  // namespace

// C entry point (ctypes): launches on `stream`, does not synchronise, and
// returns cudaGetLastError() — nonzero when the launch was refused.
extern "C" int ptx_emission_forward(const float* pp, const int* const_row, int M,
                                    const float* img, int H, int W, int img_c,
                                    const float* pos, const int64_t* mid, int N,
                                    int dyn_mi, int has_xform, int mirror, float* em,
                                    float* texel, int* xi, int* yi, int* flags, int* row,
                                    void* stream) {
  if (N < 1 || M < 1 || M > kMaxMat || H < 1 || W < 1 || img_c < 3)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  emission_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pp, const_row, M, img, H, W, img_c, pos, mid, N, dyn_mi, has_xform, mirror, em,
      texel, xi, yi, flags, row);
  return (int)cudaGetLastError();
}
