"""K11's grid against the grids it could have had, on one card.

    python scripts/k11_grids.py          (from the root of the repository)

``o = x + 1`` over 128 MiB of float32, each chained 16 and 48 times back
and forth between two buffers (together past the 50 MB L2); a grid's time
a pass is the slope between the two, each the best of 3 windows between
CUDA events.  Grids: K11 itself (``ops/roofline_kernel.copy_plus_one``:
one float4 a thread, as many 256-thread blocks as the float4s need); a
grid-stride loop over as many blocks as the SMs hold at once (the
occupancy calculator's count), with one float4 in flight a thread or four,
and over twice and four times those blocks; one block a 256 × 4 float4
stretch, four float4s in flight a thread, with plain and with streaming
(``__ldcs`` / ``__stcs``) loads and stores; and PyTorch's ``torch.add(x,
1, out=)``.  The alternatives are built here with ``nvcc`` and the port's
flags into ``build/k11_grids/``.  Each is first checked against ``x + 1``,
bit for bit.  Two rounds, to see the spread.  Needs a card.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from ptx_torch.ops import _build, roofline_kernel  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ float4 p1(float4 v) {
  v.x += 1.f; v.y += 1.f; v.z += 1.f; v.w += 1.f; return v;
}
template <int U>
__global__ void __launch_bounds__(256) stride(const float4* __restrict__ x, float4* __restrict__ o,
                                              int64_t n4) {
  const int64_t s = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (U - 1) * s < n4; i += U * s) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = x[i + u * s];
#pragma unroll
    for (int u = 0; u < U; ++u) o[i + u * s] = p1(v[u]);
  }
  for (; i < n4; i += s) o[i] = p1(x[i]);
}
template <bool CS>
__global__ void __launch_bounds__(256) four(const float4* __restrict__ x, float4* __restrict__ o,
                                            int64_t n4) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x * 4 + threadIdx.x;
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t i = b + u * blockDim.x;
    if (i < n4) v[u] = CS ? __ldcs(x + i) : x[i];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t i = b + u * blockDim.x;
    if (i < n4) { if (CS) __stcs(o + i, p1(v[u])); else o[i] = p1(v[u]); }
  }
}
template <class K>
static int resident(K k) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, 256, 0);
  return sms * per;
}
extern "C" int grid(int which, const float* x, float* o, int64_t n4, void* st) {
  const float4* a = (const float4*)x;
  float4* b = (float4*)o;
  cudaStream_t s = (cudaStream_t)st;
  switch (which) {
    case 0: stride<1><<<resident(stride<1>), 256, 0, s>>>(a, b, n4); break;
    case 1: stride<4><<<resident(stride<4>), 256, 0, s>>>(a, b, n4); break;
    case 2: stride<1><<<2 * resident(stride<1>), 256, 0, s>>>(a, b, n4); break;
    case 3: stride<1><<<4 * resident(stride<1>), 256, 0, s>>>(a, b, n4); break;
    case 4: four<false><<<(unsigned)((n4 + 1023) / 1024), 256, 0, s>>>(a, b, n4); break;
    case 5: four<true><<<(unsigned)((n4 + 1023) / 1024), 256, 0, s>>>(a, b, n4); break;
  }
  return (int)cudaGetLastError();
}
"""
NAMES = ["grid-stride, resident blocks, 1 in flight", "grid-stride, resident blocks, 4 in flight",
         "grid-stride, 2x resident blocks", "grid-stride, 4x resident blocks",
         "a block a 1,024-float4 stretch, 4 in flight", "the same, streaming loads and stores"]


def main():
    if not torch.cuda.is_available():
        print("k11_grids: needs a CUDA device", file=sys.stderr)
        return 1
    out = os.path.join(os.getcwd(), "build", "k11_grids")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "grids.cu"), "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out, "grids.so"),
                    os.path.join(out, "grids.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(os.path.join(out, "grids.so"))
    vp = ctypes.c_void_p
    lib.grid.argtypes, lib.grid.restype = [ctypes.c_int, vp, vp, ctypes.c_int64, vp], ctypes.c_int
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    n = 32768 * 1024
    bufs = [torch.randn(n, device="cuda"), torch.empty(n, device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream

    def variant(k):
        if k == len(NAMES):
            return "K11 (one float4 a thread)", lambda a, b: roofline_kernel.copy_plus_one(a, out=b)
        if k == len(NAMES) + 1:
            return "torch.add(x, 1, out=)", lambda a, b: torch.add(a, 1, out=b)
        return NAMES[k], lambda a, b: lib.grid(k, a.data_ptr(), b.data_ptr(), n // 4, stream)

    kinds = range(len(NAMES) + 2)
    for k in kinds:
        name, fn = variant(k)
        err = fn(bufs[0], bufs[1])          # a C return code, or the wrapper's output
        if isinstance(err, int) and err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        if not torch.equal(bufs[1], bufs[0] + 1):
            raise AssertionError(f"{name}: not x + 1")
    for rnd in range(2):
        for k in kinds:
            name, fn = variant(k)
            best = []
            for r in (16, 48):
                times = []
                for _ in range(3):
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    a.record()
                    for i in range(r):
                        fn(bufs[i % 2], bufs[1 - i % 2])
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
                best.append(min(times))
            ms = (best[1] - best[0]) / 32
            print(f"round {rnd}: {name}: {ms:.5f} ms a pass, {2 * n * 4 / ms / 1e9:.4f} TB/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
