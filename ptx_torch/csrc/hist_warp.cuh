// Warp-merged histogram adds, shared by the image-gather transposes K3 and
// K8 (image_hist_kernel.cu) and K7's backward (emission_kernel.cu): the
// lanes of a warp that add into one bin are summed into the group's lowest
// lane (__match_any_sync on the bin, a shuffle tree), which makes the one
// add for the group, so a warp issues one add per distinct bin it touches.

#pragma once

#include <cuda_runtime.h>

namespace ptx_hist {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

// The sum of v over the lanes of `group` (this lane's peers: the lanes of the
// warp with its bin), complete in the group's lowest lane.  A tree over the
// group's lanes in lane order, log2(group size) rounds of shuffles; every
// lane of the warp calls it, a lane that adds nothing with a group of itself.
__device__ __forceinline__ float4 sum_peers(unsigned group, int lid, float4 v) {
  int rel = __popc(group & ((1u << lid) - 1u));     // the group's lanes below this one
  unsigned above = group & ~((2u << lid) - 1u);     // and above it, still unmerged
  while (__any_sync(kFull, above)) {
    const int src = __ffs(above) - 1;               // the next lane of the group
    const float tx = __shfl_sync(kFull, v.x, src & 31);
    const float ty = __shfl_sync(kFull, v.y, src & 31);
    const float tz = __shfl_sync(kFull, v.z, src & 31);
    const float tw = __shfl_sync(kFull, v.w, src & 31);
    if (src >= 0) {
      v.x += tx;
      v.y += ty;
      v.z += tz;
      v.w += tw;
    }
    above &= ~__ballot_sync(kFull, rel & 1);        // odd positions are merged
    rel >>= 1;
  }
  return v;
}

// n = min(4, C - c0) channels of v added at dst: one 16-byte atomic (kVec),
// else one scalar atomic per nonzero channel.  dst in device memory or, for
// the scalar form, in shared memory.
template <bool kVec>
__device__ __forceinline__ void add4(float* dst, float4 v, int n) {
  if (kVec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
  if (v.x != 0.f) atomicAdd(dst, v.x);
  if (n > 1 && v.y != 0.f) atomicAdd(dst + 1, v.y);
  if (n > 2 && v.z != 0.f) atomicAdd(dst + 2, v.z);
  if (n > 3 && v.w != 0.f) atomicAdd(dst + 3, v.w);
}

// One warp-merged add: every lane of the warp calls it, with its bin t (or
// -1: it adds nothing) and its value v; the lowest lane of each group of
// lanes with one bin calls add(t, sum of the group's v).
template <typename Add>
__device__ __forceinline__ void warp_merged_add(int t, float4 v, Add add) {
  const int lid = threadIdx.x & 31;
  if (__ballot_sync(kFull, t >= 0) == 0u) return;
  const unsigned peers = __match_any_sync(kFull, t);
  v = sum_peers(t >= 0 ? peers : 1u << lid, lid, v);
  if (t >= 0 && lid == __ffs(peers) - 1) add(t, v);
}

}  // namespace ptx_hist
