// The megasweep (K5) for NVIDIA Hopper (sm_90a): the union-sweep first hit
// of a large scene, one thread per ray, in hit mode (t, normal, decisions)
// or bounce mode (the first hit, then shade_lane.cuh's shading and scatter,
// in the same launch).
//
// Replaces ptx/ops/megasweep.py:589 build_mega_sweep, the Pallas TPU kernel.
// Its plain PyTorch version is ptx_torch/ops/megasweep.py
// megasweep_reference (and, in bounce mode, bounce_reference on it); the
// wrapper there (MegaSweepKernel) packs the scene and the row layout.
//
// What bounds it on this card.  Arithmetic: every pass evaluates one
// interval per table row, ~25 float operations and a square root per (row,
// ray) for a sphere, and a lane makes 1 + (fixpoint passes) + 1 passes (the
// fixpoint ends after 2-4 on real scenes), so at L ~ 270 rows a ray costs
// ~30,000 operations; a lane moves ~130 bytes in bounce mode (o, d, thr,
// strength, alive, u_coin, u3 in; t, o2, d2, thr2, strength2, flags, evt,
// mat, u_sel out).
//
// Design.
// - The TPU kernel keeps two (Lp, 512) interval scratches in VMEM; 2·Lp
//   floats a ray do not fit Hopper's shared memory for a block of rays.
//   Here the intervals are recomputed on every pass and never stored: the
//   packed table (Lp x 16, or Lp x 32 with per-row world->object affines),
//   the material scalars, the cull bounds and the int program table sit in
//   shared memory, and a lane walks them.
// - A gadget's coverage is its slots, each (s, e) a postfix program over its
//   members' t0 / t1, -MAX, +MAX, max and min (no per-scene code
//   generation): the lane computes the gadget's member intervals into a
//   small array, then runs the programs.
// - The chain-exit fixpoint runs per lane until its E stops changing: the
//   recurrence is monotone and stays put once fixed, so a lane's value
//   equals that of the TPU's block-wide loop.
// - Culling is a pure skip: each warp tests every cluster bound once
//   (__any_sync of the per-ray test, block_hits in the plain version) and
//   skips a cluster no lane of it meets; a culled row reads as a miss (PAD),
//   which is what it is for those rays.  `cull` = 0 turns the test off; the
//   outputs do not depend on it.
// - The payload is the smallest leaf id whose raw t0 (then t1) equals the
//   first boundary bitwise; the replay forward of that row gives t and the
//   normal with the formulas of megasweep.py:459-541.  A lane that does not
//   hit skips the payload pass: its outputs are the miss placeholders, and
//   bounce mode shades it with material 0, as the plain bounce does.
// - Built with -fmad=false, every expression in the plain version's order,
//   so each operation rounds once, as PyTorch's separate ops do.
// Later work: interval caching in registers for small L, TMA-fed tables, a
// ray-block BVH instead of flat cluster culling.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_lane.cuh"

namespace {

using ptx_hit::Vec3;
using ptx_hit::kEps;
using ptx_hit::kEps2;
using ptx_hit::kMaxValue;
using ptx_hit::kPadT;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 64;             // megasweep.CLUSTER
constexpr int kMaxMembers = 12;          // megasweep.MAX_MEMBERS
constexpr int kMaxStack = 16;            // megasweep.MAX_STACK
constexpr float kNeg = -3e20f;

struct Args {
  const float* scene;
  int scene_words;
  const int* meta;
  int meta_words;
  int L, Lp, ns, n_rows, tw, n_flags, mat_off, bnd_off, cls_off, n_classes, cull;
  const float* o;
  const float* d;
  int B;
  const float* thr;                     // bounce mode when non-null
  const float* strength;
  const uint8_t* alive;
  const float* u_coin;
  const float* u3;
  int in_depth;
  float* t;
  float* normal;                        // hit mode
  int* flags;
  int* evt;
  int* mat;
  float* o2;
  float* d2;
  float* thr2;
  float* strength2;
  float* u_sel;
  int* stats;                           // optional: fixpoint passes, active flags
};

struct Ray {
  Vec3 o, d;
  float a, sa;
  bool a_ok;
};

__device__ __forceinline__ Ray make_ray(Vec3 o, Vec3 d) {
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  return {o, d, a, a == 0.f ? 1.f : a, a != 0.f};
}

// the shared-memory scene of one block, and this warp's cull flags
struct Scene {
  const float* tbl;
  const int* meta;
  const int* wflags;
  int tw, ns, n_rows, n_classes, cls_off, c_lid, c_cov, c_mat, c_par, c_kind;
  bool xf;
  float noid;
};

// the ray in a row's object space: W^-1 from columns 5-16 (32-column table)
__device__ __forceinline__ Ray row_ray(const Scene& S, const float* p, const Ray& R) {
  if (!S.xf) return R;
  const float* w = p + 5;
  const Vec3 o = {w[0] * R.o.x + w[1] * R.o.y + w[2] * R.o.z + w[3],
                  w[4] * R.o.x + w[5] * R.o.y + w[6] * R.o.z + w[7],
                  w[8] * R.o.x + w[9] * R.o.y + w[10] * R.o.z + w[11]};
  const Vec3 d = {w[0] * R.d.x + w[1] * R.d.y + w[2] * R.d.z,
                  w[4] * R.d.x + w[5] * R.d.y + w[6] * R.d.z,
                  w[8] * R.d.x + w[9] * R.d.y + w[10] * R.d.z};
  return make_ray(o, d);
}

// one row's raw interval (PAD on a miss and on a pad row)
__device__ __forceinline__ void row_iv(const Scene& S, int r, const Ray& R0, float& t0,
                                       float& t1) {
  const float* p = S.tbl + r * S.tw;
  const Ray R = row_ray(S, p, R0);
  const bool real = p[S.c_lid] < S.noid;
  if (r < S.ns) {
    const float ocx = R.o.x - p[0], ocy = R.o.y - p[1], ocz = R.o.z - p[2];
    const float rad = p[3];
    const float b = ocx * R.d.x + ocy * R.d.y + ocz * R.d.z;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - R.a * cc;
    const bool ok = (disc > kEps) && R.a_ok && real;
    const float sq = sqrtf(ok ? disc : 1.f);
    t0 = ok ? (-b - sq) / R.sa : kPadT;
    t1 = ok ? (-b + sq) / R.sa : kPadT;
    return;
  }
  const float nx = p[0], ny = p[1], nz = p[2], dp = p[3];
  const float divisor = nx * R.d.x + ny * R.d.y + nz * R.d.z;
  const float numer = -dp - (nx * R.o.x + ny * R.o.y + nz * R.o.z);
  const bool small = fabsf(divisor) < kEps2;
  const float t = numer / (small ? 1.f : divisor);
  const bool degen = small || (fabsf(t) >= kMaxValue);
  const bool on_b = fabsf(numer) < kEps2;
  const bool ent = divisor < 0.f;
  const bool full = degen && on_b;
  const bool ok = !(degen && !on_b) && real;
  t0 = ok ? ((full || !ent) ? -kMaxValue : t) : kPadT;
  t1 = ok ? ((full || ent) ? kMaxValue : t) : kPadT;
}

__device__ __forceinline__ float eval_prog(const int* prog, int len, const float* mt0,
                                           const float* mt1) {
  float st[kMaxStack];
  int sp = 0;
  for (int i = 0; i < len; ++i) {
    const int op = prog[i];
    if (op >= 0) {
      st[sp++] = (op & 1) ? mt1[op >> 1] : mt0[op >> 1];
    } else if (op == -1) {
      st[sp++] = -kMaxValue;
    } else if (op == -2) {
      st[sp++] = kMaxValue;
    } else {
      const float b = st[--sp];
      st[sp - 1] = op == -3 ? fmaxf(st[sp - 1], b) : fminf(st[sp - 1], b);
    }
  }
  return st[0];
}

// Calls f(s, e) for every valid coverage interval of the ray: leaf-group
// rows (cov = 1) and every gadget's slots.  Culled clusters are skipped.
template <class F>
__device__ __forceinline__ void for_each_cov(const Scene& S, const Ray& R, F f) {
  const int n_sc = (S.ns + kCluster - 1) / kCluster;
  for (int k = 0; k < n_sc; ++k) {
    if (!S.wflags[k]) continue;
    const int r1 = min(S.ns, (k + 1) * kCluster);
    for (int r = k * kCluster; r < r1; ++r) {
      if (S.tbl[r * S.tw + S.c_cov] == 0.f) continue;
      float t0, t1;
      row_iv(S, r, R, t0, t1);
      if (t0 < t1 && t1 >= kEps) f(t0, t1);
    }
  }
  for (int r = S.ns; r < S.n_rows; ++r) {
    if (S.tbl[r * S.tw + S.c_cov] == 0.f) continue;
    float t0, t1;
    row_iv(S, r, R, t0, t1);
    if (t0 < t1 && t1 >= kEps) f(t0, t1);
  }
  for (int c = 0; c < S.n_classes; ++c) {
    const int* h = S.meta + S.meta[S.cls_off + c];
    const int G = h[0], m = h[2], n_slots = h[3], f0 = h[4];
    const int* mrow = h + 5;
    const int* slots = mrow + m;
    for (int g = 0; g < G; ++g) {
      if (!S.wflags[f0 + g / kCluster]) continue;
      float mt0[kMaxMembers], mt1[kMaxMembers];
      for (int j = 0; j < m; ++j) {
        const int r = mrow[j] + g;
        if (r < S.ns && !S.wflags[r / kCluster]) {
          mt0[j] = mt1[j] = kPadT;
        } else {
          row_iv(S, r, R, mt0[j], mt1[j]);
        }
      }
      for (int q = 0; q < n_slots; ++q) {
        const int* sl = slots + 4 * q;
        const float s = eval_prog(S.meta + sl[0], sl[1], mt0, mt1);
        const float e = eval_prog(S.meta + sl[2], sl[3], mt0, mt1);
        if (s < e && e >= kEps) f(s, e);
      }
    }
  }
}

__device__ __forceinline__ Vec3 load3(const float* p, int lane) {
  return {p[3 * lane], p[3 * lane + 1], p[3 * lane + 2]};
}

__device__ __forceinline__ void store3(float* p, int lane, Vec3 v) {
  p[3 * lane] = v.x;
  p[3 * lane + 1] = v.y;
  p[3 * lane + 2] = v.z;
}

__global__ void __launch_bounds__(kThreads) megasweep_kernel(const Args A) {
  extern __shared__ float smem[];
  float* s_f = smem;
  int* s_meta = reinterpret_cast<int*>(s_f + A.scene_words);
  int* s_flags = s_meta + A.meta_words;                    // kWarps x n_flags
  for (int i = threadIdx.x; i < A.scene_words; i += kThreads) s_f[i] = A.scene[i];
  for (int i = threadIdx.x; i < A.meta_words; i += kThreads) s_meta[i] = A.meta[i];

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x / 32;
  const bool valid = lane < A.B;
  const Vec3 o = valid ? load3(A.o, lane) : Vec3{0.f, 0.f, 0.f};
  const Vec3 d = valid ? load3(A.d, lane) : Vec3{0.f, 0.f, 1.f};
  __syncthreads();

  // cull flags of this warp: does any of its rays meet the bound?
  const float* bnd = s_f + A.bnd_off;
  int* wflags = s_flags + warp * A.n_flags;
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  int n_active = 0;
  for (int f = 0; f < A.n_flags; ++f) {
    const float* b = bnd + 4 * f;
    bool act = true;
    if (A.cull && b[3] >= 0.f) {
      const float ocx = o.x - b[0], ocy = o.y - b[1], ocz = o.z - b[2];
      const float bq = ocx * d.x + ocy * d.y + ocz * d.z;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - b[3] * b[3];
      const float disc = bq * bq - a * cc;
      const float t1 = (-bq + sqrtf(fmaxf(disc, 0.f))) / (a == 0.f ? 1.f : a);
      act = valid && disc > 0.f && t1 >= kEps && a != 0.f;
    }
    const bool any = __any_sync(0xffffffffu, act);
    if ((threadIdx.x & 31) == 0) wflags[f] = any ? 1 : 0;
    n_active += any ? 1 : 0;
  }
  __syncwarp();
  if (!valid) return;

  const bool xf = A.tw == 32;
  Scene S;
  S.tbl = s_f;
  S.meta = s_meta;
  S.wflags = wflags;
  S.tw = A.tw;
  S.ns = A.ns;
  S.n_rows = A.n_rows;
  S.n_classes = A.n_classes;
  S.cls_off = A.cls_off;
  S.c_lid = xf ? 26 : 4;
  S.c_cov = S.c_lid + 1;
  S.c_mat = S.c_lid + 2;
  S.c_par = S.c_lid + 3;
  S.c_kind = S.c_lid + 4;
  S.xf = xf;
  S.noid = (float)(A.Lp + 1);
  const Ray R = make_ray(o, d);

  // ---- pass 1: has_below, the minimum start, the chain seed -------------
  bool has_below = false;
  float t_entry = kPadT, E = kNeg;
  for_each_cov(S, R, [&](float s, float e) {
    if (s < kEps) {
      has_below = true;
      E = fmaxf(E, e);
    }
    t_entry = fminf(t_entry, s);
  });
  // ---- the chain-exit fixpoint E <- max(E, max{e : s <= E}) ---------------
  int passes = 0;
  if (has_below) {
    while (true) {
      float En = E;
      for_each_cov(S, R, [&](float s, float e) {
        if (s <= E) En = fmaxf(En, e);
      });
      ++passes;
      if (En == E) break;
      E = En;
    }
  }
  const float t_star = has_below ? E : t_entry;
  const bool entering = !has_below;
  const bool hit = (t_star < 2e20f) && !(t_star >= kMaxValue);

  // ---- payload: the smallest leaf id whose raw t0 (then t1) is t_star ----
  float t_rep = 0.f;
  Vec3 n = {0.f, 0.f, 1.f};
  int evt = 0, mat = 0;
  if (hit) {
    float m_start = S.noid, m_end = S.noid;
    for (int r = 0; r < S.n_rows; ++r) {
      if (r < S.ns && !wflags[r / kCluster]) {
        r = min(S.ns, (r / kCluster + 1) * kCluster) - 1;   // skip the culled cluster
        continue;
      }
      float t0, t1;
      row_iv(S, r, R, t0, t1);
      const float lid = S.tbl[r * S.tw + S.c_lid];
      if (t0 == t_star) m_start = fminf(m_start, lid);
      if (t1 == t_star) m_end = fminf(m_end, lid);
    }
    const float chosen = m_start < S.noid ? m_start : m_end;
    const int leaf = m_start < S.noid ? (int)m_start : min((int)m_end, A.L - 1);
    evt = m_start < S.noid ? leaf : A.L + leaf;
    // ---- replay forward of the winner's row (megasweep.py:459-541) -------
    const float* p = S.tbl + s_meta[(int)chosen] * S.tw;
    const float p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
    const bool is_sph = p[S.c_kind] > 0.5f;
    const float inv_r = 1.f / (p3 == 0.f ? 1.f : p3);
    Vec3 n0;
    if (xf) {
      const float* w = p + 5;
      const float lox = w[0] * o.x + w[1] * o.y + w[2] * o.z + w[3];
      const float loy = w[4] * o.x + w[5] * o.y + w[6] * o.z + w[7];
      const float loz = w[8] * o.x + w[9] * o.y + w[10] * o.z + w[11];
      const float ldx = w[0] * d.x + w[1] * d.y + w[2] * d.z;
      const float ldy = w[4] * d.x + w[5] * d.y + w[6] * d.z;
      const float ldz = w[8] * d.x + w[9] * d.y + w[10] * d.z;
      const float pim = p[4];
      const float ex = is_sph ? (lox - p0 + t_star * ldx) * inv_r : p0 * pim;
      const float ey = is_sph ? (loy - p1 + t_star * ldy) * inv_r : p1 * pim;
      const float ez = is_sph ? (loz - p2 + t_star * ldz) * inv_r : p2 * pim;
      const float* m = p + 17;                 // W^-T, row-major
      n0 = {m[0] * ex + m[1] * ey + m[2] * ez, m[3] * ex + m[4] * ey + m[5] * ez,
            m[6] * ex + m[7] * ey + m[8] * ez};
    } else {
      const float pim = 1.f / sqrtf(fmaxf(p0 * p0 + p1 * p1 + p2 * p2, 1e-30f));
      n0 = {is_sph ? (o.x - p0 + t_star * d.x) * inv_r : p0 * pim,
            is_sph ? (o.y - p1 + t_star * d.y) * inv_r : p1 * pim,
            is_sph ? (o.z - p2 + t_star * d.z) * inv_r : p2 * pim};
    }
    const float mag = sqrtf(n0.x * n0.x + n0.y * n0.y + n0.z * n0.z);
    const float inv_m = 1.f / (mag == 0.f ? 1.f : mag);
    const float sign = p[S.c_par] * (entering ? 1.f : -1.f) * inv_m;
    n = {n0.x * sign, n0.y * sign, n0.z * sign};
    t_rep = t_star;
    mat = (int)p[S.c_mat];
  }

  if (A.stats) {
    A.stats[2 * lane] = passes;
    A.stats[2 * lane + 1] = n_active;
  }
  A.evt[lane] = evt;
  A.mat[lane] = mat;
  A.t[lane] = t_rep;
  if (!A.thr) {
    store3(A.normal, lane, n);
    A.flags[lane] = (hit ? 1 : 0) | (entering ? 2 : 0);
    return;
  }
  // ---- bounce mode: shade and scatter (shade_lane.cuh) -------------------
  const ptx_shade::Shaded r = ptx_shade::shade_lane(
      hit, entering, t_rep, n, s_f + A.mat_off + ptx_shade::kMatStride * mat, o, d,
      load3(A.thr, lane), A.strength[lane], A.alive[lane] != 0, A.u_coin[lane],
      A.u3[3 * lane], A.u3[3 * lane + 1], A.u3[3 * lane + 2], A.in_depth);
  store3(A.o2, lane, r.o2);
  store3(A.d2, lane, r.d2);
  store3(A.thr2, lane, r.thr2);
  A.strength2[lane] = r.strength2;
  A.flags[lane] = r.flags;
  store3(A.u_sel, lane, r.u);
}

}  // namespace

// Shared memory one block needs: the scene floats, the int table and the
// cull flags of its warps (the wrapper checks it against the card's limit).
extern "C" int ptx_megasweep_smem(int scene_words, int meta_words, int n_flags) {
  return (int)(sizeof(float) * scene_words + sizeof(int) * (meta_words + kWarps * n_flags));
}

// C entry point (ctypes): one launch on `stream`, no synchronisation;
// returns cudaGetLastError().  Bounce mode when `thr` is non-null.
extern "C" int ptx_megasweep(
    const float* scene, int scene_words, const int* meta, int meta_words, int L, int Lp,
    int ns, int n_rows, int tw, int n_flags, int mat_off, int bnd_off, int cls_off,
    int n_classes, int cull, const float* o, const float* d, int B, const float* thr,
    const float* strength, const uint8_t* alive, const float* u_coin, const float* u3,
    int in_depth, float* t, float* normal, int* flags, int* evt, int* mat, float* o2,
    float* d2, float* thr2, float* strength2, float* u_sel, int* stats, void* stream) {
  if (L < 1 || B < 1 || (tw != 16 && tw != 32)) return (int)cudaErrorInvalidValue;
  const Args A = {scene, scene_words, meta, meta_words, L, Lp, ns, n_rows, tw, n_flags,
                  mat_off, bnd_off, cls_off, n_classes, cull, o, d, B, thr, strength,
                  alive, u_coin, u3, in_depth, t, normal, flags, evt, mat, o2, d2, thr2,
                  strength2, u_sel, stats};
  const size_t smem = (size_t)ptx_megasweep_smem(scene_words, meta_words, n_flags);
  cudaError_t err = cudaFuncSetAttribute(megasweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  megasweep_kernel<<<(B + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
