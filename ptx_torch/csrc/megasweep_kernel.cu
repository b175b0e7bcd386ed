// The megasweep (K5) for NVIDIA Hopper (sm_90a): the union-sweep first hit
// of a large scene, one thread per ray, in hit mode (t, normal, decisions)
// or bounce mode (the first hit, then shade_lane.cuh's shading and scatter,
// in the same launch).
//
// Replaces ptx/ops/megasweep.py:589 build_mega_sweep, the Pallas TPU
// kernel.  Its plain PyTorch version is ptx_torch/ops/megasweep.py
// megasweep_reference (and, in bounce mode, bounce_reference on it); the
// wrapper there (MegaSweepKernel) packs the scene and the row layout.
//
// What bounds it on this card.  Arithmetic: one pass evaluates one interval
// per live table row, ~25 float operations, a square root and two IEEE
// divisions per (row, ray) for a sphere, at L ~ 270 rows ~7,000 operations
// a ray; a lane moves ~130 bytes in bounce mode (o, d, thr, strength,
// alive, u_coin, u3 in; t, o2, d2, thr2, strength2, five decision bytes,
// evt, mat_id, u_sel out).
//
// Design.
// - The TPU kernel keeps two (Lp, 512) interval scratches in VMEM; 2·Lp
//   floats a ray do not fit Hopper's shared memory for a block of rays.
//   Here pass 1 evaluates every live row once and keeps, per lane, two
//   short lists in shared-memory columns ([slot][thread], no bank
//   conflicts): the valid coverage intervals (s, e) that start at or past
//   EPS and end past the running chain seed (the only ones the fixpoint
//   can use), and the indices of the rows whose raw interval is not PAD and
//   ends at or past EPS (the only rows whose t0 or t1 can equal a hit time,
//   which is >= EPS).  The fixpoint walks the first list, the payload
//   recomputes just the rows of the second: 3-50 of 264-288 rows on the
//   stress scenes.  Every reduction there is a min or a max (or the
//   smallest leaf id at an equal time), so the walk order cannot change a
//   bit.  A lane whose list outgrows its capacity takes the recompute
//   route for that step: the fixpoint over every coverage interval, the
//   payload over every live row, as the first version did.  Both routes
//   give the same bits; the capacities are launch arguments.
// - A gadget's coverage is its slots, each (s, e) a postfix program over its
//   members' t0 / t1, -MAX, +MAX, max and min (no per-scene code
//   generation).  Its member intervals and the program stack live in
//   shared-memory columns sized by the scene (2 x members, the deepest
//   program), the stack's top in a register: nothing is indexed at run
//   time in local memory.  Every slot of a lens, a bulb or a bite starts at
//   a max over one member's t0 (its anchor, found on the host): where that
//   member misses, the start is PAD and every slot empty, so the programs
//   are skipped (the member rows are still evaluated and listed).
// - The rows of a gadget whose class cluster is culled are still read by
//   the payload where their own row cluster is live (the plain version's
//   payload reads every row); pass 1 evaluates those rows and lists them,
//   without running the gadget's programs.
// - The chain-exit fixpoint runs per lane until its E stops changing: the
//   recurrence is monotone and stays put once fixed, so a lane's value
//   equals that of the TPU's block-wide loop.
// - Culling is a pure skip: each warp tests every cluster bound once
//   (__any_sync of the per-ray test, block_hits in the plain version) and
//   skips a cluster no lane of it meets; a culled row reads as a miss (PAD),
//   which is what it is for those rays.  `cull` = 0 turns the test off; the
//   outputs do not depend on it.
// - A persistent grid: a few blocks an SM (as many as the shared memory
//   allows), each copying the scene once and striding over 128-lane tiles.
//   The shared-memory attribute and the occupancy are set and read once
//   per size.
// - Bounce mode writes what the fused bounce returns (hit, entering,
//   take_transmit, scatter_alive, alive2 as bytes; mat_id as int64), so a
//   bounce is its allocations and one launch.
// - The payload is the smallest leaf id whose raw t0 (then t1) equals the
//   first boundary bitwise; the replay forward of that row gives t and the
//   normal with the formulas of megasweep.py:459-541.  A lane that does not
//   hit skips the payload: its outputs are the miss placeholders, and
//   bounce mode shades it with material 0, as the plain bounce does.
// - Built with -fmad=false, every expression in the plain version's order,
//   so each operation rounds once, as PyTorch's separate ops do.

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
constexpr int kClusterShift = 6;         // 64 rows (gadgets) a cull cluster: megasweep.CLUSTER
constexpr float kNeg = -3e20f;
constexpr int kStats = 6;                // stats columns a lane

struct Args {
  const float* scene;
  int scene_words;
  const int* meta;
  int meta_words;
  int L, Lp, ns, n_rows, tw, n_flags, mat_off, bnd_off, cls_off, n_classes, cull;
  int cov_cap, row_cap, n_mt, n_stk;    // list capacities, gadget scratch columns
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
  int* flags;                           // hit mode: bits hit, entering
  int* evt;
  int* mat;                             // hit mode
  float* o2;                            // bounce mode, to u_sel
  float* d2;
  float* thr2;
  float* strength2;
  float* u_sel;
  uint8_t* hit;
  uint8_t* entering;
  uint8_t* take_transmit;
  uint8_t* scatter_alive;
  uint8_t* alive2;
  int64_t* mat_id;
  int* stats;                           // optional: kStats ints a lane
};

// the columns of a table row the kernel reads: 9 of 16 (geometry, lid cov
// mat par kind), 31 of 32 with the per-row affines
__host__ __device__ __forceinline__ int table_stride(int tw) { return tw == 32 ? 31 : 9; }

struct Ray {
  Vec3 o, d;
  float a, sa;
  bool a_ok;
};

__device__ __forceinline__ Ray make_ray(Vec3 o, Vec3 d) {
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  return {o, d, a, a == 0.f ? 1.f : a, a != 0.f};
}

// A thread's column of a [slot][thread] shared-memory array.
template <class T>
struct Col {
  T* p;
  __device__ __forceinline__ T& operator[](int k) const { return p[k * kThreads]; }
};

// the shared-memory scene of one block, this warp's cull flags and this
// thread's scratch columns
struct Scene {
  const float* tbl;
  const int* meta;
  const int* wflags;
  int tw, ns, n_rows, n_classes, cls_off, c_lid, c_cov, c_mat, c_par, c_kind;  // tw: row stride
  bool xf;
  float noid;
  Col<float> mt;                        // member j's t0 at 2j, t1 at 2j + 1
  Col<float> stk;                       // the program stack below its top
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

// one sphere row's raw interval (PAD on a miss and on a pad row)
__device__ __forceinline__ void sphere_iv(const Scene& S, int r, const Ray& R0, float& t0,
                                          float& t1) {
  const float* p = S.tbl + r * S.tw;
  const Ray R = row_ray(S, p, R0);
  const bool real = p[S.c_lid] < S.noid;
  const float ocx = R.o.x - p[0], ocy = R.o.y - p[1], ocz = R.o.z - p[2];
  const float rad = p[3];
  const float b = ocx * R.d.x + ocy * R.d.y + ocz * R.d.z;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - R.a * cc;
  const bool ok = (disc > kEps) && R.a_ok && real;
  const float sq = sqrtf(ok ? disc : 1.f);
  t0 = ok ? (-b - sq) / R.sa : kPadT;
  t1 = ok ? (-b + sq) / R.sa : kPadT;
}

// one plane row's raw interval (PAD on a miss and on a pad row)
__device__ __forceinline__ void plane_iv(const Scene& S, int r, const Ray& R0, float& t0,
                                         float& t1) {
  const float* p = S.tbl + r * S.tw;
  const Ray R = row_ray(S, p, R0);
  const bool real = p[S.c_lid] < S.noid;
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

// one row's raw interval: sphere rows come before row ns
__device__ __forceinline__ void row_iv(const Scene& S, int r, const Ray& R, float& t0,
                                       float& t1) {
  if (r < S.ns)
    sphere_iv(S, r, R, t0, t1);
  else
    plane_iv(S, r, R, t0, t1);
}

// A slot program over the member columns; the stack's top in a register,
// the rest in the thread's stack column.
__device__ __forceinline__ float eval_prog(const Scene& S, const int* prog, int len) {
  float top = 0.f;
  int sp = 0;                            // entries below the top
  for (int i = 0; i < len; ++i) {
    const int op = prog[i];
    if (op >= -2) {
      if (i > 0) S.stk[sp++] = top;
      top = op >= 0 ? S.mt[op] : (op == -1 ? -kMaxValue : kMaxValue);
    } else {
      const float a = S.stk[--sp];
      top = op == -3 ? fmaxf(a, top) : fminf(a, top);
    }
  }
  return top;
}

__device__ __forceinline__ bool row_live(const Scene& S, int r) {
  return !(r < S.ns && !S.wflags[r >> kClusterShift]);
}

// The leaf-group rows (cov = 1) of [r0, r1), all spheres or all planes, as
// for_each_cov meets them: two rows a step, both intervals computed before
// either is used, so that the two chains interleave.
template <bool kRecord, bool kSphere, class F, class Rec>
__device__ __forceinline__ void leaf_rows(const Scene& S, const Ray& R, int r0, int r1, F& f,
                                          Rec& rec) {
  const auto iv = [&](int r, float& t0, float& t1) {
    if constexpr (kSphere)
      sphere_iv(S, r, R, t0, t1);
    else
      plane_iv(S, r, R, t0, t1);
  };
  for (int r = r0; r < r1; r += 2) {
    const int q = min(r + 1, r1 - 1);
    const bool c0 = S.tbl[r * S.tw + S.c_cov] != 0.f;
    const bool c1 = q != r && S.tbl[q * S.tw + S.c_cov] != 0.f;
    if (!(c0 || c1)) continue;
    float a0, a1, b0, b1;
    iv(r, a0, a1);
    iv(q, b0, b1);
    if (c0) {
      if (kRecord) rec(r, a0, a1, false);
      if (a0 < a1 && a1 >= kEps) f(a0, a1);
    }
    if (c1) {
      if (kRecord) rec(q, b0, b1, false);
      if (b0 < b1 && b1 >= kEps) f(b0, b1);
    }
  }
}

// Calls f(s, e) for every valid coverage interval of the ray: leaf-group
// rows (cov = 1) and every gadget's slots; with kRecord, also rec(r, t0, t1,
// culled) for every row it evaluates, the live member rows of culled
// gadgets included (culled true: their programs do not run).  Culled
// clusters are skipped.
template <bool kRecord, class F, class Rec>
__device__ __forceinline__ void for_each_cov(const Scene& S, const Ray& R, F f, Rec rec) {
  const int n_sc = (S.ns + (1 << kClusterShift) - 1) >> kClusterShift;
  for (int k = 0; k < n_sc; ++k) {
    if (!S.wflags[k]) continue;
    leaf_rows<kRecord, true>(S, R, k << kClusterShift, min(S.ns, (k + 1) << kClusterShift), f, rec);
  }
  leaf_rows<kRecord, false>(S, R, S.ns, S.n_rows, f, rec);
  for (int c = 0; c < S.n_classes; ++c) {
    const int* h = S.meta + S.meta[S.cls_off + c];
    const int G = h[0], m = h[2], n_slots = h[3], f0 = h[4], anchor = h[5];
    const int* mrow = h + 6;
    const int* slots = mrow + m;
    for (int g = 0; g < G; ++g) {
      if (!S.wflags[f0 + (g >> kClusterShift)]) {
        if (kRecord) {
          for (int j = 0; j < m; ++j) {
            const int r = mrow[j] + g;
            if (!row_live(S, r)) continue;
            float t0, t1;
            row_iv(S, r, R, t0, t1);
            rec(r, t0, t1, true);
          }
        }
        continue;
      }
      for (int j = 0; j < m; ++j) {
        const int r = mrow[j] + g;
        float t0 = kPadT, t1 = kPadT;
        if (row_live(S, r)) {
          row_iv(S, r, R, t0, t1);
          if (kRecord) rec(r, t0, t1, false);
        }
        S.mt[2 * j] = t0;
        S.mt[2 * j + 1] = t1;
      }
      // every slot starts at max(..., t0 of the anchor): PAD, an empty slot
      if (anchor >= 0 && S.mt[2 * anchor] == kPadT) continue;
      for (int q = 0; q < n_slots; ++q) {
        const int* sl = slots + 4 * q;
        const float s = eval_prog(S, S.meta + sl[0], sl[1]);
        const float e = eval_prog(S, S.meta + sl[2], sl[3]);
        if (s < e && e >= kEps) f(s, e);
      }
    }
  }
}

struct NoRec {
  __device__ __forceinline__ void operator()(int, float, float, bool) const {}
};

__device__ __forceinline__ Vec3 load3(const float* p, int lane) {
  return {p[3 * lane], p[3 * lane + 1], p[3 * lane + 2]};
}

__device__ __forceinline__ void store3(float* p, int lane, Vec3 v) {
  p[3 * lane] = v.x;
  p[3 * lane + 1] = v.y;
  p[3 * lane + 2] = v.z;
}

// The payload's match of one row: the smallest leaf id whose raw t0 (then
// t1) is t_star.
__device__ __forceinline__ void match_row(const Scene& S, int r, const Ray& R, float t_star,
                                          float& m_start, float& m_end) {
  float t0, t1;
  row_iv(S, r, R, t0, t1);
  const float lid = S.tbl[r * S.tw + S.c_lid];
  if (t0 == t_star) m_start = fminf(m_start, lid);
  if (t1 == t_star) m_end = fminf(m_end, lid);
}

// at least 4 blocks an SM: ptxas then keeps the lane in 76 registers without
// spills (it chose 64 with spills when left free)
__global__ void __launch_bounds__(kThreads, 4) megasweep_kernel(const Args A) {
  extern __shared__ float smem[];
  // the table with its used columns only (row stride 9, or 31 transformed),
  // then the rest of the scene vector (material scalars, cull bounds)
  const int stride = table_stride(A.tw), tbl_words = A.Lp * A.tw;
  float* s_f = smem;
  float* s_rest = s_f + A.Lp * stride;
  int* s_meta = reinterpret_cast<int*>(s_rest + (A.scene_words - tbl_words));
  int* s_flags = s_meta + A.meta_words;                    // kWarps x n_flags
  float* s_cov = reinterpret_cast<float*>(s_flags + kWarps * A.n_flags);
  float* s_mt = s_cov + 2 * A.cov_cap * kThreads;
  uint16_t* s_rows = reinterpret_cast<uint16_t*>(s_mt + (A.n_mt + A.n_stk) * kThreads);
  for (int i = threadIdx.x; i < A.Lp * stride; i += kThreads) {
    const int r = i / stride;
    s_f[i] = A.scene[r * A.tw + (i - r * stride)];
  }
  for (int i = threadIdx.x; i < A.scene_words - tbl_words; i += kThreads)
    s_rest[i] = A.scene[tbl_words + i];
  for (int i = threadIdx.x; i < A.meta_words; i += kThreads) s_meta[i] = A.meta[i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const float* bnd = s_rest + (A.bnd_off - tbl_words);
  int* wflags = s_flags + warp * A.n_flags;
  const Col<float> cov_s = {s_cov + threadIdx.x};
  const Col<float> cov_e = {s_cov + A.cov_cap * kThreads + threadIdx.x};
  const Col<uint16_t> rows = {s_rows + threadIdx.x};

  const bool xf = A.tw == 32;
  Scene S;
  S.tbl = s_f;
  S.meta = s_meta;
  S.wflags = wflags;
  S.tw = stride;
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
  S.mt = {s_mt + threadIdx.x};
  S.stk = {s_mt + A.n_mt * kThreads + threadIdx.x};

  // a persistent grid: the block strides over tiles of kThreads lanes
  for (int base = blockIdx.x * kThreads; base < A.B; base += gridDim.x * kThreads) {
    const int lane = base + threadIdx.x;
    const bool valid = lane < A.B;
    const Vec3 o = valid ? load3(A.o, lane) : Vec3{0.f, 0.f, 0.f};
    const Vec3 d = valid ? load3(A.d, lane) : Vec3{0.f, 0.f, 1.f};

    // cull flags of this warp: does any of its rays meet the bound?
    const float a = d.x * d.x + d.y * d.y + d.z * d.z;
    int n_active = 0;
    __syncwarp();                        // the previous tile's flags are read
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
    if (!valid) continue;
    const Ray R = make_ray(o, d);

    // ---- pass 1: has_below, the minimum start, the chain seed; the lists --
    bool has_below = false;
    float t_entry = kPadT, E = kNeg;
    int n_cov = 0, n_row = 0, n_culled = 0;
    for_each_cov<true>(
        S, R,
        [&](float s, float e) {
          if (s < kEps) {
            has_below = true;
            E = fmaxf(E, e);
          } else if (e > E) {            // e <= E can never move the fixpoint
            if (n_cov < A.cov_cap) {
              cov_s[n_cov] = s;
              cov_e[n_cov] = e;
            }
            ++n_cov;
          }
          t_entry = fminf(t_entry, s);
        },
        [&](int r, float t0, float t1, bool culled) {
          n_culled += culled ? 1 : 0;
          if (t0 != kPadT && t1 >= kEps) {
            if (n_row < A.row_cap) rows[n_row] = (uint16_t)r;
            ++n_row;
          }
        });
    const bool cov_over = n_cov > A.cov_cap, row_over = n_row > A.row_cap;

    // ---- the chain-exit fixpoint E <- max(E, max{e : s <= E}) -------------
    int passes = 0;
    if (has_below) {
      while (true) {
        float En = E;
        if (!cov_over) {
          for (int k = 0; k < n_cov; ++k)
            if (cov_s[k] <= E) En = fmaxf(En, cov_e[k]);
        } else {
          for_each_cov<false>(
              S, R, [&](float s, float e) {
                if (s <= E) En = fmaxf(En, e);
              },
              NoRec{});
        }
        ++passes;
        if (En == E) break;
        E = En;
      }
    }
    const float t_star = has_below ? E : t_entry;
    const bool entering = !has_below;
    const bool hit = (t_star < 2e20f) && !(t_star >= kMaxValue);

    // ---- payload: the smallest leaf id whose raw t0 (then t1) is t_star --
    float t_rep = 0.f;
    Vec3 n = {0.f, 0.f, 1.f};
    int evt = 0, mat = 0;
    if (hit) {
      float m_start = S.noid, m_end = S.noid;
      if (!row_over) {
        for (int k = 0; k < n_row; ++k) match_row(S, rows[k], R, t_star, m_start, m_end);
      } else {
        for (int r = 0; r < S.n_rows; ++r) {
          if (!row_live(S, r)) {             // skip the culled cluster
            r = min(S.ns, ((r >> kClusterShift) + 1) << kClusterShift) - 1;
            continue;
          }
          match_row(S, r, R, t_star, m_start, m_end);
        }
      }
      const float chosen = m_start < S.noid ? m_start : m_end;
      const int leaf = m_start < S.noid ? (int)m_start : min((int)m_end, A.L - 1);
      evt = m_start < S.noid ? leaf : A.L + leaf;
      // ---- replay forward of the winner's row (megasweep.py:459-541) -----
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
      int* st = A.stats + kStats * lane;
      st[0] = passes;
      st[1] = n_active;
      st[2] = n_cov;
      st[3] = n_row;
      st[4] = n_culled;
      st[5] = (hit ? 1 : 0) | (cov_over ? 2 : 0) | (row_over ? 4 : 0);
    }
    A.evt[lane] = evt;
    A.t[lane] = t_rep;
    if (!A.thr) {
      A.mat[lane] = mat;
      store3(A.normal, lane, n);
      A.flags[lane] = (hit ? 1 : 0) | (entering ? 2 : 0);
      continue;
    }
    // ---- bounce mode: shade and scatter (shade_lane.cuh) ---------------
    const ptx_shade::Shaded r = ptx_shade::shade_lane(
        hit, entering, t_rep, n, s_rest + (A.mat_off - tbl_words) + ptx_shade::kMatStride * mat,
        o, d,
        load3(A.thr, lane), A.strength[lane], A.alive[lane] != 0, A.u_coin[lane],
        A.u3[3 * lane], A.u3[3 * lane + 1], A.u3[3 * lane + 2], A.in_depth);
    store3(A.o2, lane, r.o2);
    store3(A.d2, lane, r.d2);
    store3(A.thr2, lane, r.thr2);
    A.strength2[lane] = r.strength2;
    A.hit[lane] = (r.flags & 1) != 0;
    A.entering[lane] = (r.flags & 2) != 0;
    A.take_transmit[lane] = (r.flags & 4) != 0;
    A.scatter_alive[lane] = (r.flags & 8) != 0;
    A.alive2[lane] = (r.flags & 16) != 0;
    A.mat_id[lane] = mat;
    store3(A.u_sel, lane, r.u);
  }
}

}  // namespace

// Shared memory one block needs: the scene floats (the table's used
// columns), the int table, the cull flags of its warps and the thread
// columns (the coverage list, the gadget scratch, the row list); the
// wrapper checks it against the card's limit.
extern "C" int ptx_megasweep_smem(int scene_words, int Lp, int tw, int meta_words, int n_flags,
                                  int cov_cap, int row_cap, int n_mt, int n_stk) {
  const int words = scene_words - Lp * (tw - table_stride(tw));
  return (int)(sizeof(float) * words + sizeof(int) * (meta_words + kWarps * n_flags) +
               kThreads * (sizeof(float) * (2 * cov_cap + n_mt + n_stk) +
                           sizeof(uint16_t) * row_cap));
}

// C entry point (ctypes): one launch on `stream`, no synchronisation;
// returns cudaGetLastError().  Bounce mode when `thr` is non-null; a null
// output is not written.
extern "C" int ptx_megasweep(
    const float* scene, int scene_words, const int* meta, int meta_words, int L, int Lp,
    int ns, int n_rows, int tw, int n_flags, int mat_off, int bnd_off, int cls_off,
    int n_classes, int cull, int cov_cap, int row_cap, int n_mt, int n_stk, const float* o,
    const float* d, int B, const float* thr, const float* strength, const uint8_t* alive,
    const float* u_coin, const float* u3, int in_depth, float* t, float* normal, int* flags,
    int* evt, int* mat, float* o2, float* d2, float* thr2, float* strength2, float* u_sel,
    uint8_t* hit, uint8_t* entering, uint8_t* take_transmit, uint8_t* scatter_alive,
    uint8_t* alive2, int64_t* mat_id, int* stats, void* stream) {
  if (L < 1 || B < 1 || (tw != 16 && tw != 32) || cov_cap < 0 || row_cap < 0 ||
      n_rows > 65536)
    return (int)cudaErrorInvalidValue;
  const Args A = {scene, scene_words, meta, meta_words, L, Lp, ns, n_rows, tw, n_flags,
                  mat_off, bnd_off, cls_off, n_classes, cull, cov_cap, row_cap, n_mt, n_stk,
                  o, d, B, thr, strength, alive, u_coin, u3, in_depth, t, normal, flags, evt,
                  mat, o2, d2, thr2, strength2, u_sel, hit, entering, take_transmit,
                  scatter_alive, alive2, mat_id, stats};
  const int smem = ptx_megasweep_smem(scene_words, Lp, tw, meta_words, n_flags, cov_cap,
                                      row_cap, n_mt, n_stk);
  // the opt-in and the occupancy, once per size
  static int opted = 0, occ_smem = -1, occ_blocks = 0, n_sm = 0;
  cudaError_t err;
  if (smem > opted) {
    err = cudaFuncSetAttribute(megasweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  if (smem != occ_smem) {
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, megasweep_kernel,
                                                             kThreads, smem)) != cudaSuccess)
      return (int)err;
    if (occ_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  const int tiles = (B + kThreads - 1) / kThreads;
  const int grid = tiles < occ_blocks * n_sm ? tiles : occ_blocks * n_sm;
  megasweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
