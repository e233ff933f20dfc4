// Pair kernels of the sparse path and the K2 of the fused path and the
// blocked layout, hand-written for Hopper (sm_90a).
//
// K1  moments_v4_kernel      replaces softbody_tpu/ops/pallas/pair_kernels.py
//                            :: _moments_kernel_v4 (launched by
//                            ops/pallas/packed.py :: _moments_v4_fwd)
// K2  forces_warp_v4_kernel  replaces softbody_tpu/ops/pallas/pair_kernels.py
//                            :: _forces_warp_kernel_v4 (launched by
//                            ops/pallas/packed.py :: _forces_warp_v4_fwd_srT)
// K2  forces_warp_v2_kernel  replaces softbody_tpu/ops/pallas/pair_kernels.py
//                            :: _forces_warp_kernel_v2 (launched by
//                            ops/pallas/packed.py :: _forces_warp_packed_fwd):
//                            the fused path's and the blocked layout's K2
// K1  moments_mid_kernel     replaces softbody_tpu/ops/pallas/pair_kernels.py
//     + mid-section          :: _moments_mid_kernel (launched by
//                            ops/pallas/packed.py :: _fused_call): the fused
//                            path's K1, K1 v4's sums with the per-row
//                            mid-section (mid.cuh) as its epilogue
// The backward kernels, the Taichi pairing's separable K2 and its backward
// and the fixed-order scatter follow the forward ones, each with its own
// note (further down).
//
// What they compute (per tile of ROWS = 32 slot rows against its candidate
// slab of `slab` slots, slot = gidx[tile, e / group] * group + e % group):
//   K1: lhs = [-w m_j dx ; gfac V_j dx] (6 blocks); out row 3*blk + a =
//       sum_j (pos_j - pos_i)_a lhs_blk, the moments centered on each row's
//       own position.  (The TPU kernel and the plain version form
//       sum_j (pos_j - c)_a lhs_blk - (pos_i - c)_a sum_j lhs_blk with c the
//       tile's first rest row: the same sums, one subtraction per pair
//       instead of 6 row sums and 6 accumulators.)
//   K2: nw = gfac V_j dx, Z_d = sum_b nw_b S_j[d, b], u = F_i Z,
//       termj_a = sum_j (R_j u)_a.  (The TPU kernel summed D = R^T Z over
//       the slab and applied F_i after; applying F_i per pair needs 3
//       accumulators instead of 27 and 18 instead of 27 multiply-adds.)
//       v4 stores termj; v2 reads the row record fmT = F_9 | M_9 | V_i and
//       stores f_a = 0.5 V_i (termj_a + sum_b M_i[a][b] svnw_b), svnw_b =
//       sum_j nw_b.  svnw depends on rest geometry and volumes only, so v2
//       reads it from the scene's static row sums rs6T[3:6] (host f64 over
//       the true pairs on the sparse scene, the raw K1 on an all-ones RHS
//       on the blocked one), as the default path applies it: the same
//       function as the TPU kernel's in-kernel sum, its pair loop exactly
//       K2 v4's, with no 3 extra live sums.
//   Pair coefficients use the rsqrt form: rs = rsqrt(r2 + 1e-30) and the
//   gradient polynomial is exactly zero at q = 0, so the self pair needs no
//   mask; padding slots sit on a far grid, so their coefficients vanish.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
//   the kernels are OPERATION-bound.  Per pair K1 does 72 flops and K2 74
//   (in about 51 and 56 issued instructions, softbody_tpu_torch/
//   pair_times.py counts them); per slab entry K1 stages 8 values and K2
//   19, each serving all 32 rows of the tile.  At the ~112k stretch scene
//   (72.4 M candidate pairs per force evaluation on the sparse scene,
//   288.3 M on the blocked varcol one) that is ~0.08 ms per evaluation for
//   each kernel on the sparse scene and ~0.11-0.12 ms of instruction issue
//   at 4 warp-instructions per clock per SM at 1.98 GHz (chip_smoke.py
//   computes the exact bound from the run's shapes).
// What the design does about it:
//   * One launch per force evaluation over every tile of every bucket (the
//     sparse layout's 8 buckets used to be 8 launches, two of them with
//     fewer tiles than the card has SMs).  A host-built schedule
//     (SparseBlocked.schedule, Blocked.schedule: tile, slab, offsets into
//     the scene's flat static slab and gidx arrays) lists the tiles longest
//     slab first, so the long tiles start first and the short ones fill
//     the tail.
//   * Balanced blocks: one block of RG_WARPS = 4 warps per tile, one lane
//     per tile row, the warps splitting the slab in CH = 32-entry chunks,
//     warp w taking chunks [w n / 4, (w + 1) n / 4) of the slab's n: the
//     sparse scene's slabs are multiples of 128 entries, so its warps walk
//     equal shares, and the blocked layout's 1,944 (61 chunks) split
//     15 / 15 / 15 / 16.  No block walks more than 1.7x the mean on the
//     sparse scene (slab 1024 against a mean of 599); 4 warps per tile ran
//     faster on the card than 8 (more, smaller blocks per SM: at 96
//     registers 5 blocks, 20 warps, fit on an SM; a tighter register bound
//     spilled and ran slower), and with one launch the few long tiles
//     start first instead of forming a launch of their own.  The warps'
//     partial sums meet in shared memory and add in warp order: fixed
//     order, no atomics, bitwise repeatable.
//   * Asynchronous staging: each warp keeps a ring of NSTAGE = 2 stages of
//     CH slab entries in shared memory, fields side by side, filled by
//     16-byte cp.async copies (the tile's static slab rows, and through
//     gidx the 8-slot groups of the gathered fields: 32 contiguous bytes
//     per group in f32, 64 in f64) while the warp computes the previous
//     stage; cp.async.wait_group and a warp barrier order the ring.  The
//     stage is read back as 16-byte broadcasts of 4 entries per field.
//   * The fused path's K1 (moments_mid) is K1 v4's kernel with the
//     mid-section as its epilogue: after the fixed-order sum over warps, one
//     thread per row gathers its 18 moments and runs the 8-sweep Jacobi
//     polar, F, the StVK S and M in registers (~2,250 flops per row; the
//     other three warps idle while it runs, the SM's other resident blocks
//     keep issuing), then stores the K2 records fmT and srT.  The TPU
//     kernel contracted ABSOLUTE positions and subtracted pos_i * rs6 with
//     the host's static row sums; in f32 that cancellation moves the forces
//     by 5e-5 of their maximum and destabilised a quiet body
//     (pair_kernels.py:512-526); centering per lane is the same function in
//     exact arithmetic, at the v4 path's accuracy.
//   * Ragged tails (K2 v2 on the blocked layout): a slab need only be a
//     multiple of the slot group (8).  The copies of entries past the slab
//     are cp.async's zero-fill form (source size 0; no branch in the
//     loop), so a partial last chunk holds zeros there: V_j = 0 makes every
//     term of those entries vanish, and zero S, R and positions keep them
//     finite.  The bounds checks cost the staging a few instructions per
//     copy (3-5% of K1/K2 v4's time on the card), so they are a template
//     flag: the sparse scene's slabs (multiples of 128) run without them,
//     and the v4 kernels, which serve only the sparse scene, take whole
//     chunks only.
//   * Fewer instructions per pair: K1 centers per lane (p = pos_j - pos_i)
//     and folds cA and gv into p, 24 multiply-adds per pair where 30 were;
//     a prep pass per stage puts the spline constants into m_j and V_j
//     (once per entry, not per pair); rsqrt without its denormal wrapper
//     (its argument is always normal); K2's sums as multiply-add chains.
//   * Plain FP32 FMAs (never TF32 — a reduced-precision dot destabilised
//     the episode on the TPU).
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launch.  Kernels launch on the caller's stream
// and allocate nothing.

#include "common.cuh"
#include "mid.cuh"

namespace {

// ------------------------------------------------------- ragged forward K1/K2
constexpr int RG_WARPS = 4;                  // warps per tile (block)
constexpr int RG_THREADS = 32 * RG_WARPS;
constexpr int CH = 32;                       // slab entries per stage
constexpr int NSTAGE = 2;                    // stages per warp's ring
constexpr int K1_FIELDS = 8;                 // rest_3, m, V | pos_3
constexpr int K2_FIELDS = 19;                // rest_3, V | S_6, R^T_9
constexpr int K1_OUT = 18;
constexpr int K2_OUT = 3;
constexpr int SR_ROWS = 15;                  // the K2 slot record S_6 | R^T_9

template <typename T>
constexpr size_t ragged_smem(int fields, int outs) {
  // the rings, then (aliasing them) the warps' partial sums
  return sizeof(T) * (size_t)(RG_WARPS * (NSTAGE * fields * CH > outs * ROWS
                                              ? NSTAGE * fields * CH
                                              : outs * ROWS));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// A 16-byte copy of which the first `bytes` (16 or 0) come from src and the
// rest are zeros (cp.async's zero-fill form).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rsqrt of a normal float without the denormal-input wrapper (a compare
// and two predicated multiplies per pair): every argument here is
// r2 + 1e-30 >= 1e-30, a normal float, for which both give the same bits.
template <typename T> __device__ __forceinline__ T rsqrt_normal(T x) { return rsqrt(x); }
template <> __device__ __forceinline__ float rsqrt_normal<float>(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The cubic-spline pair polynomials without their constants: with
// rs = rsqrt(r2 + 1e-30) and q = r2 rs / h, w0 = (2-q)+^3 - 4 (1-q)+^3 and
// g0 = (4 (1-q)+^2 - (2-q)+^2) rs, so that w = c4 w0 and gfac = 3 c4h g0
// (common.cuh's spline_w_gfac; K1's prep pass puts c4 into m_j and 3 c4h
// into V_j, once per entry instead of once per pair).  K2 keeps
// g12 = (12 (1-q)+^2 - 3 (2-q)+^2) rs = 3 g0 with c4h in V_j: with the
// factor 3 folded, its loop needed more registers, spilled and ran slower
// on the card.
template <typename T>
__device__ __forceinline__ void pair_poly(T r2, T inv_h, T& w0, T& g0) {
  const T rs = rsqrt_normal(r2 + T(1e-30));
  const T q = r2 * rs * inv_h;
  const T tq = relu(T(2) - q), oq = relu(T(1) - q);
  const T tq2 = tq * tq, oq2 = oq * oq;
  w0 = tq2 * tq - T(4) * oq2 * oq;
  g0 = (T(4) * oq2 - tq2) * rs;
}

template <typename T>
__device__ __forceinline__ T pair_g12(T r2, T inv_h) {
  const T rs = rsqrt_normal(r2 + T(1e-30));
  const T q = r2 * rs * inv_h;
  const T tq = relu(T(2) - q), oq = relu(T(1) - q);
  return (T(12) * oq * oq - T(3) * tq * tq) * rs;
}

// The backward kernels' pair polynomials, the clamps as saturating
// multiply-adds: with t = r2 rs = |dx|, s = sat(1 - t / 2h) = (2-q)+ / 2
// and o = sat(1 - t / h) = (1-q)+,
//   w0 = 8 s^3 - 4 o^3 = 4 w1,  w1 = 2 s^3 - o^3,
//   g0 = 4 (o^2 - s^2) rs = 4 g1,  g1 = (o^2 - s^2) rs,
// the factor 4 going into m_j and V_j with the spline constants: 12
// instructions per pair for both where pair_poly takes 15, 8 for g1 where
// pair_g12 takes 13.  Both clamps' arguments are at most 1, so saturating
// to [0, 1] is the forward's relu.  nih = -1/h, nih2 = -1/(2h).
template <typename T> __device__ __forceinline__ T sat01(T x) { return x > T(0) ? x : T(0); }
template <> __device__ __forceinline__ float sat01<float>(float x) { return __saturatef(x); }

template <typename T>
__device__ __forceinline__ void pair_sat(T r2, T nih, T nih2, T& w1, T& g1) {
  const T rs = rsqrt_normal(r2 + T(1e-30));
  const T t = r2 * rs;
  const T s = sat01(fma(t, nih2, T(1))), o = sat01(fma(t, nih, T(1)));
  const T s2 = s * s, o2 = o * o;
  w1 = T(2) * s2 * s - o2 * o;
  g1 = (o2 - s2) * rs;
}

template <typename T>
__device__ __forceinline__ T pair_g1(T r2, T nih, T nih2) {
  const T rs = rsqrt_normal(r2 + T(1e-30));
  const T t = r2 * rs;
  const T s = sat01(fma(t, nih2, T(1))), o = sat01(fma(t, nih, T(1)));
  return (o * o - s * s) * rs;
}

// Four consecutive stage entries of one field: one 16-byte (f32) or two
// (f64) shared-memory broadcasts.
template <typename T> struct alignas(4 * sizeof(T)) Four { T v[4]; };

template <typename T>
__device__ __forceinline__ Four<T> four(const T* buf, int field, int j) {
  return *reinterpret_cast<const Four<T>*>(buf + field * CH + j);
}

// One stage of a warp's ring: slab entries [e0, e0 + CH) of the tile, field
// f at buf[f * CH + e - e0].  Fields 0..NS-1 are the static slab's rows
// srow[f] (each contiguous in the tile's (5, slab) block); the NG after
// them are rows of the lane-major `src` (stride ld) at the entries' slots,
// gathered per slot group.  Lane l < CH / group holds gval = the gidx of
// the stage's group l (past the slab any valid gidx, its copies being
// zeros).  Every copy is 16 bytes.  With
// TAIL the slab may end inside the stage: the pieces of entries past it (a
// multiple of the group, so a piece is wholly in or out) are zeros, copied
// from an address inside the slab.  Without, every piece is copied as is
// (the bounds checks cost the sparse scene's kernels 3-5% on the card).
template <typename T, int NS, int NG, bool TAIL>
__device__ __forceinline__ void issue_stage(T* buf, const T* __restrict__ st,
                                            int slab, const int (&srow)[NS],
                                            const T* __restrict__ src, int64_t ld,
                                            int e0, int32_t gval, int group,
                                            int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER = CH / VEC;              // 16-byte copies per field
  for (int q = lane; q < NS * PER; q += 32) {
    const int f = q / PER, k = q % PER;
    if constexpr (TAIL) {
      const bool in = e0 + k * VEC < slab;
      cp_async16_zfill(buf + f * CH + k * VEC,
                       st + (int64_t)srow[f] * slab + (in ? e0 + k * VEC : e0),
                       in ? 16 : 0);
    } else {
      cp_async16(buf + f * CH + k * VEC, st + (int64_t)srow[f] * slab + e0 + k * VEC);
    }
  }
  const int gpc = group / VEC;               // copies per group and field
  for (int q0 = 0; q0 < NG * PER; q0 += 32) {   // uniform trip count: shfl below
    const int q = q0 + lane;
    const int k = q % PER;
    const int32_t g = __shfl_sync(0xffffffffu, gval, k / gpc);
    if constexpr (TAIL) {
      if (q < NG * PER)
        cp_async16_zfill(buf + (NS + q / PER) * CH + k * VEC,
                         src + (q / PER) * ld + (int64_t)g * group + (k % gpc) * VEC,
                         e0 + k * VEC < slab ? 16 : 0);
    } else {
      if (q < NG * PER)
        cp_async16(buf + (NS + q / PER) * CH + k * VEC,
                   src + (q / PER) * ld + (int64_t)g * group + (k % gpc) * VEC);
    }
  }
}

// The pipelined walk of one warp over chunks [c0, c1) of its tile: once a
// stage has landed, prep(buf) rescales its entries in place (lane l its
// entries l, l + 32, ...), then stage(buf) consumes it.  gi is the tile's
// gidx row.
template <typename T, int NS, int NG, int FIELDS, bool TAIL, typename Prep,
          typename Stage>
__device__ __forceinline__ void walk_chunks(T* ring, const T* __restrict__ st,
                                            int slab, const int (&srow)[NS],
                                            const T* __restrict__ src, int64_t ld,
                                            const int32_t* __restrict__ gi,
                                            int group, int c0, int c1, int lane,
                                            Prep prep, Stage stage) {
  if (c0 >= c1) return;
  const int ngr = CH / group;
  // lane l < ngr holds the gidx of group l of the chunk (with TAIL, only
  // while that group lies inside the slab; past it the copies are zeros)
  const auto has = [&](int c) {
    if constexpr (TAIL) return lane < ngr && c * ngr + lane < slab / group;
    return lane < ngr;
  };
  int32_t g = has(c0) ? gi[c0 * ngr + lane] : 0;
  issue_stage<T, NS, NG, TAIL>(ring, st, slab, srow, src, ld, c0 * CH, g, group, lane);
  cp_async_commit();
  g = (has(c0 + 1) && c0 + 1 < c1) ? gi[(c0 + 1) * ngr + lane] : 0;
  for (int c = c0; c < c1; ++c) {
    if (c + 1 < c1)
      issue_stage<T, NS, NG, TAIL>(ring + ((c + 1 - c0) % NSTAGE) * (FIELDS * CH),
                                   st, slab, srow, src, ld, (c + 1) * CH, g, group,
                                   lane);
    cp_async_commit();                       // (empty on the last chunk)
    if (has(c + 2) && c + 2 < c1) g = gi[(c + 2) * ngr + lane];   // in flight
    cp_async_wait_prev();                    // this lane's copies of chunk c
    __syncwarp();                            // ... and every other lane's
    T* buf = ring + ((c - c0) % NSTAGE) * (FIELDS * CH);
    prep(buf);
    __syncwarp();
    stage(buf);
    __syncwarp();                            // read before it is refilled
  }
}

// K1's sums of one landed stage for row (xi, pi): acc[3 blk + a] +=
// (pos_j - pos_i)_a lhs_blk, with blocks 0-2 accumulated as +cA p_a dx_k
// (negated in the epilogue).  The stage's m and V fields hold c4 m_j and
// 3 c4h V_j.
template <typename T>
__device__ __forceinline__ void k1_stage(const T* buf, T xi0, T xi1, T xi2,
                                         T pi0, T pi1, T pi2, T inv_h,
                                         T (&acc)[K1_OUT]) {
#pragma unroll 2
  for (int j = 0; j < CH; j += 4) {
    const Four<T> X0 = four(buf, 0, j), X1 = four(buf, 1, j), X2 = four(buf, 2, j);
    const Four<T> Ms = four(buf, 3, j), Vs = four(buf, 4, j);
    const Four<T> P0 = four(buf, 5, j), P1 = four(buf, 6, j), P2 = four(buf, 7, j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T d[3] = {xi0 - X0.v[u], xi1 - X1.v[u], xi2 - X2.v[u]};
      T w0, g0;
      pair_poly(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], inv_h, w0, g0);
      const T cA = w0 * Ms.v[u], gv = g0 * Vs.v[u];
      const T p[3] = {P0.v[u] - pi0, P1.v[u] - pi1, P2.v[u] - pi2};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T q = cA * p[a], g = gv * p[a];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[3 * k + a] += q * d[k];
          acc[9 + 3 * k + a] += g * d[k];
        }
      }
    }
  }
}

// K2's sums of one landed stage for row xi, its F_i given; the stage's V
// field holds c4h V_j.  Each accumulator takes its three terms as one
// multiply-add chain.
template <typename T>
__device__ __forceinline__ void k2_stage(const T* buf, T xi0, T xi1, T xi2,
                                         const T (&F)[9], T inv_h,
                                         T (&acc)[K2_OUT]) {
#pragma unroll 1
  for (int j = 0; j < CH; j += 4) {
    const Four<T> X0 = four(buf, 0, j), X1 = four(buf, 1, j), X2 = four(buf, 2, j);
    const Four<T> Vs = four(buf, 3, j);
    Four<T> S[6], Rt[9];                     // S_6 = [s00 s01 s02 s11 s12 s22]
#pragma unroll
    for (int f = 0; f < 6; ++f) S[f] = four(buf, 4 + f, j);
#pragma unroll
    for (int f = 0; f < 9; ++f) Rt[f] = four(buf, 10 + f, j);   // Rt[3c + a] = R[a][c]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T dx0 = xi0 - X0.v[u], dx1 = xi1 - X1.v[u], dx2 = xi2 - X2.v[u];
      const T gv = pair_g12(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h) * Vs.v[u];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
      const T z0 = nw0 * S[0].v[u] + nw1 * S[1].v[u] + nw2 * S[2].v[u];
      const T z1 = nw0 * S[1].v[u] + nw1 * S[3].v[u] + nw2 * S[4].v[u];
      const T z2 = nw0 * S[2].v[u] + nw1 * S[4].v[u] + nw2 * S[5].v[u];
      const T u0 = F[0] * z0 + F[1] * z1 + F[2] * z2;
      const T u1 = F[3] * z0 + F[4] * z1 + F[5] * z2;
      const T u2 = F[6] * z0 + F[7] * z1 + F[8] * z2;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = fma(Rt[a].v[u], u0, acc[a]);
        acc[a] = fma(Rt[3 + a].v[u], u1, acc[a]);
        acc[a] = fma(Rt[6 + a].v[u], u2, acc[a]);
      }
    }
  }
}

// The scheduled tile of this block: (tile, its slab, its static (5, slab)
// block, its gidx row); warp w takes chunks [c0, c1) of the slab's
// ceil(slab / CH), the last one partial when CH does not divide the slab.
struct Sched {
  int64_t tile;
  int slab, c0, c1;
  int64_t st_off, gi_off;
};

__device__ __forceinline__ Sched sched_of(const int64_t* __restrict__ sched, int warp) {
  const int64_t* s = sched + 4 * (int64_t)blockIdx.x;
  Sched r;
  r.tile = s[0];
  r.slab = (int)s[1];
  r.st_off = s[2];
  r.gi_off = s[3];
  const int nch = (r.slab + CH - 1) / CH;
  r.c0 = warp * nch / RG_WARPS;
  r.c1 = (warp + 1) * nch / RG_WARPS;
  return r;
}

// Each warp's partial sums into shared memory (over its ring), then the
// fixed-order sum over warps: store(k, col, sum) for each of the tile's
// K x ROWS outputs, col = tile * ROWS + r their lane-major column.
template <typename T, int K, typename Store>
__device__ __forceinline__ void reduce_store(T* smem, const T (&acc)[K], int64_t tile,
                                             Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                           // every ring read: smem is free
#pragma unroll
  for (int k = 0; k < K; ++k) smem[(warp * K + k) * ROWS + lane] = acc[k];
  __syncthreads();
  for (int o = threadIdx.x; o < K * ROWS; o += RG_THREADS) {
    const int k = o / ROWS, r = o % ROWS;
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < RG_WARPS; ++w) sum += smem[(w * K + k) * ROWS + r];
    store(k, tile * ROWS + r, sum);
  }
}

// K1's sums of one scheduled tile into this lane's acc (row lane, its
// warp's share of the slab): the block's kernel is moments_v4_kernel or
// moments_mid_kernel.  Blocks 0-2 are accumulated as +cA p_a dx_k.
template <typename T>
__device__ __forceinline__ void k1_forward(
    T* smem, const Sched& s, const T* __restrict__ rest_rows,
    const T* __restrict__ static_all, const int32_t* __restrict__ gidx_all,
    const T* __restrict__ posT, int64_t ld_pos, const T* __restrict__ posT_rows,
    int64_t ld_rows, int group, T inv_h, T c4, T c4h, T (&acc)[K1_OUT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* rr = rest_rows + s.tile * 3 * ROWS;
  const int64_t col = s.tile * ROWS + lane;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  const T pi0 = posT_rows[col], pi1 = posT_rows[ld_rows + col],
          pi2 = posT_rows[2 * ld_rows + col];
#pragma unroll
  for (int k = 0; k < K1_OUT; ++k) acc[k] = T(0);
  const int srow[5] = {0, 1, 2, 3, 4};
  const T c4h3 = T(3) * c4h;
  walk_chunks<T, 5, 3, K1_FIELDS, false>(
      smem + warp * (NSTAGE * K1_FIELDS * CH), static_all + s.st_off, s.slab, srow,
      posT, ld_pos, gidx_all + s.gi_off, group, s.c0, s.c1, lane,
      [&](T* buf) {
        for (int e = lane; e < CH; e += 32) {
          buf[3 * CH + e] *= c4;
          buf[4 * CH + e] *= c4h3;
        }
      },
      [&](const T* buf) { k1_stage(buf, xi0, xi1, xi2, pi0, pi1, pi2, inv_h, acc); });
}

template <typename T>
__global__ void __launch_bounds__(RG_THREADS, 5)
moments_v4_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                  const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                  const T* __restrict__ static_all,      // per tile (5, slab)
                  const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                  const T* __restrict__ posT, int64_t ld_pos,        // (3, ld_pos)
                  const T* __restrict__ posT_rows, int64_t ld_rows,  // (3, ld_rows)
                  T* __restrict__ ayT, int64_t ld_out,   // (18, ld_out)
                  int group, T inv_h, T c4, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Sched s = sched_of(sched, threadIdx.x >> 5);
  T acc[K1_OUT];
  k1_forward(smem, s, rest_rows, static_all, gidx_all, posT, ld_pos, posT_rows, ld_rows,
             group, inv_h, c4, c4h, acc);
  // blocks 0-2 were accumulated as +cA p_a dx_k: stored negated
  reduce_store(smem, acc, s.tile,
               [&](int k, int64_t c, T sum) { ayT[k * ld_out + c] = k < 9 ? -sum : sum; });
}

// The fused path's K1 + mid-section: K1 v4's sums, the fixed-order sum
// over warps into shared memory, then one thread per row gathers its 18
// moments A | Y and runs the mid-section (mid.cuh's mid_row) in
// registers, storing the columns tile * ROWS + r of fmT = [F_9 | M_9 | V_i]
// (19 rows), srT = [S_6 | R^T_9] (15 rows) and, when ayT is given, the
// A | Y rows.  Block 0 also zeroes srT's columns [m, n_sr) (the slots past
// the tile rows, which K2 reads through gidx).
template <typename T>
__global__ void __launch_bounds__(RG_THREADS, 5)
moments_mid_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                   const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                   const T* __restrict__ static_all,      // per tile (5, slab)
                   const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                   const T* __restrict__ posT, int64_t ld_pos,        // (3, ld_pos)
                   const T* __restrict__ posT_rows, int64_t ld_rows,  // (3, ld_rows)
                   const T* __restrict__ mu,              // (m,)
                   const T* __restrict__ lam,             // (m,)
                   const T* __restrict__ vol,             // (m,)
                   const T* __restrict__ rcT, int64_t ld_rc,  // (9, ld_rc): rc[a][b] at 3a+b
                   const T* __restrict__ scale,           // (m,)
                   T* __restrict__ fmT, int64_t ld_fm,    // (19, ld_fm)
                   T* __restrict__ srT, int64_t ld_sr,    // (15, ld_sr)
                   T* __restrict__ ayT, int64_t ld_ay,    // (18, ld_ay) or null
                   int64_t m, int64_t n_sr, int group, T inv_h, T c4, T c4h,
                   int corotated, int sweeps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Sched s = sched_of(sched, warp);
  {
    T acc[K1_OUT];
    k1_forward(smem, s, rest_rows, static_all, gidx_all, posT, ld_pos, posT_rows,
               ld_rows, group, inv_h, c4, c4h, acc);
    __syncthreads();                         // every ring read: smem is free
#pragma unroll
    for (int k = 0; k < K1_OUT; ++k) smem[(warp * K1_OUT + k) * ROWS + lane] = acc[k];
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int64_t o = threadIdx.x; o < SR_ROWS * (n_sr - m); o += RG_THREADS)
      srT[(o / (n_sr - m)) * ld_sr + m + o % (n_sr - m)] = T(0);
  if (warp != 0) return;                     // no barrier follows

  const int64_t col = s.tile * ROWS + lane;
  T A[3][3], Y[3][3];
#pragma unroll
  for (int row = 0; row < K1_OUT; ++row) {   // row 3 blk + a, warps in order
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < RG_WARPS; ++w) sum += smem[(w * K1_OUT + row) * ROWS + lane];
    const T v = row < 9 ? -sum : sum;        // blocks 0-2 accumulated negated
    if (ayT != nullptr) ayT[row * ld_ay + col] = v;
    // A[a][blk] for blk < 3, Y[a][blk - 3] after
    if (row < 9) A[row % 3][row / 3] = v; else Y[row % 3][row / 3 - 3] = v;
  }
  T rc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rc[i][j] = rcT[(3 * i + j) * ld_rc + col];
  T R[3][3], F[3][3], S[3][3], M[3][3];
  mid_row(A, Y, rc, mu[col], lam[col], scale[col], corotated != 0, sweeps, R, F, S, M);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fmT[(3 * i + j) * ld_fm + col] = F[i][j];
      fmT[(9 + 3 * i + j) * ld_fm + col] = M[i][j];
      srT[(6 + 3 * j + i) * ld_sr + col] = R[i][j];   // R^T_9: [3c + a] = R[a][c]
    }
  fmT[18 * ld_fm + col] = vol[col];
  srT[0 * ld_sr + col] = S[0][0];
  srT[1 * ld_sr + col] = S[0][1];
  srT[2 * ld_sr + col] = S[0][2];
  srT[3 * ld_sr + col] = S[1][1];
  srT[4 * ld_sr + col] = S[1][2];
  srT[5 * ld_sr + col] = S[2][2];
}

// K2 of one scheduled tile, both record layouts (the block's kernel is
// forces_warp_v4_kernel or forces_warp_v2_kernel).  v4: f9T (9, ld_f9) is
// F_i, and fT = termj.  V2: f9T is the (19, ld_f9) record F_9 | M_9 | V_i,
// and f_a = 0.5 V_i (termj_a + sum_b M_i[a][b] svnw_b), svnw_b = the
// static row sum rs6T[3 + b] (rs6T unread by v4).  TAIL: a slab may end
// inside a stage (the ring's zero-fill form).
template <typename T, bool V2, bool TAIL>
__device__ __forceinline__ void k2_forward(
    T* smem, const int64_t* __restrict__ sched, const T* __restrict__ rest_rows,
    const T* __restrict__ static_all, const int32_t* __restrict__ gidx_all,
    const T* __restrict__ f9T, int64_t ld_f9, const T* __restrict__ srT, int64_t ld_sr,
    const T* __restrict__ rs6T, int64_t ld_rs6, T* __restrict__ fT, int64_t ld_out,
    int group, T inv_h, T c4h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Sched s = sched_of(sched, warp);
  const T* rr = rest_rows + s.tile * 3 * ROWS;
  const int64_t col = s.tile * ROWS + lane;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = f9T[k * ld_f9 + col];
  T acc[K2_OUT] = {T(0), T(0), T(0)};
  const int srow[4] = {0, 1, 2, 4};          // rest_3, V
  walk_chunks<T, 4, 15, K2_FIELDS, TAIL>(
      smem + warp * (NSTAGE * K2_FIELDS * CH), static_all + s.st_off, s.slab, srow,
      srT, ld_sr, gidx_all + s.gi_off, group, s.c0, s.c1, lane,
      [&](T* buf) {
        for (int e = lane; e < CH; e += 32) buf[3 * CH + e] *= c4h;
      },
      [&](const T* buf) { k2_stage(buf, xi0, xi1, xi2, F, inv_h, acc); });
  reduce_store(smem, acc, s.tile, [&](int a, int64_t c, T tj) {
    if constexpr (V2) {
      const T* M = f9T + (9 + 3 * a) * ld_f9 + c;
      const T* sv = rs6T + 3 * ld_rs6 + c;
      const T ti = M[0] * sv[0] + M[ld_f9] * sv[ld_rs6] + M[2 * ld_f9] * sv[2 * ld_rs6];
      fT[a * ld_out + c] = (T(0.5) * f9T[18 * ld_f9 + c]) * (tj + ti);
    } else {
      fT[a * ld_out + c] = tj;
    }
  });
}

template <typename T>
__global__ void __launch_bounds__(RG_THREADS, 5)
forces_warp_v4_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                      const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                      const T* __restrict__ static_all,      // per tile (5, slab)
                      const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                      const T* __restrict__ f9T, int64_t ld_f9,  // (9, ld_f9)
                      const T* __restrict__ srT, int64_t ld_sr,  // (15, ld_sr): S_6 | R^T_9
                      T* __restrict__ fT, int64_t ld_out,        // (3, ld_out)
                      int group, T inv_h, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  k2_forward<T, false, false>(reinterpret_cast<T*>(smem_raw), sched, rest_rows,
                              static_all, gidx_all, f9T, ld_f9, srT, ld_sr, nullptr, 0,
                              fT, ld_out, group, inv_h, c4h);
}

template <typename T, bool TAIL>
__global__ void __launch_bounds__(RG_THREADS, 5)
forces_warp_v2_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                      const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                      const T* __restrict__ static_all,      // per tile (5, slab)
                      const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                      const T* __restrict__ fmT, int64_t ld_fm,    // (19, ld_fm): F_9 | M_9 | V
                      const T* __restrict__ srT, int64_t ld_sr,    // (15, ld_sr): S_6 | R^T_9
                      const T* __restrict__ rs6T, int64_t ld_rs6,  // (6, ld_rs6)
                      T* __restrict__ fT, int64_t ld_out,          // (3, ld_out)
                      int group, T inv_h, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  k2_forward<T, true, TAIL>(reinterpret_cast<T*>(smem_raw), sched, rest_rows,
                            static_all, gidx_all, fmT, ld_fm, srT, ld_sr, rs6T, ld_rs6,
                            fT, ld_out, group, inv_h, c4h);
}

// Dynamic shared memory above 48 KB (K2's f64 rings) needs the opt-in,
// once per kernel instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_moments(const void* sched, int n_sched, const void* rest_rows,
                   const void* static_all, const void* gidx_all, const void* posT,
                   int64_t ld_pos, const void* posT_rows, int64_t ld_rows,
                   void* ayT, int64_t ld_out, int group, double inv_h, double c4,
                   double c4h, void* stream) {
  constexpr size_t smem = ragged_smem<T>(K1_FIELDS, K1_OUT);
  static const cudaError_t attr = allow_smem(moments_v4_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  moments_v4_kernel<T><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)posT, ld_pos, (const T*)posT_rows,
      ld_rows, (T*)ayT, ld_out, group, (T)inv_h, (T)c4, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_moments_mid(const void* sched, int n_sched, const void* rest_rows,
                       const void* static_all, const void* gidx_all, const void* posT,
                       int64_t ld_pos, const void* posT_rows, int64_t ld_rows,
                       const void* mu, const void* lam, const void* vol,
                       const void* rcT, int64_t ld_rc, const void* scale, void* fmT,
                       int64_t ld_fm, void* srT, int64_t ld_sr, void* ayT, int64_t ld_ay,
                       int64_t m, int64_t n_sr, int group, double inv_h, double c4,
                       double c4h, int corotated, int sweeps, void* stream) {
  constexpr size_t smem = ragged_smem<T>(K1_FIELDS, K1_OUT);
  static const cudaError_t attr = allow_smem(moments_mid_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  moments_mid_kernel<T><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)posT, ld_pos, (const T*)posT_rows, ld_rows,
      (const T*)mu, (const T*)lam, (const T*)vol, (const T*)rcT, ld_rc,
      (const T*)scale, (T*)fmT, ld_fm, (T*)srT, ld_sr, (T*)ayT, ld_ay, m, n_sr, group,
      (T)inv_h, (T)c4, (T)c4h, corotated, sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces(const void* sched, int n_sched, const void* rest_rows,
                  const void* static_all, const void* gidx_all, const void* f9T,
                  int64_t ld_f9, const void* srT, int64_t ld_sr, void* fT,
                  int64_t ld_out, int group, double inv_h, double c4h,
                  void* stream) {
  constexpr size_t smem = ragged_smem<T>(K2_FIELDS, K2_OUT);
  static const cudaError_t attr = allow_smem(forces_warp_v4_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  forces_warp_v4_kernel<T><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)f9T, ld_f9, (const T*)srT, ld_sr,
      (T*)fT, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL>
int launch_forces_v2(const void* sched, int n_sched, const void* rest_rows,
                     const void* static_all, const void* gidx_all, const void* fmT,
                     int64_t ld_fm, const void* srT, int64_t ld_sr, const void* rs6T,
                     int64_t ld_rs6, void* fT, int64_t ld_out, int group,
                     double inv_h, double c4h, void* stream) {
  constexpr size_t smem = ragged_smem<T>(K2_FIELDS, K2_OUT);
  static const cudaError_t attr = allow_smem(forces_warp_v2_kernel<T, TAIL>, smem);
  if (attr != cudaSuccess) return (int)attr;
  forces_warp_v2_kernel<T, TAIL><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)fmT, ld_fm, (const T*)srT, ld_sr,
      (const T*)rs6T, ld_rs6, (T*)fT, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// K1 bwd  moments_v4_bwd_kernel replaces softbody_tpu/ops/pallas/
//         pair_kernels.py :: _moments_bwd_kernel_v4 (launched by
//         ops/pallas/packed.py :: _moments_v4_bwd_impl), and
//         moments_raw_bwd_kernel (the same body, k1_bwd_chunk) replaces
//         ::_moments_bwd_kernel (launched by _moments_vjp_bwd from
//         packed.py :: _fused_vjp_bwd and moments_packed's VJP): the raw
//         K1's backward on the fused path (with the row term) and on the
//         blocked layout (without; slabs that end inside a chunk).
//   dps[a](j)   = sum_i sum_blk ct[3 blk + a](i) L_blk(i, j)   per slab entry
//   dprow[a](i) = -sum_blk ct[3 blk + a](i) rs6[blk](i)        per tile row
//   (rs6 = the host's static row sums: the gradient is exact for a function
//   ~1e-7 relative away from the f32 forward, packed.py:376-383; the fused
//   path takes the same row term, the blocked layout's caller keeps its
//   - pos_i rs6 correction under autograd).  Per pair
//   s1_a = sum_k ct[3k + a] dx_k, s2_a = sum_k ct[9 + 3k + a] dx_k and
//   dps_a += gv s2_a - cA s1_a: 67 flops.
//
// K2 bwd  replaces softbody_tpu/ops/pallas/pair_kernels.py ::
//         _forces_warp_bwd_kernel_v4 (launched by _forces_warp_bwd_v4_impl)
//         and, as forces_warp_v2_bwd_rows / _slab, ::
//         _forces_warp_bwd_kernel_v2 (launched by _forces_warp_bwd_impl).
//   With z_d = sum_b nw_b S_j[d][b], u_c = sum_d F_i[c][d] z_d and
//   w'_c = sum_a df_a(i) R_j[a][c]:
//     df9[3c+d](i)     = sum_j z_d w'_c                   (over the slab)
//     dR^T[3c+a](j)    = sum_i df_a(i) u_c                (over the rows)
//     dS_6[SYM6](j)   += sum_i nw_b y_d,  y_d = sum_c F_i[c][d] w'_c
//   The two sums run in opposite directions, so two passes, each with one
//   owner per output and no cross-thread reduction but the fixed-order one
//   of the forward: forces_warp_v4_bwd_rows_kernel (71 flops per pair) and
//   forces_warp_v4_bwd_slab_kernel (118).  One pass would have to reduce
//   the 15 slab sums across the 32 row lanes per pair (about 30 shuffles
//   and adds); two passes recompute the pair coefficients instead.
//   v2 (the fmT record F_9 | M_9 | V_i): df is taken as df * 0.5 V_i, and
//   the row pass stores dfm = [dF_9 | dM_9 | 0] (19 rows) with
//   dM[3a+b] = df_a svnw_b, svnw from the static row sums rs6T[3:6] as in
//   the forward: an elementwise epilogue, the pair loops are v4's.
//
// Bound on an H100 SXM: all three are OPERATION-bound, as the forward
// kernels are (each slab entry read once serves the tile's 32 rows);
// chip_smoke.py computes each bound from the run's shapes.
// What the design does about it:
//   * One launch per backward evaluation over every tile of every bucket
//     (it used to be one per bucket: 8 launches, two of them with fewer
//     tiles than the card has SMs), straight into the whole-scene outputs:
//     the row side into (3, m) and (9, m), the slab side into the
//     (k, sum_b t_b slab_b) buffer that slab_to_slots reads, where a tile's
//     entry s sits at column gi_off * group + s (gi_off: the offset of its
//     gidx row in gidx_all; the buckets' entries end to end, tile-major).
//   * The row pass has the forward K2's structure: the ragged schedule, four
//     warps splitting the slab, the two-stage cp.async ring of the same 19
//     fields, a lane per row with 9 accumulators.
//   * The slab side (K1 and K2's slab pass) runs uniform work items: every
//     slab entry's sums are independent of the other entries', so a block
//     takes one (tile, BCH = 128-entry chunk) of the host's chunk schedule
//     (SparseBlocked.chunks: [tile, slab, st_off, gi_off, e0], tile order):
//     17,672 equal blocks at the ~112k scene, where there were 3,776 tiles
//     of 1-8 entries per thread.  A tile's chunk-0 block also writes K1's
//     dprow.  K2's slab pass and the raw K1 backward also take a slab whose
//     last chunk holds fewer entries (the blocked layout's 1,944 = 15 x 128
//     + 24): threads past the slab read an entry inside it and write
//     nothing (the raw K1 backward as a template flag; moments_v4_bwd
//     serves the sparse scene only, whose slabs are whole chunks, and its
//     wrapper refuses others).
//   * Fewer shared-memory instructions per pair on the slab side: the
//     tile's rows are staged row-major and padded to a multiple of 4 (K1:
//     x_3 and the 18 cotangents in 24; K2: x_3, df_3 and F_9 in 16), so a
//     row is read as 6 (K1) or 4 (K2) 16-byte broadcasts, not 21 or 15
//     scalar loads.  A K1 thread owns K1B_EPT = 2 slab entries, so that
//     each broadcast serves 2 pairs; a K2 slab thread owns 1 (its 34 values
//     per entry: at 2 entries per thread half the warps fit on an SM, and
//     it ran 2-5% slower on the card).
//     Each entry's sum over the rows runs in row order.
//   * Fewer instructions per pair: the pair polynomial clamps by
//     saturating multiply-adds (pair_sat, 3-5 instructions fewer than the
//     forward's); the spline constants are folded into m_j and V_j once per
//     entry, as in the forward's prep pass; K2's slab pass also takes V_j
//     and the gradient factor out of its sums (it adds with g1 df_i and dx)
//     and scales its 15 sums by 12 c4h V_j once.
//   * No atomics: every sum runs in a fixed order, bitwise repeatable.
//
// slab_to_slots_kernel: the per-slab-entry buffers of all buckets, (k,
//   n_entries) field-major, added into (k, n_slots): one thread per (field,
//   slot) walks its slot group's CSR list of readers in ascending order.
//   Byte-bound (each entry read once).

constexpr int BCH = 128;          // slab entries per slab-side block
constexpr int K1B_REC = 24;       // K1 bwd row record: x_3, ct_18, pad
constexpr int K2B_REC = 16;       // K2 slab pass row record: x_3, df_3, F_9, pad
constexpr int K2B_OUT = 9;        // the row pass's sums per row: df9
constexpr int K1B_EPT = 2;        // slab entries per K1 bwd thread (K2's slab pass: 1)

// The slab-side block's work item: entries [e0, e0 + BCH) of one tile's slab.
struct BChunk {
  int64_t tile, st_off, gi_off;
  int slab, e0;
};

__device__ __forceinline__ BChunk bchunk_of(const int64_t* __restrict__ chunks) {
  const int64_t* c = chunks + 5 * (int64_t)blockIdx.x;
  BChunk r;
  r.tile = c[0];
  r.slab = (int)c[1];
  r.st_off = c[2];
  r.gi_off = c[3];
  r.e0 = (int)c[4];
  return r;
}

// The tile's rows row-major in shared memory: rec[r * REC + f] = field(f, r)
// for f < NF, the padding fields zero.  Each thread stores four fields of
// a row at once (16 bytes): neighbouring lanes read neighbouring rows of a
// field from global memory, and the row-major stores conflict 2-way (K1)
// or 4-way (K2) where scalar stores would conflict 8- or 16-way.
template <typename T, int REC, int NF, int NT, typename Field>
__device__ __forceinline__ void stage_rows(T* rec, Field field) {
  for (int o = threadIdx.x; o < REC / 4 * ROWS; o += NT) {
    const int k = o / ROWS, r = o % ROWS;
    Four<T> x;
#pragma unroll
    for (int i = 0; i < 4; ++i) x.v[i] = 4 * k + i < NF ? field(4 * k + i, r) : T(0);
    *reinterpret_cast<Four<T>*>(rec + r * REC + 4 * k) = x;
  }
}

// Row r of the staged rows as REC / 4 16-byte broadcasts.
template <typename T, int REC>
__device__ __forceinline__ void load_row(const T* rec, int r, T (&x)[REC]) {
  const Four<T>* q = reinterpret_cast<const Four<T>*>(rec + r * REC);
#pragma unroll
  for (int k = 0; k < REC / 4; ++k) {
    const Four<T> f = q[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[4 * k + i] = f.v[i];
  }
}

// K1's backward on one (tile, 128-entry chunk) of the chunk schedule: dps
// (3, ld_ps), a tile's entry s at column gi_off * group + s.  One body,
// two kernels: moments_v4_bwd_kernel = <!TAIL, ROWTERM> and
// moments_raw_bwd_kernel (the raw K1's backward: the fused path with
// ROWTERM, path B's varcol slab with TAIL).  ROWTERM: the chunk-0 blocks
// also write dprow (3, ld_row) = -sum_blk ct[3 blk + a] rs6[blk].  TAIL:
// a slab's last chunk may be partial; a thread's entries past the slab
// read the chunk's first entry and store nothing.  TAIL is the first bool
// template parameter of every kernel here (pair_times.py reads it so).
template <typename T, bool TAIL, bool ROWTERM>
__device__ __forceinline__ void k1_bwd_chunk(
    T* rec, const int64_t* __restrict__ chunks, const T* __restrict__ rest_rows,
    const T* __restrict__ static_all, const T* __restrict__ dayT, int64_t ld_day,
    const T* __restrict__ rs6T, int64_t ld_rs6, T* __restrict__ dps, int64_t ld_ps,
    T* __restrict__ dprow, int64_t ld_row, int group, T inv_h, T c4, T c4h) {
  constexpr int EPT = K1B_EPT, NT = BCH / EPT;
  const BChunk c = bchunk_of(chunks);
  const int64_t col0 = c.tile * ROWS;
  const T* rr = rest_rows + c.tile * 3 * ROWS;
  stage_rows<T, K1B_REC, 21, NT>(rec, [&](int f, int r) {
    return f < 3 ? rr[f * ROWS + r] : dayT[(f - 3) * ld_day + col0 + r];
  });
  if constexpr (ROWTERM) {
    if (c.e0 == 0)
      for (int o = threadIdx.x; o < 3 * ROWS; o += NT) {
        const int a = o / ROWS, r = o % ROWS;
        T acc = T(0);
#pragma unroll
        for (int blk = 0; blk < 6; ++blk)
          acc += dayT[(3 * blk + a) * ld_day + col0 + r] * rs6T[blk * ld_rs6 + col0 + r];
        dprow[a * ld_row + col0 + r] = -acc;
      }
  }
  const T* st = static_all + c.st_off;
  const T c4x4 = T(4) * c4, c4h12 = T(12) * c4h, nih = -inv_h, nih2 = T(-0.5) * inv_h;
  T xj[EPT][3], mj[EPT], vj[EPT], g[EPT][3];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    int e = c.e0 + threadIdx.x + u * NT;
    if constexpr (TAIL) e = e < c.slab ? e : c.e0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xj[u][k] = st[k * c.slab + e];
      g[u][k] = T(0);
    }
    mj[u] = c4x4 * st[3 * c.slab + e];
    vj[u] = c4h12 * st[4 * c.slab + e];
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    T x[K1B_REC];
    load_row(rec, r, x);
    const T* ct = x + 3;                     // ct[3 blk + a]
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const T d0 = x[0] - xj[u][0], d1 = x[1] - xj[u][1], d2 = x[2] - xj[u][2];
      T w1, g1;
      pair_sat(d0 * d0 + d1 * d1 + d2 * d2, nih, nih2, w1, g1);
      const T cA = w1 * mj[u], gv = g1 * vj[u];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T s1 = ct[a] * d0 + ct[3 + a] * d1 + ct[6 + a] * d2;
        const T s2 = ct[9 + a] * d0 + ct[12 + a] * d1 + ct[15 + a] * d2;
        g[u][a] = fma(gv, s2, g[u][a]);
        g[u][a] = fma(-cA, s1, g[u][a]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (TAIL && c.e0 + (int)threadIdx.x + u * NT >= c.slab) continue;
    const int64_t e = c.gi_off * group + c.e0 + threadIdx.x + u * NT;
#pragma unroll
    for (int a = 0; a < 3; ++a) dps[a * ld_ps + e] = g[u][a];
  }
}

template <typename T>
__global__ void __launch_bounds__(BCH / K1B_EPT)
moments_v4_bwd_kernel(const int64_t* __restrict__ chunks,     // (n_chunks, 5)
                      const T* __restrict__ rest_rows,        // (n_tiles, 3, ROWS)
                      const T* __restrict__ static_all,       // per tile (5, slab)
                      const T* __restrict__ dayT, int64_t ld_day,   // (18, ld_day)
                      const T* __restrict__ rs6T, int64_t ld_rs6,   // (6, ld_rs6)
                      T* __restrict__ dps, int64_t ld_ps,           // (3, ld_ps)
                      T* __restrict__ dprow, int64_t ld_row,        // (3, ld_row)
                      int group, T inv_h, T c4, T c4h) {
  __shared__ __align__(32) T rec[ROWS * K1B_REC];
  k1_bwd_chunk<T, false, true>(rec, chunks, rest_rows, static_all, dayT, ld_day, rs6T,
                               ld_rs6, dps, ld_ps, dprow, ld_row, group, inv_h, c4, c4h);
}

template <typename T, bool TAIL, bool ROWTERM>
__global__ void __launch_bounds__(BCH / K1B_EPT)
moments_raw_bwd_kernel(const int64_t* __restrict__ chunks,     // (n_chunks, 5)
                       const T* __restrict__ rest_rows,        // (n_tiles, 3, ROWS)
                       const T* __restrict__ static_all,       // per tile (5, slab)
                       const T* __restrict__ dayT, int64_t ld_day,   // (18, ld_day)
                       const T* __restrict__ rs6T, int64_t ld_rs6,   // (6, ld_rs6) or null
                       T* __restrict__ dps, int64_t ld_ps,           // (3, ld_ps)
                       T* __restrict__ dprow, int64_t ld_row,        // (3, ld_row) or null
                       int group, T inv_h, T c4, T c4h) {
  __shared__ __align__(32) T rec[ROWS * K1B_REC];
  k1_bwd_chunk<T, TAIL, ROWTERM>(rec, chunks, rest_rows, static_all, dayT, ld_day, rs6T,
                                 ld_rs6, dps, ld_ps, dprow, ld_row, group, inv_h, c4, c4h);
}

// The row pass's sums of one landed stage for row xi, its df given:
// acc[3c + d] += z_d w'_c.  The stage's V field holds 12 c4h V_j.
template <typename T>
__device__ __forceinline__ void k2b_rows_stage(const T* buf, T xi0, T xi1, T xi2,
                                               T df0, T df1, T df2, T nih, T nih2,
                                               T (&acc)[K2B_OUT]) {
#pragma unroll 1
  for (int j = 0; j < CH; j += 4) {
    const Four<T> X0 = four(buf, 0, j), X1 = four(buf, 1, j), X2 = four(buf, 2, j);
    const Four<T> Vs = four(buf, 3, j);
    Four<T> S[6], Rt[9];                     // S_6 = [s00 s01 s02 s11 s12 s22]
#pragma unroll
    for (int f = 0; f < 6; ++f) S[f] = four(buf, 4 + f, j);
#pragma unroll
    for (int f = 0; f < 9; ++f) Rt[f] = four(buf, 10 + f, j);   // Rt[3c + a] = R[a][c]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T dx0 = xi0 - X0.v[u], dx1 = xi1 - X1.v[u], dx2 = xi2 - X2.v[u];
      const T gv = pair_g1(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, nih, nih2) * Vs.v[u];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
      const T z0 = nw0 * S[0].v[u] + nw1 * S[1].v[u] + nw2 * S[2].v[u];
      const T z1 = nw0 * S[1].v[u] + nw1 * S[3].v[u] + nw2 * S[4].v[u];
      const T z2 = nw0 * S[2].v[u] + nw1 * S[4].v[u] + nw2 * S[5].v[u];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T wp = df0 * Rt[3 * c].v[u] + df1 * Rt[3 * c + 1].v[u]
                     + df2 * Rt[3 * c + 2].v[u];
        acc[3 * c] = fma(z0, wp, acc[3 * c]);
        acc[3 * c + 1] = fma(z1, wp, acc[3 * c + 1]);
        acc[3 * c + 2] = fma(z2, wp, acc[3 * c + 2]);
      }
    }
  }
}

// The row pass of one scheduled tile, both record layouts (its kernel is
// forces_warp_v4_bwd_rows_kernel or forces_warp_v2_bwd_rows_kernel): out
// (9, ld_out) = df9.  V2: df is scaled by 0.5 V_i (fmT row 18), and out is
// (19, ld_out) = [dF_9 | dM_9 | 0], dM[3a + b] = df_a svnw_b with svnw_b =
// rs6T[3 + b] (fmT and rs6T unread by v4).  TAIL as for k2_forward.
template <typename T, bool V2, bool TAIL>
__device__ __forceinline__ void k2_bwd_rows(
    T* smem, const int64_t* __restrict__ sched, const T* __restrict__ rest_rows,
    const T* __restrict__ static_all, const int32_t* __restrict__ gidx_all,
    const T* __restrict__ fmT, int64_t ld_fm, const T* __restrict__ srT, int64_t ld_sr,
    const T* __restrict__ rs6T, int64_t ld_rs6, const T* __restrict__ dfT,
    int64_t ld_df, T* __restrict__ out, int64_t ld_out, int group, T inv_h, T c4h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Sched s = sched_of(sched, warp);
  const T* rr = rest_rows + s.tile * 3 * ROWS;
  const int64_t col = s.tile * ROWS + lane;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T df0 = dfT[col], df1 = dfT[ld_df + col], df2 = dfT[2 * ld_df + col];
  if constexpr (V2) {
    const T hv = T(0.5) * fmT[18 * ld_fm + col];
    df0 *= hv;
    df1 *= hv;
    df2 *= hv;
  }
  T acc[K2B_OUT];
#pragma unroll
  for (int k = 0; k < K2B_OUT; ++k) acc[k] = T(0);
  const int srow[4] = {0, 1, 2, 4};          // rest_3, V
  const T c4h12 = T(12) * c4h, nih = -inv_h, nih2 = T(-0.5) * inv_h;
  walk_chunks<T, 4, 15, K2_FIELDS, TAIL>(
      smem + warp * (NSTAGE * K2_FIELDS * CH), static_all + s.st_off, s.slab, srow,
      srT, ld_sr, gidx_all + s.gi_off, group, s.c0, s.c1, lane,
      [&](T* buf) {
        for (int e = lane; e < CH; e += 32) buf[3 * CH + e] *= c4h12;
      },
      [&](const T* buf) {
        k2b_rows_stage(buf, xi0, xi1, xi2, df0, df1, df2, nih, nih2, acc);
      });
  reduce_store(smem, acc, s.tile,
               [&](int k, int64_t c, T sum) { out[k * ld_out + c] = sum; });
  if constexpr (V2) {
    // rows 9-17: dM[3a + b] = (df_a 0.5 V_i) svnw_b; row 18 (V_i is a
    // material constant): 0
    for (int o = threadIdx.x; o < 10 * ROWS; o += RG_THREADS) {
      const int k = 9 + o / ROWS;
      const int64_t c = s.tile * ROWS + o % ROWS;
      T v = T(0);
      if (k < 18) {
        const int a = (k - 9) / 3, b = (k - 9) % 3;
        v = (dfT[a * ld_df + c] * (T(0.5) * fmT[18 * ld_fm + c]))
            * rs6T[(3 + b) * ld_rs6 + c];
      }
      out[k * ld_out + c] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(RG_THREADS, 5)
forces_warp_v4_bwd_rows_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                               const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                               const T* __restrict__ static_all,      // per tile (5, slab)
                               const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                               const T* __restrict__ srT, int64_t ld_sr,  // (15, ld_sr): S_6 | R^T_9
                               const T* __restrict__ dfT, int64_t ld_df,  // (3, ld_df)
                               T* __restrict__ df9T, int64_t ld_out,      // (9, ld_out)
                               int group, T inv_h, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  k2_bwd_rows<T, false, false>(reinterpret_cast<T*>(smem_raw), sched, rest_rows,
                               static_all, gidx_all, nullptr, 0, srT, ld_sr, nullptr, 0,
                               dfT, ld_df, df9T, ld_out, group, inv_h, c4h);
}

template <typename T, bool TAIL>
__global__ void __launch_bounds__(RG_THREADS, 5)
forces_warp_v2_bwd_rows_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                               const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                               const T* __restrict__ static_all,      // per tile (5, slab)
                               const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                               const T* __restrict__ fmT, int64_t ld_fm,    // (19, ld_fm)
                               const T* __restrict__ srT, int64_t ld_sr,    // (15, ld_sr)
                               const T* __restrict__ rs6T, int64_t ld_rs6,  // (6, ld_rs6)
                               const T* __restrict__ dfT, int64_t ld_df,    // (3, ld_df)
                               T* __restrict__ dfmT, int64_t ld_out,        // (19, ld_out)
                               int group, T inv_h, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  k2_bwd_rows<T, true, TAIL>(reinterpret_cast<T*>(smem_raw), sched, rest_rows,
                              static_all, gidx_all, fmT, ld_fm, srT, ld_sr, rs6T, ld_rs6,
                              dfT, ld_df, dfmT, ld_out, group, inv_h, c4h);
}

// The slab pass of one (tile, 128-entry chunk), both record layouts (its
// kernel is forces_warp_v4_bwd_slab_kernel or _v2_): dsr (15, ld_out), a
// tile's entry s at column gi_off * group + s.  f9T holds F_i in rows 0-8
// (v2: the fmT record, whose row 18, V_i, scales df by 0.5 V_i).  rec is
// the block's staged rows.
template <typename T, bool V2>
__device__ __forceinline__ void k2_bwd_slab(
    T* rec, const int64_t* __restrict__ chunks, const T* __restrict__ rest_rows,
    const T* __restrict__ static_all, const int32_t* __restrict__ gidx_all,
    const T* __restrict__ f9T, int64_t ld_f9, const T* __restrict__ srT, int64_t ld_sr,
    const T* __restrict__ dfT, int64_t ld_df, T* __restrict__ dsr, int64_t ld_out,
    int group, T inv_h, T c4h) {
  const BChunk c = bchunk_of(chunks);
  const int64_t col0 = c.tile * ROWS;
  const T* rr = rest_rows + c.tile * 3 * ROWS;
  stage_rows<T, K2B_REC, 15, BCH>(rec, [&](int f, int r) {
    if (f < 3) return rr[f * ROWS + r];
    if (f < 6) {
      const T d = dfT[(f - 3) * ld_df + col0 + r];
      if constexpr (V2) return d * (T(0.5) * f9T[18 * ld_f9 + col0 + r]);
      return d;
    }
    return f9T[(f - 6) * ld_f9 + col0 + r];
  });
  // this thread's slab entry (past a partial last chunk: the chunk's first,
  // computed and not stored)
  const int s = c.e0 + threadIdx.x;
  const int e = s < c.slab ? s : c.e0;
  const T* st = static_all + c.st_off;
  const int64_t slot = (int64_t)gidx_all[c.gi_off + e / group] * group + e % group;
  const T xj0 = st[e], xj1 = st[c.slab + e], xj2 = st[2 * c.slab + e];
  const T vj = T(12) * c4h * st[4 * c.slab + e];
  const T nih = -inv_h, nih2 = T(-0.5) * inv_h;
  T S[6], Rt[9], dS[6], dRt[9];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    S[f] = srT[f * ld_sr + slot];
    dS[f] = T(0);
  }
#pragma unroll
  for (int f = 0; f < 9; ++f) {
    Rt[f] = srT[(6 + f) * ld_sr + slot];
    dRt[f] = T(0);
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    T x[K2B_REC];
    load_row(rec, r, x);
    const T* df = x + 3;
    const T* F = x + 6;                      // F[3c + d] = F_i[c][d]
    const T d0 = x[0] - xj0, d1 = x[1] - xj1, d2 = x[2] - xj2;
    const T g1 = pair_g1(d0 * d0 + d1 * d1 + d2 * d2, nih, nih2);
    const T gd[3] = {g1 * df[0], g1 * df[1], g1 * df[2]};
    const T z[3] = {S[0] * d0 + S[1] * d1 + S[2] * d2,
                    S[1] * d0 + S[3] * d1 + S[4] * d2,
                    S[2] * d0 + S[4] * d1 + S[5] * d2};
    T wp[3];
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const T uc = F[3 * cc] * z[0] + F[3 * cc + 1] * z[1] + F[3 * cc + 2] * z[2];
#pragma unroll
      for (int a = 0; a < 3; ++a) dRt[3 * cc + a] = fma(gd[a], uc, dRt[3 * cc + a]);
      wp[cc] = gd[0] * Rt[3 * cc] + gd[1] * Rt[3 * cc + 1] + gd[2] * Rt[3 * cc + 2];
    }
    T y[3];
#pragma unroll
    for (int dd = 0; dd < 3; ++dd)
      y[dd] = F[dd] * wp[0] + F[3 + dd] * wp[1] + F[6 + dd] * wp[2];
    // dS_6[SYM6[3d + b]] += dx_b y_d
    dS[0] = fma(d0, y[0], dS[0]);
    dS[1] = fma(d0, y[1], fma(d1, y[0], dS[1]));
    dS[2] = fma(d0, y[2], fma(d2, y[0], dS[2]));
    dS[3] = fma(d1, y[1], dS[3]);
    dS[4] = fma(d1, y[2], fma(d2, y[1], dS[4]));
    dS[5] = fma(d2, y[2], dS[5]);
  }
  if (s >= c.slab) return;
  const int64_t col = c.gi_off * group + s;
#pragma unroll
  for (int f = 0; f < 6; ++f) dsr[f * ld_out + col] = vj * dS[f];
#pragma unroll
  for (int f = 0; f < 9; ++f) dsr[(6 + f) * ld_out + col] = vj * dRt[f];
}

template <typename T>
__global__ void __launch_bounds__(BCH)
forces_warp_v4_bwd_slab_kernel(const int64_t* __restrict__ chunks,     // (n_chunks, 5)
                               const T* __restrict__ rest_rows,        // (n_tiles, 3, ROWS)
                               const T* __restrict__ static_all,       // per tile (5, slab)
                               const int32_t* __restrict__ gidx_all,   // per tile (slab / group)
                               const T* __restrict__ f9T, int64_t ld_f9,   // (9, ld_f9)
                               const T* __restrict__ srT, int64_t ld_sr,   // (15, ld_sr)
                               const T* __restrict__ dfT, int64_t ld_df,   // (3, ld_df)
                               T* __restrict__ dsr, int64_t ld_out,        // (15, ld_out)
                               int group, T inv_h, T c4h) {
  __shared__ __align__(32) T rec[ROWS * K2B_REC];
  k2_bwd_slab<T, false>(rec, chunks, rest_rows, static_all, gidx_all, f9T, ld_f9, srT,
                        ld_sr, dfT, ld_df, dsr, ld_out, group, inv_h, c4h);
}

template <typename T>
__global__ void __launch_bounds__(BCH)
forces_warp_v2_bwd_slab_kernel(const int64_t* __restrict__ chunks,     // (n_chunks, 5)
                               const T* __restrict__ rest_rows,        // (n_tiles, 3, ROWS)
                               const T* __restrict__ static_all,       // per tile (5, slab)
                               const int32_t* __restrict__ gidx_all,   // per tile (slab / group)
                               const T* __restrict__ fmT, int64_t ld_fm,   // (19, ld_fm)
                               const T* __restrict__ srT, int64_t ld_sr,   // (15, ld_sr)
                               const T* __restrict__ dfT, int64_t ld_df,   // (3, ld_df)
                               T* __restrict__ dsr, int64_t ld_out,        // (15, ld_out)
                               int group, T inv_h, T c4h) {
  __shared__ __align__(32) T rec[ROWS * K2B_REC];
  k2_bwd_slab<T, true>(rec, chunks, rest_rows, static_all, gidx_all, fmT, ld_fm, srT,
                       ld_sr, dfT, ld_df, dsr, ld_out, group, inv_h, c4h);
}

// ------------------------------------------------------ the separable K2
//
// K2 sep  forces_sep_kernel replaces softbody_tpu/ops/pallas/pair_kernels.py
//         :: _forces_kernel (launched by _forces_fwd_impl from
//         ops/pallas/packed.py :: forces_packed), and
//         forces_sep_bwd_kernel ::_forces_bwd_kernel (launched by
//         _forces_vjp_bwd): the Taichi pairing's (pair_def_grad = "j")
//         K2 on the sparse scene (path A) and the blocked one (path B).
//   With G = V M per slot (row 3a + b = G[a][b]), M_i = G_i / V_safe,i
//   (V_safe = V where V > 0, else 1) and nw = gfac dx = grad W_ij:
//     f_a        = 0.5 V_i (sum_j (G_j nw)_a + sum_b M_i[a][b] svnw_b)
//     dG_rows    = (d_a / V_safe,i) svnw_b at 3a + b, d = 0.5 V_i df  (9, m)
//     dG_slab(j) = sum_i nw_b d_a at 3a + b, per slab entry  (9, n_entries)
//   svnw_b = sum_j V_j nw_b depends on rest geometry and volumes only: both
//   read it from the scene's static row sums rs6T[3:6], as K2 v2 does (the
//   TPU kernel summed it over the slab, pair_kernels.py:705-706 and
//   :737-738; the plain versions still do).  Volumes get no cotangent
//   (material constants), as in the TPU VJP.
//   Per pair the forward does 43 flops (dx 3, r2 5, the gradient
//   polynomial 14, nw 3, the 9 multiply-adds of G_j nw 18) on 12 staged
//   fields (rest_3, G_9), the backward 42 (dx 3, r2 5, the saturating
//   polynomial 13, g1 d 3, the 9 sums 18) on 3; both OPERATION-bound.
// What the design does about it: the forward is K2 v4's ragged kernel
//   (a block of 4 warps per tile over the schedule, longest slab first; the
//   two-stage cp.async ring per warp, G gathered through gidx in 16-byte
//   pieces; a lane per row with 3 sums; the TAIL zero-fill form for
//   varcol's slab), the spline's constant c4h applied once per row in the
//   epilogue.  The backward is the slab side's chunk block (a block per
//   128-entry chunk, the tile's rows staged row-major as x_3 | d_3 | pad,
//   two 16-byte broadcasts per row, SEPB_EPT = 2 slab entries per thread
//   with 9 sums each in row order (2 ran 8% faster than 1 on the sparse
//   scene and 13% on varcol's), pair_g1 with 12 c4h applied once per entry);
//   its chunk-0 blocks also write the row term, which needs no pair loop.
//   One launch per evaluation each; no atomics.

constexpr int SEP_FIELDS = 12;               // rest_3 | G_9
constexpr int SEP_OUT = 3;
constexpr int SEPB_REC = 8;                  // bwd row record: x_3, d_3, pad
constexpr int SEP_G = 9;                     // rows of gT and of the cotangents
constexpr int SEPB_EPT = 2;                  // slab entries per separable bwd thread

// The separable K2's sums of one landed stage for row xi: acc[a] +=
// sum_b G_j[a][b] g12 dx_b (c4h applied in the epilogue).
template <typename T>
__device__ __forceinline__ void sep_stage(const T* buf, T xi0, T xi1, T xi2, T inv_h,
                                          T (&acc)[SEP_OUT]) {
#pragma unroll 1
  for (int j = 0; j < CH; j += 4) {
    const Four<T> X0 = four(buf, 0, j), X1 = four(buf, 1, j), X2 = four(buf, 2, j);
    Four<T> G[SEP_G];                        // G[3a + b] = G_j[a][b]
#pragma unroll
    for (int f = 0; f < SEP_G; ++f) G[f] = four(buf, 3 + f, j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T dx0 = xi0 - X0.v[u], dx1 = xi1 - X1.v[u], dx2 = xi2 - X2.v[u];
      const T g = pair_g12(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h);
      const T nw0 = g * dx0, nw1 = g * dx1, nw2 = g * dx2;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = fma(G[3 * a].v[u], nw0, acc[a]);
        acc[a] = fma(G[3 * a + 1].v[u], nw1, acc[a]);
        acc[a] = fma(G[3 * a + 2].v[u], nw2, acc[a]);
      }
    }
  }
}

// fT (3, ld_out): a block per scheduled tile; gT (9, ld_g) holds every
// slot's G (the tile rows' are its first m columns), vol (m,) the rows'
// volumes.  TAIL as for k2_forward.
template <typename T, bool TAIL>
__global__ void __launch_bounds__(RG_THREADS, 5)
forces_sep_kernel(const int64_t* __restrict__ sched,     // (n_sched, 4)
                  const T* __restrict__ rest_rows,       // (n_tiles, 3, ROWS)
                  const T* __restrict__ static_all,      // per tile (5, slab)
                  const int32_t* __restrict__ gidx_all,  // per tile (slab / group)
                  const T* __restrict__ gT, int64_t ld_g,      // (9, ld_g)
                  const T* __restrict__ vol,                   // (m,)
                  const T* __restrict__ rs6T, int64_t ld_rs6,  // (6, ld_rs6)
                  T* __restrict__ fT, int64_t ld_out,          // (3, ld_out)
                  int group, T inv_h, T c4h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Sched s = sched_of(sched, warp);
  const T* rr = rest_rows + s.tile * 3 * ROWS;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T acc[SEP_OUT] = {T(0), T(0), T(0)};
  const int srow[3] = {0, 1, 2};             // rest_3
  walk_chunks<T, 3, SEP_G, SEP_FIELDS, TAIL>(
      smem + warp * (NSTAGE * SEP_FIELDS * CH), static_all + s.st_off, s.slab, srow, gT,
      ld_g, gidx_all + s.gi_off, group, s.c0, s.c1, lane, [](T*) {},
      [&](const T* buf) { sep_stage(buf, xi0, xi1, xi2, inv_h, acc); });
  // f_a = 0.5 V_i (c4h termj_a + sum_b (G_i[a][b] / V_safe) svnw_b)
  reduce_store(smem, acc, s.tile, [&](int a, int64_t c, T tj) {
    const T v = vol[c];
    const T vs = v > T(0) ? v : T(1);
    const T* G = gT + 3 * a * ld_g + c;
    const T* sv = rs6T + 3 * ld_rs6 + c;
    const T ti = (G[0] / vs) * sv[0] + (G[ld_g] / vs) * sv[ld_rs6]
                 + (G[2 * ld_g] / vs) * sv[2 * ld_rs6];
    fT[a * ld_out + c] = (T(0.5) * v) * (c4h * tj + ti);
  });
}

// The separable K2's backward on one (tile, 128-entry chunk) of the chunk
// schedule: dgs (9, ld_gs), a tile's entry s at column gi_off * group + s,
// and from the chunk-0 blocks dgr (9, ld_gr), the row term.  SEPB_EPT slab
// entries per thread; TAIL: a slab's last chunk may be partial (a thread's
// entries past the slab read the chunk's first entry and store nothing).
template <typename T, bool TAIL>
__global__ void __launch_bounds__(BCH / SEPB_EPT)
forces_sep_bwd_kernel(const int64_t* __restrict__ chunks,     // (n_chunks, 5)
                      const T* __restrict__ rest_rows,        // (n_tiles, 3, ROWS)
                      const T* __restrict__ static_all,       // per tile (5, slab)
                      const T* __restrict__ vol,              // (m,)
                      const T* __restrict__ rs6T, int64_t ld_rs6,   // (6, ld_rs6)
                      const T* __restrict__ dfT, int64_t ld_df,     // (3, ld_df)
                      T* __restrict__ dgs, int64_t ld_gs,           // (9, ld_gs)
                      T* __restrict__ dgr, int64_t ld_gr,           // (9, ld_gr)
                      int group, T inv_h, T c4h) {
  constexpr int EPT = SEPB_EPT, NT = BCH / EPT;
  __shared__ __align__(32) T rec[ROWS * SEPB_REC];
  const BChunk c = bchunk_of(chunks);
  const int64_t col0 = c.tile * ROWS;
  const T* rr = rest_rows + c.tile * 3 * ROWS;
  stage_rows<T, SEPB_REC, 6, NT>(rec, [&](int f, int r) {   // x_3 | d = 0.5 V_i df
    return f < 3 ? rr[f * ROWS + r]
                 : dfT[(f - 3) * ld_df + col0 + r] * (T(0.5) * vol[col0 + r]);
  });
  if (c.e0 == 0)     // the row term: dG_rows[3a + b] = (d_a / V_safe) svnw_b
    for (int o = threadIdx.x; o < SEP_G * ROWS; o += NT) {
      const int k = o / ROWS, a = k / 3, b = k % 3;
      const int64_t col = col0 + o % ROWS;
      const T v = vol[col];
      const T vs = v > T(0) ? v : T(1);
      dgr[k * ld_gr + col] =
          ((dfT[a * ld_df + col] * (T(0.5) * v)) / vs) * rs6T[(3 + b) * ld_rs6 + col];
    }
  const T* st = static_all + c.st_off;
  const T nih = -inv_h, nih2 = T(-0.5) * inv_h;
  T xj[EPT][3], acc[EPT][SEP_G];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    int e = c.e0 + threadIdx.x + u * NT;
    if constexpr (TAIL) e = e < c.slab ? e : c.e0;
#pragma unroll
    for (int k = 0; k < 3; ++k) xj[u][k] = st[k * c.slab + e];
#pragma unroll
    for (int k = 0; k < SEP_G; ++k) acc[u][k] = T(0);
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    T x[SEPB_REC];
    load_row(rec, r, x);
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const T d[3] = {x[0] - xj[u][0], x[1] - xj[u][1], x[2] - xj[u][2]};
      const T g1 = pair_g1(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], nih, nih2);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T gd = g1 * x[3 + a];
#pragma unroll
        for (int b = 0; b < 3; ++b) acc[u][3 * a + b] = fma(gd, d[b], acc[u][3 * a + b]);
      }
    }
  }
  const T c4h12 = T(12) * c4h;               // gfac = 12 c4h g1
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (TAIL && c.e0 + (int)threadIdx.x + u * NT >= c.slab) continue;
    const int64_t e = c.gi_off * group + c.e0 + threadIdx.x + u * NT;
#pragma unroll
    for (int k = 0; k < SEP_G; ++k) dgs[k * ld_gs + e] = c4h12 * acc[u][k];
  }
}

constexpr int SCATTER_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SCATTER_THREADS)
slab_to_slots_kernel(const T* __restrict__ buf,          // (k, ld_buf)
                     int64_t ld_buf,
                     const int32_t* __restrict__ ptr,    // (n_slots / group + 1)
                     const int32_t* __restrict__ idx,    // group-entry positions
                     T* __restrict__ out,                // (k, ld_out)
                     int64_t ld_out, int k, int n_slots, int group) {
  const int64_t i = (int64_t)blockIdx.x * SCATTER_THREADS + threadIdx.x;
  if (i >= (int64_t)k * n_slots) return;
  const int f = (int)(i / n_slots);
  const int slot = (int)(i % n_slots);
  const int g = slot / group;
  const T* b = buf + f * ld_buf + slot % group;
  T acc = T(0);
  for (int e = ptr[g]; e < ptr[g + 1]; ++e) acc += b[(int64_t)idx[e] * group];
  out[f * ld_out + slot] = acc;
}

template <typename T>
int launch_moments_bwd(const void* chunks, int n_chunks, const void* rest_rows,
                       const void* static_all, const void* dayT, int64_t ld_day,
                       const void* rs6T, int64_t ld_rs6, void* dps, int64_t ld_ps,
                       void* dprow, int64_t ld_row, int group, double inv_h,
                       double c4, double c4h, void* stream) {
  moments_v4_bwd_kernel<T><<<n_chunks, BCH / K1B_EPT, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunks, (const T*)rest_rows, (const T*)static_all,
      (const T*)dayT, ld_day, (const T*)rs6T, ld_rs6, (T*)dps, ld_ps, (T*)dprow,
      ld_row, group, (T)inv_h, (T)c4, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL, bool ROWTERM>
int launch_moments_raw_bwd(const void* chunks, int n_chunks, const void* rest_rows,
                           const void* static_all, const void* dayT, int64_t ld_day,
                           const void* rs6T, int64_t ld_rs6, void* dps, int64_t ld_ps,
                           void* dprow, int64_t ld_row, int group, double inv_h,
                           double c4, double c4h, void* stream) {
  moments_raw_bwd_kernel<T, TAIL, ROWTERM>
      <<<n_chunks, BCH / K1B_EPT, 0, (cudaStream_t)stream>>>(
          (const int64_t*)chunks, (const T*)rest_rows, (const T*)static_all,
          (const T*)dayT, ld_day, (const T*)rs6T, ld_rs6, (T*)dps, ld_ps, (T*)dprow,
          ld_row, group, (T)inv_h, (T)c4, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd_rows(const void* sched, int n_sched, const void* rest_rows,
                           const void* static_all, const void* gidx_all,
                           const void* srT, int64_t ld_sr, const void* dfT,
                           int64_t ld_df, void* df9T, int64_t ld_out, int group,
                           double inv_h, double c4h, void* stream) {
  constexpr size_t smem = ragged_smem<T>(K2_FIELDS, K2B_OUT);
  static const cudaError_t attr = allow_smem(forces_warp_v4_bwd_rows_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  forces_warp_v4_bwd_rows_kernel<T><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)srT, ld_sr, (const T*)dfT, ld_df,
      (T*)df9T, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd_slab(const void* chunks, int n_chunks, const void* rest_rows,
                           const void* static_all, const void* gidx_all,
                           const void* f9T, int64_t ld_f9, const void* srT,
                           int64_t ld_sr, const void* dfT, int64_t ld_df, void* dsr,
                           int64_t ld_out, int group, double inv_h, double c4h,
                           void* stream) {
  forces_warp_v4_bwd_slab_kernel<T><<<n_chunks, BCH, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunks, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)f9T, ld_f9, (const T*)srT, ld_sr,
      (const T*)dfT, ld_df, (T*)dsr, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL>
int launch_forces_v2_bwd_rows(const void* sched, int n_sched, const void* rest_rows,
                              const void* static_all, const void* gidx_all,
                              const void* fmT, int64_t ld_fm, const void* srT,
                              int64_t ld_sr, const void* rs6T, int64_t ld_rs6,
                              const void* dfT, int64_t ld_df, void* dfmT,
                              int64_t ld_out, int group, double inv_h, double c4h,
                              void* stream) {
  constexpr size_t smem = ragged_smem<T>(K2_FIELDS, K2B_OUT);
  static const cudaError_t attr =
      allow_smem(forces_warp_v2_bwd_rows_kernel<T, TAIL>, smem);
  if (attr != cudaSuccess) return (int)attr;
  forces_warp_v2_bwd_rows_kernel<T, TAIL>
      <<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
          (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
          (const int32_t*)gidx_all, (const T*)fmT, ld_fm, (const T*)srT, ld_sr,
          (const T*)rs6T, ld_rs6, (const T*)dfT, ld_df, (T*)dfmT, ld_out, group,
          (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_v2_bwd_slab(const void* chunks, int n_chunks, const void* rest_rows,
                              const void* static_all, const void* gidx_all,
                              const void* fmT, int64_t ld_fm, const void* srT,
                              int64_t ld_sr, const void* dfT, int64_t ld_df, void* dsr,
                              int64_t ld_out, int group, double inv_h, double c4h,
                              void* stream) {
  forces_warp_v2_bwd_slab_kernel<T><<<n_chunks, BCH, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunks, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)fmT, ld_fm, (const T*)srT, ld_sr,
      (const T*)dfT, ld_df, (T*)dsr, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL>
int launch_forces_sep(const void* sched, int n_sched, const void* rest_rows,
                      const void* static_all, const void* gidx_all, const void* gT,
                      int64_t ld_g, const void* vol, const void* rs6T, int64_t ld_rs6,
                      void* fT, int64_t ld_out, int group, double inv_h, double c4h,
                      void* stream) {
  constexpr size_t smem = ragged_smem<T>(SEP_FIELDS, SEP_OUT);
  static const cudaError_t attr = allow_smem(forces_sep_kernel<T, TAIL>, smem);
  if (attr != cudaSuccess) return (int)attr;
  forces_sep_kernel<T, TAIL><<<n_sched, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)sched, (const T*)rest_rows, (const T*)static_all,
      (const int32_t*)gidx_all, (const T*)gT, ld_g, (const T*)vol, (const T*)rs6T, ld_rs6,
      (T*)fT, ld_out, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL>
int launch_forces_sep_bwd(const void* chunks, int n_chunks, const void* rest_rows,
                          const void* static_all, const void* vol, const void* rs6T,
                          int64_t ld_rs6, const void* dfT, int64_t ld_df, void* dgs,
                          int64_t ld_gs, void* dgr, int64_t ld_gr, int group,
                          double inv_h, double c4h, void* stream) {
  forces_sep_bwd_kernel<T, TAIL><<<n_chunks, BCH / SEPB_EPT, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunks, (const T*)rest_rows, (const T*)static_all, (const T*)vol,
      (const T*)rs6T, ld_rs6, (const T*)dfT, ld_df, (T*)dgs, ld_gs, (T*)dgr, ld_gr, group,
      (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slab_to_slots(const void* buf, int64_t ld_buf, const void* ptr,
                         const void* idx, void* out, int64_t ld_out, int k,
                         int n_slots, int group, void* stream) {
  const int64_t n = (int64_t)k * n_slots;
  const int blocks = (int)((n + SCATTER_THREADS - 1) / SCATTER_THREADS);
  slab_to_slots_kernel<T><<<blocks, SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)buf, ld_buf, (const int32_t*)ptr, (const int32_t*)idx, (T*)out,
      ld_out, k, n_slots, group);
  return (int)cudaGetLastError();
}

// Kernel `which` of this file (0: K1 moments_v4, 1: K2 forces_warp_v4,
// 2: moments_v4_bwd, 3: forces_warp_v4_bwd_rows, 4: forces_warp_v4_bwd_slab,
// 5: forces_warp_v2, 6: forces_warp_v2_bwd_rows, 7: forces_warp_v2_bwd_slab,
// 8 and 9: 5 and 6 for slabs that end inside a ring stage, 10: moments_mid,
// 11: moments_raw_bwd with the row term (the fused path), 12: without it,
// for slabs that end inside a chunk (path B), 13: forces_sep, 14: it for
// slabs that end inside a ring stage, 15 and 16: forces_sep_bwd with 1 and
// 2 slab entries per thread, 17 and 18: those for slabs that end inside a
// chunk) in f32 or f64: [registers
// per thread, static shared bytes, local (stack and spill) bytes, dynamic
// shared bytes, resident blocks per SM, threads per block] into out.
template <typename K>
int kernel_info(K kernel, size_t smem, int threads, int* out) {
  cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  out[5] = threads;
  return (int)rc;
}

template <typename T>
int ragged_info(int which, int* out) {
  switch (which) {
    case 0:
      return kernel_info(moments_v4_kernel<T>, ragged_smem<T>(K1_FIELDS, K1_OUT),
                         RG_THREADS, out);
    case 1:
      return kernel_info(forces_warp_v4_kernel<T>, ragged_smem<T>(K2_FIELDS, K2_OUT),
                         RG_THREADS, out);
    case 2:
      return kernel_info(moments_v4_bwd_kernel<T>, 0, BCH / K1B_EPT, out);
    case 3:
      return kernel_info(forces_warp_v4_bwd_rows_kernel<T>,
                         ragged_smem<T>(K2_FIELDS, K2B_OUT), RG_THREADS, out);
    case 4:
      return kernel_info(forces_warp_v4_bwd_slab_kernel<T>, 0, BCH, out);
    case 5:
      return kernel_info(forces_warp_v2_kernel<T, false>,
                         ragged_smem<T>(K2_FIELDS, K2_OUT), RG_THREADS, out);
    case 6:
      return kernel_info(forces_warp_v2_bwd_rows_kernel<T, false>,
                         ragged_smem<T>(K2_FIELDS, K2B_OUT), RG_THREADS, out);
    case 7:
      return kernel_info(forces_warp_v2_bwd_slab_kernel<T>, 0, BCH, out);
    case 8:
      return kernel_info(forces_warp_v2_kernel<T, true>,
                         ragged_smem<T>(K2_FIELDS, K2_OUT), RG_THREADS, out);
    case 9:
      return kernel_info(forces_warp_v2_bwd_rows_kernel<T, true>,
                         ragged_smem<T>(K2_FIELDS, K2B_OUT), RG_THREADS, out);
    case 10:
      return kernel_info(moments_mid_kernel<T>, ragged_smem<T>(K1_FIELDS, K1_OUT),
                         RG_THREADS, out);
    case 11:
      return kernel_info(moments_raw_bwd_kernel<T, false, true>, 0, BCH / K1B_EPT, out);
    case 12:
      return kernel_info(moments_raw_bwd_kernel<T, true, false>, 0, BCH / K1B_EPT, out);
    case 13:
      return kernel_info(forces_sep_kernel<T, false>, ragged_smem<T>(SEP_FIELDS, SEP_OUT),
                         RG_THREADS, out);
    case 14:
      return kernel_info(forces_sep_kernel<T, true>, ragged_smem<T>(SEP_FIELDS, SEP_OUT),
                         RG_THREADS, out);
    case 15:
      return kernel_info(forces_sep_bwd_kernel<T, false>, 0, BCH / SEPB_EPT, out);
    case 16:
      return kernel_info(forces_sep_bwd_kernel<T, true>, 0, BCH / SEPB_EPT, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int sb_ragged_info(int which, int f64, int* out) {
  return f64 ? ragged_info<double>(which, out) : ragged_info<float>(which, out);
}

int sb_rows() { return ROWS; }

const char* sb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define SB_FWD_ENTRIES(SUF, T)                                                 \
  int sb_moments_v4_##SUF(const void* sched, int n_sched,                      \
                          const void* rest_rows, const void* static_all,       \
                          const void* gidx_all, const void* posT,              \
                          int64_t ld_pos, const void* posT_rows,               \
                          int64_t ld_rows, void* ayT, int64_t ld_out,          \
                          int group, double inv_h, double c4, double c4h,      \
                          void* stream) {                                      \
    return launch_moments<T>(sched, n_sched, rest_rows, static_all, gidx_all,  \
                             posT, ld_pos, posT_rows, ld_rows, ayT, ld_out,    \
                             group, inv_h, c4, c4h, stream);                   \
  }                                                                            \
  int sb_moments_mid_##SUF(                                                    \
      const void* sched, int n_sched, const void* rest_rows,                   \
      const void* static_all, const void* gidx_all, const void* posT,          \
      int64_t ld_pos, const void* posT_rows, int64_t ld_rows, const void* mu,  \
      const void* lam, const void* vol, const void* rcT, int64_t ld_rc,        \
      const void* scale, void* fmT, int64_t ld_fm, void* srT, int64_t ld_sr,   \
      void* ayT, int64_t ld_ay, int64_t m, int64_t n_sr, int group,            \
      double inv_h, double c4, double c4h, int corotated, int sweeps,          \
      void* stream) {                                                          \
    return launch_moments_mid<T>(sched, n_sched, rest_rows, static_all,        \
                                 gidx_all, posT, ld_pos, posT_rows, ld_rows,   \
                                 mu, lam, vol, rcT, ld_rc, scale, fmT, ld_fm,  \
                                 srT, ld_sr, ayT, ld_ay, m, n_sr, group,       \
                                 inv_h, c4, c4h, corotated, sweeps, stream);   \
  }                                                                            \
  int sb_forces_warp_v4_##SUF(const void* sched, int n_sched,                  \
                              const void* rest_rows, const void* static_all,   \
                              const void* gidx_all, const void* f9T,           \
                              int64_t ld_f9, const void* srT, int64_t ld_sr,   \
                              void* fT, int64_t ld_out, int group,             \
                              double inv_h, double c4h, void* stream) {        \
    return launch_forces<T>(sched, n_sched, rest_rows, static_all, gidx_all,   \
                            f9T, ld_f9, srT, ld_sr, fT, ld_out, group, inv_h,  \
                            c4h, stream);                                      \
  }                                                                            \
  int sb_forces_warp_v2_##SUF(const void* sched, int n_sched,                  \
                              const void* rest_rows, const void* static_all,   \
                              const void* gidx_all, const void* fmT,           \
                              int64_t ld_fm, const void* srT, int64_t ld_sr,   \
                              const void* rs6T, int64_t ld_rs6, void* fT,      \
                              int64_t ld_out, int group, double inv_h,         \
                              double c4h, int tail, void* stream) {            \
    return (tail ? launch_forces_v2<T, true> : launch_forces_v2<T, false>)(    \
        sched, n_sched, rest_rows, static_all, gidx_all, fmT, ld_fm, srT,      \
        ld_sr, rs6T, ld_rs6, fT, ld_out, group, inv_h, c4h, stream);           \
  }

SB_FWD_ENTRIES(f32, float)
SB_FWD_ENTRIES(f64, double)

#define SB_BWD_ENTRIES(SUF, T)                                                 \
  int sb_moments_v4_bwd_##SUF(const void* chunks, int n_chunks,                \
                              const void* rest_rows, const void* static_all,   \
                              const void* dayT, int64_t ld_day,                \
                              const void* rs6T, int64_t ld_rs6, void* dps,     \
                              int64_t ld_ps, void* dprow, int64_t ld_row,      \
                              int group, double inv_h, double c4, double c4h,  \
                              void* stream) {                                  \
    return launch_moments_bwd<T>(chunks, n_chunks, rest_rows, static_all,      \
                                 dayT, ld_day, rs6T, ld_rs6, dps, ld_ps,       \
                                 dprow, ld_row, group, inv_h, c4, c4h,         \
                                 stream);                                      \
  }                                                                            \
  int sb_moments_raw_bwd_##SUF(const void* chunks, int n_chunks,               \
                               const void* rest_rows, const void* static_all,  \
                               const void* dayT, int64_t ld_day,               \
                               const void* rs6T, int64_t ld_rs6, void* dps,    \
                               int64_t ld_ps, void* dprow, int64_t ld_row,     \
                               int group, double inv_h, double c4, double c4h, \
                               int rows, int tail, void* stream) {             \
    auto* launch = rows ? (tail ? launch_moments_raw_bwd<T, true, true>        \
                                : launch_moments_raw_bwd<T, false, true>)      \
                        : (tail ? launch_moments_raw_bwd<T, true, false>       \
                                : launch_moments_raw_bwd<T, false, false>);    \
    return launch(chunks, n_chunks, rest_rows, static_all, dayT, ld_day, rs6T, \
                  ld_rs6, dps, ld_ps, dprow, ld_row, group, inv_h, c4, c4h,    \
                  stream);                                                     \
  }                                                                            \
  int sb_forces_warp_v4_bwd_rows_##SUF(                                        \
      const void* sched, int n_sched, const void* rest_rows,                   \
      const void* static_all, const void* gidx_all, const void* srT,           \
      int64_t ld_sr, const void* dfT, int64_t ld_df, void* df9T,               \
      int64_t ld_out, int group, double inv_h, double c4h, void* stream) {     \
    return launch_forces_bwd_rows<T>(sched, n_sched, rest_rows, static_all,    \
                                     gidx_all, srT, ld_sr, dfT, ld_df, df9T,   \
                                     ld_out, group, inv_h, c4h, stream);       \
  }                                                                            \
  int sb_forces_warp_v4_bwd_slab_##SUF(                                        \
      const void* chunks, int n_chunks, const void* rest_rows,                 \
      const void* static_all, const void* gidx_all, const void* f9T,           \
      int64_t ld_f9, const void* srT, int64_t ld_sr, const void* dfT,          \
      int64_t ld_df, void* dsr, int64_t ld_out, int group, double inv_h,       \
      double c4h, void* stream) {                                              \
    return launch_forces_bwd_slab<T>(chunks, n_chunks, rest_rows, static_all,  \
                                     gidx_all, f9T, ld_f9, srT, ld_sr, dfT,    \
                                     ld_df, dsr, ld_out, group, inv_h, c4h,    \
                                     stream);                                  \
  }                                                                            \
  int sb_forces_warp_v2_bwd_rows_##SUF(                                        \
      const void* sched, int n_sched, const void* rest_rows,                   \
      const void* static_all, const void* gidx_all, const void* fmT,           \
      int64_t ld_fm, const void* srT, int64_t ld_sr, const void* rs6T,         \
      int64_t ld_rs6, const void* dfT, int64_t ld_df, void* dfmT,              \
      int64_t ld_out, int group, double inv_h, double c4h, int tail,           \
      void* stream) {                                                          \
    return (tail ? launch_forces_v2_bwd_rows<T, true>                          \
                 : launch_forces_v2_bwd_rows<T, false>)(                       \
        sched, n_sched, rest_rows, static_all, gidx_all, fmT, ld_fm, srT,      \
        ld_sr, rs6T, ld_rs6, dfT, ld_df, dfmT, ld_out, group, inv_h, c4h,      \
        stream);                                                               \
  }                                                                            \
  int sb_forces_warp_v2_bwd_slab_##SUF(                                        \
      const void* chunks, int n_chunks, const void* rest_rows,                 \
      const void* static_all, const void* gidx_all, const void* fmT,           \
      int64_t ld_fm, const void* srT, int64_t ld_sr, const void* dfT,          \
      int64_t ld_df, void* dsr, int64_t ld_out, int group, double inv_h,       \
      double c4h, void* stream) {                                              \
    return launch_forces_v2_bwd_slab<T>(chunks, n_chunks, rest_rows,           \
                                        static_all, gidx_all, fmT, ld_fm, srT, \
                                        ld_sr, dfT, ld_df, dsr, ld_out, group, \
                                        inv_h, c4h, stream);                   \
  }                                                                            \
  int sb_slab_to_slots_##SUF(const void* buf, int64_t ld_buf, const void* ptr, \
                             const void* idx, void* out, int64_t ld_out,       \
                             int k, int n_slots, int group, void* stream) {    \
    return launch_slab_to_slots<T>(buf, ld_buf, ptr, idx, out, ld_out, k,      \
                                   n_slots, group, stream);                    \
  }

SB_BWD_ENTRIES(f32, float)
SB_BWD_ENTRIES(f64, double)

#define SB_SEP_ENTRIES(SUF, T)                                                 \
  int sb_forces_sep_##SUF(const void* sched, int n_sched,                      \
                          const void* rest_rows, const void* static_all,       \
                          const void* gidx_all, const void* gT, int64_t ld_g,  \
                          const void* vol, const void* rs6T, int64_t ld_rs6,   \
                          void* fT, int64_t ld_out, int group, double inv_h,   \
                          double c4h, int tail, void* stream) {                \
    return (tail ? launch_forces_sep<T, true> : launch_forces_sep<T, false>)(  \
        sched, n_sched, rest_rows, static_all, gidx_all, gT, ld_g, vol, rs6T,  \
        ld_rs6, fT, ld_out, group, inv_h, c4h, stream);                        \
  }                                                                            \
  int sb_forces_sep_bwd_##SUF(                                                 \
      const void* chunks, int n_chunks, const void* rest_rows,                 \
      const void* static_all, const void* vol, const void* rs6T,               \
      int64_t ld_rs6, const void* dfT, int64_t ld_df, void* dgs,               \
      int64_t ld_gs, void* dgr, int64_t ld_gr, int group, double inv_h,        \
      double c4h, int tail, void* stream) {                                    \
    return (tail ? launch_forces_sep_bwd<T, true>                              \
                 : launch_forces_sep_bwd<T, false>)(                           \
        chunks, n_chunks, rest_rows, static_all, vol, rs6T, ld_rs6, dfT,       \
        ld_df, dgs, ld_gs, dgr, ld_gr, group, inv_h, c4h, stream);             \
  }

SB_SEP_ENTRIES(f32, float)
SB_SEP_ENTRIES(f64, double)

}  // extern "C"
