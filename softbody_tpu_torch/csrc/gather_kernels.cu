// The gather backend's force evaluation and its VJP, hand-written for
// Hopper (sm_90a).  The gather backend keeps every particle's neighbours in
// a padded (n, K) table (core/types.py :: Topology): idx, c = w m_j,
// vj = V_j mask, xji = X_j - X_i, nw = grad W, all row-major; a pad entry
// points at its own row with c = vj = 0 and xji = nw = 0, so it adds
// nothing.  The evaluation is
//
//   gather_moments -> mid_records (csrc/mid_kernels.cu) -> gather_forces
//
// gather_moments_kernel      replaces what XLA compiles from
//                            softbody_tpu/ops/elasticity.py :: deformation's
//                            gather and two einsums (:41-52): per row
//                            A_i = sum_k c_ik p_ji (x) X_ji and
//                            Y_i = sum_k vj_ik p_ji (x) nW_ik, p_ji = p_j - p_i,
//                            j = idx[i, k], into ayT (18, n), row 3b+a =
//                            A[a][b], then Y the same way (mid_records'
//                            operand)
// gather_forces_kernel<SEP>  replaces elastic_forces' gathers and einsums
//                            (:70-100): force_i = 0.5 V_i (term_j + M_i
//                            sum_v_nw_i), with the Warp pairing (SEP false)
//                            term_j = sum_k R_j F_i (V_j S_j) nW_ik, R_j,
//                            S_j and V_j read from the source's packed
//                            record, and the Taichi pairing (SEP true)
//                            term_j = sum_k V_j M_j nW_ik
// gather_moments_bwd and gather_forces_bwd (entry points, two launches
//                            each: a row pass, then a source pass) replace
//                            XLA's VJPs of the same
//
// gather_moments reads its source (the positions) through a pointer and
// two strides (field f of row r at p[r * rs + f * fs]): the rows
// themselves on one device, the all-gathered or halo-exchanged array on a
// shard of the particle mesh (parallel/).  The forces read each source
// row's packed record, row-major and 16-byte aligned, with vector loads
// (float4, double2): Warp [S_6 | R^T_9 | V] (16 values: 64 bytes, two
// sectors, in f32), Taichi [M_9 | V | 0 | 0] (12).  On one device
// mid_records writes it beside fmT (csrc/mid_kernels.cu, the same values
// as srT's and fmT's, srT then a view of the Warp record); on a shard the
// exchange moves the same record.  A backward gives the cotangent of the
// rows' own terms and of the source (the readers' terms); the forces
// backward's record cotangent dsrc is lane-major, field f of source row r
// at dsrc[f * ld_src + r], so its first 15 rows are the dsrT (15, n)
// that mid_records_bwd reads (its V row zero; the Taichi pairing's M rows
// are added into dfmT's by ops/mid_kernels.py, the record being made
// from fmT).
//
// Design.  gather_moments: one warp per row, lanes walking k, so each load
// of a table field is coalesced; a fixed shuffle butterfly adds the lanes'
// partial sums.  The forces and the source passes: a group of 8, 16 or 32
// lanes per row, sized to K, walking RUN consecutive rows one after
// another, each lane loading a trip of U entries' table values (read once,
// evict-first) and then their records before any arithmetic; the Warp
// pairing's forward and row pass fetch the next trip's table values while
// a trip's records are in flight (the constants below, measured on the
// H100: PERF.md §6).  The source passes add the readers' terms of source
// row r in the CSR order of the table's inverse (inv_ptr[r] .. inv_ptr[r
// + 1]), lanes strided over that segment, then the butterfly: no float
// atomics, so gradients repeat bit for bit.  They stream the Topology's
// inv_row (the reader row, int32) and a per-entry static in that order
// (no division by K, no random read of the table): gather_forces_bwd's
// inv_nw (the entry's nW), recomputing each reader's terms from its rowrec
// ([F_i | h_i], h_i = 0.5 V_i df_i, which its row pass writes) and the
// source row's own record; gather_moments_bwd's inv_cxw ([c X_ji | vj
// nW_ik]), each reader's term from its row of the row-major cotangent
// dayR that the row pass writes.  Neither writes a per-entry buffer: the
// moments' rows' own term comes from the scene's sum_c_xji and sum_v_nw.
//
// What bounds them on an H100 SXM (3.35 TB/s): chip_smoke.py computes
// each bound from the run's shapes (the bytes each function must move;
// their flops are far under the FP32 peak).  At the ~112k scene in f32
// gather_moments streams idx (8 B), c, vj (4 B each), xji and nw (12 B
// each) per entry, 40 B x 8.95 M entries = 358 MB, 0.107 ms;
// gather_moments_bwd the inverse as one int32 index and the products
// c X_ji, vj nW_ik (28 B per entry, 0.079 ms with the rows' operands);
// gather_forces idx and nw (20 B per entry, 0.059 ms); gather_forces_bwd
// each table once, idx, nw and the inverse as one int32 index (24 B per
// entry, 0.073 ms), where the design moves 36 B (inv_nw, a second copy of
// nw in CSR order, buys the streamed source pass).  The records (7.2 MB),
// rowrec (5.4 MB) and dayR (9.0 MB) stay in the 50 MB L2, but each entry's
// gathered record (64 B Warp, 48 B rowrec, 80 B dayR) still crosses from
// L2 to the SM: measured, the forces and the source passes run near those
// bytes over an L2 rate of ~6 TB/s, not the DRAM bound (PERF.md §6-7).
// Arithmetic is true f32 (or f64): plain FMAs, no tensor cores.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launches.  Kernels launch on the caller's
// stream and allocate nothing: scratch comes from the wrapper.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GW = 8;                  // warps, so rows, per block
constexpr int GT = 32 * GW;
constexpr unsigned FULL = 0xffffffffu;

// A read-only per-row record: field f of row r at p[r * rs + f * fs].
template <typename T>
struct Rec {
  const T* p;
  int64_t rs, fs;
  __device__ __forceinline__ T operator()(int64_t r, int f) const {
    return p[r * rs + f * fs];
  }
};

// The gather table of n rows, K entries each (all row-major, contiguous).
template <typename T>
struct Table {
  const int64_t* idx;   // (n, K)
  const T* c;           // (n, K)   w m_j
  const T* vj;          // (n, K)   V_j mask
  const T* xji;         // (n, K, 3)
  const T* nw;          // (n, K, 3)
  int64_t n;
  int K;
};

// Every lane ends with the warp's sum of v, in one fixed order.
template <typename T, int NV>
__device__ __forceinline__ void warp_sum(T (&v)[NV]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int f = 0; f < NV; ++f) v[f] += __shfl_xor_sync(FULL, v[f], off);
}

// v[f] for a lane-dependent f, without indexing a register array
template <typename T, int NV>
__device__ __forceinline__ T pick(const T (&v)[NV], int f) {
  T out = v[0];
#pragma unroll
  for (int g = 1; g < NV; ++g)
    if (f == g) out = v[g];
  return out;
}

__device__ __forceinline__ int64_t warp_row() {
  return (int64_t)blockIdx.x * GW + (threadIdx.x >> 5);
}

// The field of S[a][b] in the symmetric stress's [s00 s01 s02 s11 s12 s22].
__device__ __forceinline__ constexpr int sym6(int a, int b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}

// ------------------------------------------------------------ forward
template <typename T>
__global__ void __launch_bounds__(GT)
gather_moments_kernel(Table<T> tb, Rec<T> pos, Rec<T> src, T* __restrict__ ayT,
                      int64_t ld_ay) {
  const int lane = threadIdx.x & 31;
  const int64_t i = warp_row();
  if (i >= tb.n) return;                    // the warp's rows leave together
  const T p0 = pos(i, 0), p1 = pos(i, 1), p2 = pos(i, 2);
  T acc[18];
#pragma unroll
  for (int f = 0; f < 18; ++f) acc[f] = T(0);
  const int64_t row = i * tb.K;
  for (int k = lane; k < tb.K; k += 32) {
    const int64_t e = row + k;
    const int64_t j = tb.idx[e];
    const T d[3] = {src(j, 0) - p0, src(j, 1) - p1, src(j, 2) - p2};
    const T ce = tb.c[e], ve = tb.vj[e];
    const T x[3] = {tb.xji[3 * e], tb.xji[3 * e + 1], tb.xji[3 * e + 2]};
    const T w[3] = {tb.nw[3 * e], tb.nw[3 * e + 1], tb.nw[3 * e + 2]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T cd = ce * d[a], vd = ve * d[a];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        acc[3 * b + a] += cd * x[b];
        acc[9 + 3 * b + a] += vd * w[b];
      }
    }
  }
  warp_sum(acc);
  if (lane < 18) ayT[lane * ld_ay + i] = pick(acc, lane);
}

// ------------------------------------------------------------ the forces
// The forces read each neighbour's packed source record, row-major, one
// per source row, 16-byte aligned: Warp [S_6 | R^T_9 | V] (16 values,
// field 6 + 3c + a = R[a][c]), Taichi [M_9 | V | 0 | 0] (12, field 3a + b
// = M[a][b]).  The forces backward's per-row scratch rowrec: Warp
// [F_9 | h_3] (12 values), Taichi [h_3 | 0] (4).
template <bool SEP> constexpr int REC_W = SEP ? 12 : 16;
template <bool SEP> constexpr int ROW_W = SEP ? 4 : 12;
template <bool SEP> constexpr int VOL = SEP ? 9 : 15;   // V's field

// How a kernel walks its rows (measured on the H100, PERF.md): a group of
// G lanes (8, 16 or 32, aligned in its warp; GT / G groups a block) takes
// RUN consecutive rows (or source rows) one after another, lane l taking
// the entries l, l + G, ... of a row, U a trip: their table entries, then
// their records, are loaded before any arithmetic on them.  G is the
// fewest lanes whose trip covers a row (lanes_for).  The Warp pairing's
// forward takes U = 1 (32 lanes at K = 80) and RUN = 1, its row pass U = 1
// and RUN = 8, both fetching the next trip's table entries (of the row, or
// of the next row in the run) while a trip's records are in flight
// (AHEAD); the Taichi forward U = 5 (16 lanes) and RUN = 4, the Taichi row
// pass (no table) RUN = 1, the forces' source pass U = 5 and RUN = 4
// (the moments' source pass: below); f64 U = 2.
template <typename T, int U32>
constexpr int UNROLL = sizeof(T) == 4 ? U32 : 2;
template <typename T, bool SEP> constexpr int ROWS_U = UNROLL<T, SEP ? 5 : 1>;
template <bool SEP> constexpr int FWD_RUN = SEP ? 4 : 1;
template <bool SEP> constexpr int ROWS_RUN = SEP ? 1 : 8;
template <bool SEP> constexpr bool AHEAD = !SEP;
template <typename T> constexpr int SRC_U = UNROLL<T, 5>;
constexpr int SRC_RUN = 4;
// f32: at most 128 registers, so two blocks (16 warps) reside per SM; the
// Warp forward at most 64, so four (32 warps: at 65 registers, three
// blocks, it ran 9% slower on the H100)
#define FORCES_BOUNDS __launch_bounds__(GT, sizeof(T) == 4 ? 2 : 1)
#define FWD_BOUNDS __launch_bounds__(GT, sizeof(T) == 4 ? (SEP ? 2 : 4) : 1)

// The first of the RUN rows of this thread's group.
template <int G, int RUN>
__device__ __forceinline__ int64_t group_first() {
  return ((int64_t)blockIdx.x * (GT / G) + threadIdx.x / G) * RUN;
}

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) return FULL;
  else return ((1u << G) - 1) << (threadIdx.x & 31 & ~(G - 1));
}

// Every lane of the group ends with the group's sum of v, in one fixed
// order (a butterfly of log2 G rounds).
template <int G, typename T, int NV>
__device__ __forceinline__ void group_sum(T (&v)[NV]) {
  const unsigned mask = group_mask<G>();
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int f = 0; f < NV; ++f) v[f] += __shfl_xor_sync(mask, v[f], off);
}

// A table value read once, marked evict-first (ld.global.cs).
__device__ __forceinline__ int64_t ld_once(const int64_t* p) {
  return (int64_t)__ldcs(reinterpret_cast<const long long*>(p));
}
template <typename X>
__device__ __forceinline__ X ld_once(const X* p) { return __ldcs(p); }

// One trip's table entries of a lane, e = e0 + G u for u < U while
// e < end: the row (or reader row) each reads and its NW per-entry values
// (nW; the moments' source pass [c X_ji | vj nW]); ok[u] says whether
// entry u exists.
template <typename T, int U, int NW = 3>
struct Trip {
  int64_t j[U];
  T w[U][NW];
  bool ok[U];
};

template <typename T, int U, int G, int NW, typename Ix>
__device__ __forceinline__ void fetch(Trip<T, U, NW>& tr, const Ix* __restrict__ rows_of,
                                      const T* __restrict__ nws, int64_t e0, int64_t end) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    tr.ok[u] = e0 + G * u < end;
    if (tr.ok[u]) tr.j[u] = ld_once(rows_of + e0 + G * u);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tr.ok[u]) {
      const int64_t e = e0 + G * u;
#pragma unroll
      for (int f = 0; f < NW; ++f) tr.w[u][f] = ld_once(nws + NW * e + f);
    }
}

// The trip's records: row j's W values of rec for each entry.
template <typename T, int U, int W, int NW>
__device__ __forceinline__ void records(const Trip<T, U, NW>& tr, const T* __restrict__ rec,
                                        T (&r)[U][W]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tr.ok[u]) load_vec<T, W>(rec + tr.j[u] * W, r[u]);
}

// Trip ``trip`` of row i (of ``trips``; rows up to ``last`` in the group's
// run) into cur and its records into r.  With AHEAD its table entries are
// those fetched into ``next`` during the trip before, and the next trip's
// (the row's, or the next row's first) are fetched into ``next`` while
// the records load.
template <typename T, int U, int W, int G, bool AHEAD>
__device__ __forceinline__ void take_trip(Trip<T, U>& cur, Trip<T, U>& next,
                                          const int64_t* __restrict__ idx,
                                          const T* __restrict__ nw, const T* __restrict__ rec,
                                          int64_t i, int trip, int trips, int64_t last, int K,
                                          int l, T (&r)[U][W]) {
  constexpr int STEP = G * U;
  const int64_t e0 = i * K + trip * STEP + l;
  if (AHEAD) cur = next;
  else fetch<T, U, G>(cur, idx, nw, e0, i * K + K);
  records<T, U, W>(cur, rec, r);
  if (AHEAD) {
    if (trip + 1 < trips) fetch<T, U, G>(next, idx, nw, e0 + STEP, i * K + K);
    else if (i + 1 < last) fetch<T, U, G>(next, idx, nw, (i + 1) * K + l, (i + 1) * K + K);
  }
}

// Forces of n rows from fmT (19, ld_fm) = [F_9 | M_9 | V] of the rows (row
// 3a+b = [a][b]) and the source's packed records: lane l of a row's group
// takes its entries k = l, l + G, ..., U a trip.
template <typename T, bool SEP, int G>
__global__ void FWD_BOUNDS
gather_forces_kernel(const int64_t* __restrict__ idx, const T* __restrict__ nw,
                     int64_t n, int K, const T* __restrict__ svnw,
                     const T* __restrict__ fmT, int64_t ld_fm, const T* __restrict__ rec,
                     T* __restrict__ out) {
  constexpr int RUN = FWD_RUN<SEP>, W = REC_W<SEP>, U = ROWS_U<T, SEP>;
  const int l = threadIdx.x % G;
  const int64_t first = group_first<G, RUN>();
  const int64_t last = first + RUN < n ? first + RUN : n;
  const int trips = (K + G * U - 1) / (G * U);
  Trip<T, U> cur, next;
  if (AHEAD<SEP> && first < last) fetch<T, U, G>(next, idx, nw, first * K + l, first * K + K);
  for (int64_t i = first; i < last; ++i) {          // the group's lanes stay together
    // the epilogue's operands first: lane a < 3 ends with force_i[a]
    const int a_out = l < 3 ? l : 0;
    const T m_a[3] = {fmT[(9 + 3 * a_out) * ld_fm + i], fmT[(10 + 3 * a_out) * ld_fm + i],
                      fmT[(11 + 3 * a_out) * ld_fm + i]};
    const T sv[3] = {svnw[3 * i], svnw[3 * i + 1], svnw[3 * i + 2]};
    const T vi = fmT[18 * ld_fm + i];
    T F[9];
    if (!SEP) {
#pragma unroll
      for (int f = 0; f < 9; ++f) F[f] = fmT[f * ld_fm + i];
    }
    T t[3] = {T(0), T(0), T(0)};
    for (int trip = 0; trip < trips; ++trip) {
      T r[U][W];
      take_trip<T, U, W, G, AHEAD<SEP>>(cur, next, idx, nw, rec, i, trip, trips, last, K,
                                        l, r);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!cur.ok[u]) continue;
        const T* w = cur.w[u];
        if (SEP) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            t[a] += r[u][9] * (r[u][3 * a] * w[0] + r[u][3 * a + 1] * w[1]
                               + r[u][3 * a + 2] * w[2]);
        } else {
          T vs[3], y[3];
#pragma unroll
          for (int b = 0; b < 3; ++b)
            vs[b] = r[u][15] * (r[u][sym6(b, 0)] * w[0] + r[u][sym6(b, 1)] * w[1]
                                + r[u][sym6(b, 2)] * w[2]);
#pragma unroll
          for (int a = 0; a < 3; ++a)
            y[a] = F[3 * a] * vs[0] + F[3 * a + 1] * vs[1] + F[3 * a + 2] * vs[2];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            t[a] += r[u][6 + a] * y[0] + r[u][9 + a] * y[1] + r[u][12 + a] * y[2];
        }
      }
    }
    group_sum<G>(t);
    if (l < 3) {
      const T ti = m_a[0] * sv[0] + m_a[1] * sv[1] + m_a[2] * sv[2];
      out[3 * i + l] = T(0.5) * vi * (pick(t, l) + ti);
    }
  }
}

// Row pass of gather_forces' VJP, h_i = 0.5 V_i df_i: dfmT's rows 0-8 the
// Warp pairing's dF_i = sum_k (R_j^T h_i) (x) (V_j S_j nW_ik) (zero in the
// Taichi pairing, which reads no record here), rows 9-17 dM_i = h_i (x)
// sum_v_nw_i, row 18 zero; and the row's rowrec for the source pass.
template <typename T, bool SEP, int G>
__global__ void FORCES_BOUNDS
gather_forces_bwd_rows(const int64_t* __restrict__ idx, const T* __restrict__ nw,
                       int64_t n, int K, const T* __restrict__ svnw,
                       const T* __restrict__ fmT, int64_t ld_fm, const T* __restrict__ rec,
                       const T* __restrict__ df, T* __restrict__ dfmT, int64_t ld_dfm,
                       T* __restrict__ rowrec) {
  constexpr int RUN = ROWS_RUN<SEP>, W = REC_W<SEP>, RW = ROW_W<SEP>, U = ROWS_U<T, SEP>;
  const int l = threadIdx.x % G;
  const int64_t first = group_first<G, RUN>();
  const int64_t last = first + RUN < n ? first + RUN : n;
  const int trips = SEP ? 0 : (K + G * U - 1) / (G * U);
  Trip<T, U> cur, next;
  if (AHEAD<SEP> && first < last) fetch<T, U, G>(next, idx, nw, first * K + l, first * K + K);
  for (int64_t i = first; i < last; ++i) {
    const T vi = T(0.5) * fmT[18 * ld_fm + i];
    const T h[3] = {vi * df[3 * i], vi * df[3 * i + 1], vi * df[3 * i + 2]};
    // the epilogue's operands first: rows 9-17 of dfmT are h (x) sum_v_nw,
    // rowrec Warp [F_9 | h_3], Taichi [h_3 | 0]
    const T sv[3] = {svnw[3 * i], svnw[3 * i + 1], svnw[3 * i + 2]};
    T F[9];
    if (!SEP) {
#pragma unroll
      for (int f = 0; f < 9; ++f) F[f] = fmT[f * ld_fm + i];
    }
    T dF[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) dF[f] = T(0);
    for (int trip = 0; trip < trips; ++trip) {
      T r[U][W];
      take_trip<T, U, W, G, AHEAD<SEP>>(cur, next, idx, nw, rec, i, trip, trips, last, K,
                                        l, r);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!cur.ok[u]) continue;
        const T* w = cur.w[u];
        T vs[3], dy[3];
#pragma unroll
        for (int b = 0; b < 3; ++b)
          vs[b] = r[u][15] * (r[u][sym6(b, 0)] * w[0] + r[u][sym6(b, 1)] * w[1]
                              + r[u][sym6(b, 2)] * w[2]);
        // dy = R_j^T h: R^T_9 field 6 + 3c + a = R[a][c]
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dy[c] = r[u][6 + 3 * c] * h[0] + r[u][7 + 3 * c] * h[1] + r[u][8 + 3 * c] * h[2];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) dF[3 * a + b] += dy[a] * vs[b];
      }
    }
    if (!SEP) group_sum<G>(dF);
    for (int f = l; f < 19; f += G) {
      T v = T(0);
      if (f < 9)
        v = pick(dF, f);
      else if (f < 18)
        v = pick(h, (f - 9) / 3) * pick(sv, (f - 9) % 3);
      dfmT[f * ld_dfm + i] = v;
    }
    for (int f = l; f < RW; f += G)
      rowrec[RW * i + f] =
          SEP ? (f < 3 ? pick(h, f) : T(0)) : (f < 9 ? pick(F, f) : pick(h, f - 9));
  }
}

// Source pass of gather_forces' VJP: source row r's cotangent from its
// readers in CSR order, streamed: at q in [ptr[r], ptr[r + 1]) the reader
// row inv_row[q] and its entry's nW inv_nw[q], whose terms are recomputed
// from the reader's rowrec and r's own record.  Warp: dR_r += h_i (x) y,
// y = F_i (V_r S_r nW), dVS_r += (F_i^T R_r^T h_i) (x) nW, then dS_6 =
// V_r (dVS + dVS^T) folded onto the six fields and dR^T_9; Taichi: dM_r =
// V_r sum h_i (x) nW.  dsrc is lane-major: field f of source row r at
// dsrc[f * ld_src + r], the record's V field (and the Taichi pairing's
// padding) zero.
template <typename T, bool SEP, int G>
__device__ __forceinline__ void bwd_src_row(int64_t r, const int64_t* __restrict__ ptr,
                                            const int32_t* __restrict__ inv_row,
                                            const T* __restrict__ inv_nw,
                                            const T* __restrict__ rec,
                                            const T* __restrict__ rowrec,
                                            T* __restrict__ dsrc, int64_t ld_src) {
  constexpr int W = REC_W<SEP>, RW = ROW_W<SEP>, NV = SEP ? 9 : 18, U = SRC_U<T>;
  const int l = threadIdx.x % G;
  T own[W];
  load_vec<T, W>(rec + r * W, own);
  const T vr = own[VOL<SEP>];
  T acc[NV];                   // Warp: dR [a][b] at 3a+b, then dVS [b][c]
#pragma unroll
  for (int f = 0; f < NV; ++f) acc[f] = T(0);
  const int64_t end = ptr[r + 1];
  for (int64_t q0 = ptr[r] + l; q0 < end; q0 += G * U) {
    Trip<T, U> tr;
    T rr[U][RW];
    fetch<T, U, G>(tr, inv_row, inv_nw, q0, end);
    records<T, U, RW>(tr, rowrec, rr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!tr.ok[u]) continue;
      const T* w = tr.w[u];
      if (SEP) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) acc[3 * a + b] += rr[u][a] * w[b];
      } else {
        const T h[3] = {rr[u][9], rr[u][10], rr[u][11]};
        T vs[3], y[3], dy[3], uu[3];
#pragma unroll
        for (int b = 0; b < 3; ++b)
          vs[b] = vr * (own[sym6(b, 0)] * w[0] + own[sym6(b, 1)] * w[1]
                        + own[sym6(b, 2)] * w[2]);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          y[a] = rr[u][3 * a] * vs[0] + rr[u][3 * a + 1] * vs[1] + rr[u][3 * a + 2] * vs[2];
        // R[a][c] = own[6 + 3c + a]
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dy[c] = own[6 + 3 * c] * h[0] + own[7 + 3 * c] * h[1] + own[8 + 3 * c] * h[2];
#pragma unroll
        for (int b = 0; b < 3; ++b)
          uu[b] = rr[u][b] * dy[0] + rr[u][3 + b] * dy[1] + rr[u][6 + b] * dy[2];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            acc[3 * a + b] += h[a] * y[b];
            acc[9 + 3 * a + b] += uu[a] * w[b];
          }
      }
    }
  }
  group_sum<G>(acc);
  for (int f = l; f < W; f += G) {
    T v = T(0);
    if (SEP) {
      if (f < 9) v = vr * pick(acc, f);
    } else if (f < 6) {
      const int a = f < 3 ? 0 : (f < 5 ? 1 : 2);
      const int b = f < 3 ? f : (f < 5 ? f - 2 : 2);
      v = a == b ? vr * pick(acc, 9 + 4 * a)
                 : vr * (pick(acc, 9 + 3 * a + b) + pick(acc, 9 + 3 * b + a));
    } else if (f < 15) {
      const int c = (f - 6) / 3, a = (f - 6) % 3;   // R^T_9: R[a][c]
      v = pick(acc, 3 * a + c);
    }
    dsrc[f * ld_src + r] = v;
  }
}

template <typename T, bool SEP, int G>
__global__ void FORCES_BOUNDS
gather_forces_bwd_src(const int64_t* __restrict__ ptr, const int32_t* __restrict__ inv_row,
                      const T* __restrict__ inv_nw, int64_t n_src, const T* __restrict__ rec,
                      const T* __restrict__ rowrec, T* __restrict__ dsrc, int64_t ld_src) {
  const int64_t first = group_first<G, SRC_RUN>();
  const int64_t last = first + SRC_RUN < n_src ? first + SRC_RUN : n_src;
  for (int64_t r = first; r < last; ++r)
    bwd_src_row<T, SEP, G>(r, ptr, inv_row, inv_nw, rec, rowrec, dsrc, ld_src);
}

// ------------------------------------------------------------ the moments' VJP
// gather_moments' VJP, g_ik = dA_i (c X_ji) + dY_i (vj nW_ik) the cotangent
// of entry k's p_j (dA[a][b] = dayT row 3b+a, dY the same from row 9).
// Its row pass writes each row's cotangent row-major, DAY_W values (dayT's
// 18 and two zeros: whole 16-byte pieces), for the source pass's gathers,
// and the row's own term -sum_k g_ik = -(dA_i sum_c_xji_i + dY_i
// sum_v_nw_i) from the scene's two sums, reading no table.  Its source pass
// streams inv_row and inv_cxw ([c X_ji | vj nW_ik] in CSR order) and
// gathers each reader's row.  Its walk (measured on the H100, PERF.md
// §6): U = 1 (32 lanes at K = 80), RUN = 4, at most 64 registers in f32
// so four blocks (32 warps) reside per SM; wider trips (U = 2-5) and runs
// of 1, 2 or 8 rows ran 5-42% slower.
constexpr int DAY_W = 20;
template <typename T> constexpr int MSRC_U = UNROLL<T, 1>;
constexpr int MSRC_RUN = 4;

template <typename T>
__global__ void __launch_bounds__(GT)
gather_moments_bwd_rows(const T* __restrict__ dayT, int64_t ld_ay,
                        const T* __restrict__ sum_cx, const T* __restrict__ sum_vw,
                        int64_t n, T* __restrict__ dayR, T* __restrict__ drow) {
  const int64_t i = (int64_t)blockIdx.x * GT + threadIdx.x;
  if (i >= n) return;
  T v[DAY_W];
#pragma unroll
  for (int f = 0; f < 18; ++f) v[f] = dayT[f * ld_ay + i];
  v[18] = v[19] = T(0);
  store_vec<T, DAY_W>(dayR + i * DAY_W, v);
  const T sc[3] = {sum_cx[3 * i], sum_cx[3 * i + 1], sum_cx[3 * i + 2]};
  const T sv[3] = {sum_vw[3 * i], sum_vw[3 * i + 1], sum_vw[3 * i + 2]};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    drow[3 * i + a] = -((v[a] * sc[0] + v[3 + a] * sc[1] + v[6 + a] * sc[2])
                        + (v[9 + a] * sv[0] + v[12 + a] * sv[1] + v[15 + a] * sv[2]));
}

// Source row r's cotangent: the sum of its readers' g in CSR order, lane l
// of r's group taking q = ptr[r] + l, + G, ..., U a trip (the reader rows
// and their products, then the readers' rows, before any arithmetic); with
// ``merge`` (the source is the rows) added to the row's own term, which
// the row pass left in dsrc.
template <typename T, int G>
__global__ void __launch_bounds__(GT, sizeof(T) == 4 ? 4 : 1)
gather_moments_bwd_src(const int64_t* __restrict__ ptr, const int32_t* __restrict__ inv_row,
                       const T* __restrict__ inv_cxw, int64_t n_src,
                       const T* __restrict__ dayR, int merge, T* __restrict__ dsrc,
                       int64_t rs, int64_t fs) {
  constexpr int U = MSRC_U<T>;
  const int l = threadIdx.x % G;
  const int64_t first = group_first<G, MSRC_RUN>();
  const int64_t last = first + MSRC_RUN < n_src ? first + MSRC_RUN : n_src;
  for (int64_t r = first; r < last; ++r) {      // the group's lanes stay together
    T s[3] = {T(0), T(0), T(0)};
    const int64_t end = ptr[r + 1];
    for (int64_t q0 = ptr[r] + l; q0 < end; q0 += G * U) {
      Trip<T, U, 6> tr;
      T d[U][DAY_W];
      fetch<T, U, G>(tr, inv_row, inv_cxw, q0, end);
      records<T, U, DAY_W>(tr, dayR, d);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!tr.ok[u]) continue;
        const T* p = tr.w[u];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          s[a] += (d[u][a] * p[0] + d[u][3 + a] * p[1] + d[u][6 + a] * p[2])
                  + (d[u][9 + a] * p[3] + d[u][12 + a] * p[4] + d[u][15 + a] * p[5]);
      }
    }
    group_sum<G>(s);
    if (l < 3) {
      T* out = dsrc + r * rs + l * fs;
      const T v = pick(s, l);
      *out = merge ? *out + v : v;
    }
  }
}

// Lanes a row for rows of (mean) length len taken u entries a lane a trip:
// 8, 16 or 32, the fewest whose trip covers the row.
int lanes_for(double len, int u) { return len <= 8 * u ? 8 : (len <= 16 * u ? 16 : 32); }

// ... for the forward and the row pass at K entries a row, and for the
// source pass at a mean of len readers a source row
template <typename T>
int rows_lanes(double K, bool sep) { return lanes_for(K, sep ? ROWS_U<T, true> : ROWS_U<T, false>); }
template <typename T>
int src_lanes(double len) { return lanes_for(len, SRC_U<T>); }
template <typename T>
int msrc_lanes(double len) { return lanes_for(len, MSRC_U<T>); }

// Blocks for rows walked run at a time by groups of g lanes.
unsigned groups_for(int64_t rows, int g, int run) {
  const int64_t per = (int64_t)(GT / g) * run;
  return (unsigned)((rows + per - 1) / per);
}

// f(lanes) with lanes as a compile-time constant
template <typename F>
void with_group(int g, F&& f) {
  if (g == 8) f(std::integral_constant<int, 8>{});
  else if (g == 16) f(std::integral_constant<int, 16>{});
  else f(std::integral_constant<int, 32>{});
}

// f(pairing, lanes) with both as compile-time constants
template <typename F>
void with_lanes(bool sep, int g, F&& f) {
  auto go = [&](auto s) { with_group(g, [&](auto gc) { f(s, gc); }); };
  if (sep) go(std::true_type{});
  else go(std::false_type{});
}

unsigned blocks_for(int64_t rows) { return (unsigned)((rows + GW - 1) / GW); }

template <typename T>
int launch_moments(const void* idx, const void* c, const void* vj, const void* xji,
                   const void* nw, int64_t n, int K, const void* pos, int64_t pos_rs,
                   int64_t pos_fs, const void* src, int64_t src_rs, int64_t src_fs,
                   void* ayT, int64_t ld_ay, void* stream) {
  if (n == 0) return 0;
  const Table<T> tb{(const int64_t*)idx, (const T*)c, (const T*)vj, (const T*)xji,
                    (const T*)nw, n, K};
  gather_moments_kernel<T><<<blocks_for(n), GT, 0, (cudaStream_t)stream>>>(
      tb, Rec<T>{(const T*)pos, pos_rs, pos_fs}, Rec<T>{(const T*)src, src_rs, src_fs},
      (T*)ayT, ld_ay);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_moments_bwd(int64_t n, int K, const void* sum_cx, const void* sum_vw,
                       const void* ptr, const void* inv_row, const void* inv_cxw,
                       int64_t n_src, const void* dayT, int64_t ld_ay, void* dayR,
                       void* drow, int merge, void* dsrc, int64_t rs, int64_t fs,
                       void* stream) {
  if (n > 0) {
    gather_moments_bwd_rows<T><<<(unsigned)((n + GT - 1) / GT), GT, 0,
                                 (cudaStream_t)stream>>>(
        (const T*)dayT, ld_ay, (const T*)sum_cx, (const T*)sum_vw, n, (T*)dayR, (T*)drow);
    if (int e = (int)cudaGetLastError()) return e;
  }
  if (n_src > 0) {
    with_group(msrc_lanes<T>((double)n * K / n_src), [&](auto gc) {
      constexpr int G = decltype(gc)::value;
      gather_moments_bwd_src<T, G><<<groups_for(n_src, G, MSRC_RUN), GT, 0,
                                     (cudaStream_t)stream>>>(
          (const int64_t*)ptr, (const int32_t*)inv_row, (const T*)inv_cxw, n_src,
          (const T*)dayR, merge, (T*)dsrc, rs, fs);
    });
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces(const void* idx, const void* nw, int64_t n, int K, const void* svnw,
                  const void* fmT, int64_t ld_fm, const void* rec, void* out, int sep,
                  void* stream) {
  if (n == 0) return 0;
  with_lanes(sep != 0, rows_lanes<T>(K, sep != 0), [&](auto s, auto gc) {
    constexpr bool SEP = decltype(s)::value;
    constexpr int G = decltype(gc)::value;
    gather_forces_kernel<T, SEP, G><<<groups_for(n, G, FWD_RUN<SEP>), GT, 0,
                                      (cudaStream_t)stream>>>(
        (const int64_t*)idx, (const T*)nw, n, K, (const T*)svnw, (const T*)fmT, ld_fm,
        (const T*)rec, (T*)out);
  });
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd(const void* idx, const void* nw, int64_t n, int K,
                      const void* svnw, const void* fmT, int64_t ld_fm, const void* rec,
                      int64_t n_src, const void* df, const void* ptr, const void* inv_row,
                      const void* inv_nw, void* dfmT, int64_t ld_dfm, void* rowrec,
                      void* dsrc, int64_t ld_src, int sep, void* stream) {
  if (n > 0) {
    with_lanes(sep != 0, rows_lanes<T>(K, sep != 0), [&](auto s, auto gc) {
      constexpr bool SEP = decltype(s)::value;
      constexpr int G = decltype(gc)::value;
      gather_forces_bwd_rows<T, SEP, G><<<groups_for(n, G, ROWS_RUN<SEP>), GT, 0,
                                          (cudaStream_t)stream>>>(
          (const int64_t*)idx, (const T*)nw, n, K, (const T*)svnw, (const T*)fmT, ld_fm,
          (const T*)rec, (const T*)df, (T*)dfmT, ld_dfm, (T*)rowrec);
    });
    if (int e = (int)cudaGetLastError()) return e;
  }
  if (n_src > 0) {
    with_lanes(sep != 0, src_lanes<T>((double)n * K / n_src), [&](auto s, auto gc) {
      constexpr bool SEP = decltype(s)::value;
      constexpr int G = decltype(gc)::value;
      gather_forces_bwd_src<T, SEP, G><<<groups_for(n_src, G, SRC_RUN), GT, 0,
                                         (cudaStream_t)stream>>>(
          (const int64_t*)ptr, (const int32_t*)inv_row, (const T*)inv_nw, n_src,
          (const T*)rec, (const T*)rowrec, (T*)dsrc, ld_src);
    });
  }
  return (int)cudaGetLastError();
}

// registers, local bytes (stack and spills), threads per block and
// resident blocks per SM of one kernel at K entries a row (which: 0
// gather_forces, 1 its backward's row pass, 2 its source pass, at a mean of
// K readers a source row, the Warp pairing's or with sep the Taichi one's;
// 3 gather_moments_bwd's source pass, at a mean of K readers) and its lanes
// a row
template <typename T>
int kernel_info(int which, int sep, double K, int* out) {
  const void* kernel = nullptr;
  const int g = which == 3   ? msrc_lanes<T>(K)
                : which == 2 ? src_lanes<T>(K)
                             : rows_lanes<T>(K, sep != 0);
  with_lanes(sep != 0, g, [&](auto s, auto gc) {
    constexpr bool SEP = decltype(s)::value;
    constexpr int G = decltype(gc)::value;
    kernel = which == 0   ? (const void*)gather_forces_kernel<T, SEP, G>
             : which == 1 ? (const void*)gather_forces_bwd_rows<T, SEP, G>
             : which == 2 ? (const void*)gather_forces_bwd_src<T, SEP, G>
                          : (const void*)gather_moments_bwd_src<T, G>;
  });
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kernel)) return (int)e;
  int blocks = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, GT, 0))
    return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = GT;
  out[3] = blocks;
  out[4] = g;
  return 0;
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

#define SB_GATHER_ENTRIES(SUF, T)                                                \
  int sb_gather_moments_##SUF(const void* idx, const void* c, const void* vj,    \
                              const void* xji, const void* nw, int64_t n, int K, \
                              const void* pos, int64_t pos_rs, int64_t pos_fs,   \
                              const void* src, int64_t src_rs, int64_t src_fs,   \
                              void* ayT, int64_t ld_ay, void* stream) {          \
    return launch_moments<T>(idx, c, vj, xji, nw, n, K, pos, pos_rs, pos_fs, src, \
                             src_rs, src_fs, ayT, ld_ay, stream);                \
  }                                                                              \
  int sb_gather_moments_bwd_##SUF(                                               \
      int64_t n, int K, const void* sum_cx, const void* sum_vw, const void* ptr, \
      const void* inv_row, const void* inv_cxw, int64_t n_src, const void* dayT, \
      int64_t ld_ay, void* dayR, void* drow, int merge, void* dsrc, int64_t rs,  \
      int64_t fs, void* stream) {                                                \
    return launch_moments_bwd<T>(n, K, sum_cx, sum_vw, ptr, inv_row, inv_cxw,    \
                                 n_src, dayT, ld_ay, dayR, drow, merge, dsrc,    \
                                 rs, fs, stream);                                \
  }                                                                              \
  int sb_gather_forces_##SUF(const void* idx, const void* nw, int64_t n, int K,  \
                             const void* svnw, const void* fmT, int64_t ld_fm,   \
                             const void* rec, void* out, int sep, void* stream) { \
    return launch_forces<T>(idx, nw, n, K, svnw, fmT, ld_fm, rec, out, sep,      \
                            stream);                                             \
  }                                                                              \
  int sb_gather_forces_bwd_##SUF(                                                \
      const void* idx, const void* nw, int64_t n, int K, const void* svnw,       \
      const void* fmT, int64_t ld_fm, const void* rec, int64_t n_src,            \
      const void* df, const void* ptr, const void* inv_row, const void* inv_nw,  \
      void* dfmT, int64_t ld_dfm, void* rowrec, void* dsrc, int64_t ld_src,      \
      int sep, void* stream) {                                                   \
    return launch_forces_bwd<T>(idx, nw, n, K, svnw, fmT, ld_fm, rec, n_src, df, \
                                ptr, inv_row, inv_nw, dfmT, ld_dfm, rowrec, dsrc, \
                                ld_src, sep, stream);                            \
  }

SB_GATHER_ENTRIES(f32, float)
SB_GATHER_ENTRIES(f64, double)

// kernel_info of the f32 (mode 0) or f64 (mode 1) instantiation; out: 5 ints
int sb_gather_info(int which, int sep, double K, int mode, int* out) {
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return mode ? kernel_info<double>(which, sep, K, out)
              : kernel_info<float>(which, sep, K, out);
}

}  // extern "C"
