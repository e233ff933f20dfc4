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
//                            term_j = sum_k R_j F_i (V_j S_j) nW_ik, R_j and
//                            S_j read from the source's [S_6 | R^T_9]
//                            record, and the Taichi pairing (SEP true)
//                            term_j = sum_k V_j M_j nW_ik
// gather_moments_bwd and gather_forces_bwd (entry points, two launches
//                            each: a row pass, then a source pass) replace
//                            XLA's VJPs of the same
//
// The neighbours are read from a source of n_src rows, given as a pointer
// and two strides (field f of row r at p[r * rs + f * fs]): the rows
// themselves on one device, the all-gathered or halo-exchanged array on a
// shard of the particle mesh (parallel/).  A backward gives the cotangent
// of the rows' own terms and of the source (the readers' terms).
//
// Design: one warp per row (forward and row passes) or per source row
// (source passes).  The tables are row-major, K entries per row (K = 80
// at the ~112k stretch scene): one thread per row would read them with a
// stride of K x 12 bytes, so the warp's lanes walk k instead and each load
// of a table field is coalesced.  Each lane keeps partial sums in
// registers and a fixed butterfly of shuffles adds them (every lane ends
// with the same bits), so a row's result does not depend on timing.  The
// source passes add the readers' terms of source row r in the CSR order of
// the table's inverse (Topology.inv_order at inv_ptr[r] .. inv_ptr[r + 1]),
// lanes strided over that segment, then the same butterfly: no float
// atomics, so gradients repeat bit for bit.  gather_moments_bwd's row pass
// keeps each entry's term g_ik (3 values) in a scratch buffer that its
// source pass sums; gather_forces_bwd's row pass keeps each row's
// [F_i | h_i] (12 values, h_i = 0.5 V_i df_i) and its source pass
// recomputes each reader's terms from it, the entry's nW and the source
// row's own record, so no (n, K, 15) buffer is written.
//
// What bounds them on an H100 SXM (3.35 TB/s): the table bytes.  At the
// ~112k scene in f32 gather_moments reads idx (8 B), c, vj (4 B each),
// xji and nw (12 B each) per entry, 40 B x 8.95 M entries = 358 MB, 0.107 ms;
// its ~42 flops per entry take 0.006 ms at 67 TFLOP/s.  gather_forces
// reads idx and nw (20 B per entry); the source records (64 B per row)
// stay in the 50 MB L2.  chip_smoke.py computes each bound from the run's
// shapes.  Arithmetic is true f32 (or f64): plain FMAs, no tensor cores.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launches.  Kernels launch on the caller's
// stream and allocate nothing: scratch comes from the wrapper.

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

// The CSR inverse of idx over n_src source rows.
struct Inverse {
  const int64_t* order;   // (n K,) flat entries, grouped by the row they read
  const int64_t* ptr;     // (n_src + 1,)
  int64_t n_src;
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

// fmT (19, ld_fm) = [F_9 | M_9 | V] of the rows (row 3a+b = [a][b]); the
// source record: Warp [S_6 | R^T_9] (field 6 + 3c + a = R[a][c]), Taichi
// M_9; vsrc the source's volumes.
template <typename T, bool SEP>
__global__ void __launch_bounds__(GT)
gather_forces_kernel(const int64_t* __restrict__ idx, const T* __restrict__ nw,
                     int64_t n, int K, const T* __restrict__ svnw,
                     const T* __restrict__ fmT, int64_t ld_fm, Rec<T> src, Rec<T> vsrc,
                     T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i = warp_row();
  if (i >= n) return;
  T F[3][3];
  if (!SEP) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) F[a][b] = fmT[(3 * a + b) * ld_fm + i];
  }
  T t[3] = {T(0), T(0), T(0)};
  const int64_t row = i * K;
  for (int k = lane; k < K; k += 32) {
    const int64_t e = row + k;
    const int64_t j = idx[e];
    const T w[3] = {nw[3 * e], nw[3 * e + 1], nw[3 * e + 2]};
    const T vj = vsrc(j, 0);
    if (SEP) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        t[a] += vj * (src(j, 3 * a) * w[0] + src(j, 3 * a + 1) * w[1]
                      + src(j, 3 * a + 2) * w[2]);
    } else {
      T vs[3], y[3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        vs[b] = vj * (src(j, sym6(b, 0)) * w[0] + src(j, sym6(b, 1)) * w[1]
                      + src(j, sym6(b, 2)) * w[2]);
#pragma unroll
      for (int a = 0; a < 3; ++a) y[a] = F[a][0] * vs[0] + F[a][1] * vs[1] + F[a][2] * vs[2];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        t[a] += src(j, 6 + a) * y[0] + src(j, 9 + a) * y[1] + src(j, 12 + a) * y[2];
    }
  }
  warp_sum(t);
  if (lane < 3) {
    const int a = lane;
    const T ti = fmT[(9 + 3 * a) * ld_fm + i] * svnw[3 * i]
                 + fmT[(10 + 3 * a) * ld_fm + i] * svnw[3 * i + 1]
                 + fmT[(11 + 3 * a) * ld_fm + i] * svnw[3 * i + 2];
    out[3 * i + a] = T(0.5) * fmT[18 * ld_fm + i] * (pick(t, a) + ti);
  }
}

// ------------------------------------------------------------ backward
// Row pass of gather_moments' VJP: g_ik = c dA_i X_ji + vj dY_i nW_ik into
// g (n K, 3), and the rows' own term -sum_k g_ik into drow (n, 3).
template <typename T>
__global__ void __launch_bounds__(GT)
gather_moments_bwd_rows(Table<T> tb, const T* __restrict__ dayT, int64_t ld_ay,
                        T* __restrict__ g, T* __restrict__ drow) {
  const int lane = threadIdx.x & 31;
  const int64_t i = warp_row();
  if (i >= tb.n) return;
  T dA[3][3], dY[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      dA[a][b] = dayT[(3 * b + a) * ld_ay + i];
      dY[a][b] = dayT[(9 + 3 * b + a) * ld_ay + i];
    }
  T s[3] = {T(0), T(0), T(0)};
  const int64_t row = i * tb.K;
  for (int k = lane; k < tb.K; k += 32) {
    const int64_t e = row + k;
    const T ce = tb.c[e], ve = tb.vj[e];
    const T x[3] = {tb.xji[3 * e], tb.xji[3 * e + 1], tb.xji[3 * e + 2]};
    const T w[3] = {tb.nw[3 * e], tb.nw[3 * e + 1], tb.nw[3 * e + 2]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T ga = ce * (dA[a][0] * x[0] + dA[a][1] * x[1] + dA[a][2] * x[2])
                   + ve * (dY[a][0] * w[0] + dY[a][1] * w[1] + dY[a][2] * w[2]);
      g[3 * e + a] = ga;
      s[a] += ga;
    }
  }
  warp_sum(s);
  if (lane < 3) drow[3 * i + lane] = -pick(s, lane);
}

// Source pass of gather_moments' VJP: source row r's cotangent, the sum of
// its readers' g in CSR order (with ``merge``, plus the row's own term
// drow[r]: the source is the rows).
template <typename T>
__global__ void __launch_bounds__(GT)
gather_moments_bwd_src(Inverse inv, const T* __restrict__ g,
                       const T* __restrict__ drow, int merge, T* __restrict__ dsrc,
                       int64_t rs, int64_t fs) {
  const int lane = threadIdx.x & 31;
  const int64_t r = warp_row();
  if (r >= inv.n_src) return;
  T s[3] = {T(0), T(0), T(0)};
  const int64_t end = inv.ptr[r + 1];
  for (int64_t q = inv.ptr[r] + lane; q < end; q += 32) {
    const int64_t e = inv.order[q];
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] += g[3 * e + a];
  }
  warp_sum(s);
  if (lane < 3) {
    T v = pick(s, lane);
    if (merge) v += drow[3 * r + lane];
    dsrc[r * rs + lane * fs] = v;
  }
}

// Row pass of gather_forces' VJP, h_i = 0.5 V_i df_i: dfmT's rows 0-8 the
// Warp pairing's dF_i = sum_k (R_j^T h_i) (x) (V_j S_j nW_ik) (zero in the
// Taichi pairing), rows 9-17 dM_i = h_i (x) sum_v_nw_i, row 18 zero; and the
// row's [F_i | h_i] into rowrec (n, 12) for the source pass.
template <typename T, bool SEP>
__global__ void __launch_bounds__(GT)
gather_forces_bwd_rows(const int64_t* __restrict__ idx, const T* __restrict__ nw,
                       int64_t n, int K, const T* __restrict__ svnw,
                       const T* __restrict__ fmT, int64_t ld_fm, Rec<T> src, Rec<T> vsrc,
                       const T* __restrict__ df, T* __restrict__ dfmT, int64_t ld_dfm,
                       T* __restrict__ rowrec) {
  const int lane = threadIdx.x & 31;
  const int64_t i = warp_row();
  if (i >= n) return;
  const T vi = T(0.5) * fmT[18 * ld_fm + i];
  const T h[3] = {vi * df[3 * i], vi * df[3 * i + 1], vi * df[3 * i + 2]};
  T dF[9];
#pragma unroll
  for (int f = 0; f < 9; ++f) dF[f] = T(0);
  if (!SEP) {
    const int64_t row = i * K;
    for (int k = lane; k < K; k += 32) {
      const int64_t e = row + k;
      const int64_t j = idx[e];
      const T w[3] = {nw[3 * e], nw[3 * e + 1], nw[3 * e + 2]};
      const T vj = vsrc(j, 0);
      T vs[3], dy[3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        vs[b] = vj * (src(j, sym6(b, 0)) * w[0] + src(j, sym6(b, 1)) * w[1]
                      + src(j, sym6(b, 2)) * w[2]);
      // dy = R_j^T h: R^T_9 field 6 + 3c + a = R[a][c]
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dy[c] = src(j, 6 + 3 * c) * h[0] + src(j, 7 + 3 * c) * h[1]
                + src(j, 8 + 3 * c) * h[2];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) dF[3 * a + b] += dy[a] * vs[b];
    }
    warp_sum(dF);
  }
  if (lane < 19) {
    T v = T(0);
    if (lane < 9) {
      v = pick(dF, lane);
    } else if (lane < 18) {
      const int a = (lane - 9) / 3, b = (lane - 9) % 3;
      v = (a == 0 ? h[0] : (a == 1 ? h[1] : h[2])) * svnw[3 * i + b];
    }
    dfmT[lane * ld_dfm + i] = v;
  }
  if (lane < 12)
    rowrec[12 * i + lane] =
        lane < 9 ? (SEP ? T(0) : fmT[lane * ld_fm + i])
                 : (lane == 9 ? h[0] : (lane == 10 ? h[1] : h[2]));
}

// Source pass of gather_forces' VJP: source row r's cotangent from its
// readers e = (i, k) in CSR order, each recomputed from rowrec[i], nW_e
// and r's own record.  Warp: dR_r += h_i (x) y, y = F_i (V_r S_r nW),
// dVS_r += (F_i^T R_r^T h_i) (x) nW, then dS_6 = V_r (dVS + dVS^T) folded
// onto the six fields and dR^T_9; Taichi: dM_r = V_r sum h_i (x) nW, with
// ``merge`` added into dfmT's rows 9-17 (the source is the rows' own fmT).
template <typename T, bool SEP>
__global__ void __launch_bounds__(GT)
gather_forces_bwd_src(Inverse inv, int K, const T* __restrict__ nw, Rec<T> src,
                      Rec<T> vsrc, const T* __restrict__ rowrec, int merge,
                      T* __restrict__ dsrc, int64_t rs, int64_t fs,
                      T* __restrict__ dfmT, int64_t ld_dfm) {
  constexpr int NV = SEP ? 9 : 18;
  const int lane = threadIdx.x & 31;
  const int64_t r = warp_row();
  if (r >= inv.n_src) return;
  const T vr = vsrc(r, 0);
  T S[3][3], R[3][3];
  if (!SEP) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        S[a][b] = src(r, sym6(a, b));
        R[a][b] = src(r, 6 + 3 * b + a);
      }
  }
  T acc[NV];                   // Warp: dR [a][b] at 3a+b, then dVS [b][c]
#pragma unroll
  for (int f = 0; f < NV; ++f) acc[f] = T(0);
  const int64_t end = inv.ptr[r + 1];
  for (int64_t q = inv.ptr[r] + lane; q < end; q += 32) {
    const int64_t e = inv.order[q];
    const T* rec = rowrec + 12 * (e / K);
    const T w[3] = {nw[3 * e], nw[3 * e + 1], nw[3 * e + 2]};
    const T h[3] = {rec[9], rec[10], rec[11]};
    if (SEP) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) acc[3 * a + b] += h[a] * w[b];
    } else {
      T F[3][3], vs[3], y[3], dy[3], u[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) F[a][b] = rec[3 * a + b];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        vs[b] = vr * (S[b][0] * w[0] + S[b][1] * w[1] + S[b][2] * w[2]);
#pragma unroll
      for (int a = 0; a < 3; ++a) y[a] = F[a][0] * vs[0] + F[a][1] * vs[1] + F[a][2] * vs[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) dy[c] = R[0][c] * h[0] + R[1][c] * h[1] + R[2][c] * h[2];
#pragma unroll
      for (int b = 0; b < 3; ++b) u[b] = F[0][b] * dy[0] + F[1][b] * dy[1] + F[2][b] * dy[2];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          acc[3 * a + b] += h[a] * y[b];
          acc[9 + 3 * a + b] += u[a] * w[b];
        }
    }
  }
  warp_sum(acc);
  if (SEP) {
    if (lane < 9) {
      const T v = vr * pick(acc, lane);
      if (merge)
        dfmT[(9 + lane) * ld_dfm + r] += v;
      else
        dsrc[r * rs + lane * fs] = v;
    }
  } else if (lane < 15) {
    T v;
    if (lane < 6) {
      const int a = lane < 3 ? 0 : (lane < 5 ? 1 : 2);
      const int b = lane < 3 ? lane : (lane < 5 ? lane - 2 : 2);
      v = a == b ? vr * pick(acc, 9 + 4 * a)
                 : vr * (pick(acc, 9 + 3 * a + b) + pick(acc, 9 + 3 * b + a));
    } else {
      const int c = (lane - 6) / 3, a = (lane - 6) % 3;   // R^T_9: R[a][c]
      v = pick(acc, 3 * a + c);
    }
    dsrc[r * rs + lane * fs] = v;
  }
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
int launch_moments_bwd(const void* idx, const void* c, const void* vj, const void* xji,
                       const void* nw, int64_t n, int K, const void* order,
                       const void* ptr, int64_t n_src, const void* dayT, int64_t ld_ay,
                       void* g, void* drow, int merge, void* dsrc, int64_t rs,
                       int64_t fs, void* stream) {
  const Table<T> tb{(const int64_t*)idx, (const T*)c, (const T*)vj, (const T*)xji,
                    (const T*)nw, n, K};
  if (n > 0) {
    gather_moments_bwd_rows<T><<<blocks_for(n), GT, 0, (cudaStream_t)stream>>>(
        tb, (const T*)dayT, ld_ay, (T*)g, (T*)drow);
    if (int e = (int)cudaGetLastError()) return e;
  }
  if (n_src > 0) {
    gather_moments_bwd_src<T><<<blocks_for(n_src), GT, 0, (cudaStream_t)stream>>>(
        Inverse{(const int64_t*)order, (const int64_t*)ptr, n_src}, (const T*)g,
        (const T*)drow, merge, (T*)dsrc, rs, fs);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces(const void* idx, const void* nw, int64_t n, int K, const void* svnw,
                  const void* fmT, int64_t ld_fm, const void* src, int64_t src_rs,
                  int64_t src_fs, const void* vsrc, int64_t v_rs, void* out, int sep,
                  void* stream) {
  if (n == 0) return 0;
  const Rec<T> s{(const T*)src, src_rs, src_fs}, v{(const T*)vsrc, v_rs, 0};
  auto* kernel = sep ? gather_forces_kernel<T, true> : gather_forces_kernel<T, false>;
  kernel<<<blocks_for(n), GT, 0, (cudaStream_t)stream>>>(
      (const int64_t*)idx, (const T*)nw, n, K, (const T*)svnw, (const T*)fmT, ld_fm, s,
      v, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd(const void* idx, const void* nw, int64_t n, int K,
                      const void* svnw, const void* fmT, int64_t ld_fm, const void* src,
                      int64_t src_rs, int64_t src_fs, const void* vsrc, int64_t v_rs,
                      const void* df, const void* order, const void* ptr, int64_t n_src,
                      void* dfmT, int64_t ld_dfm, void* rowrec, void* dsrc, int64_t rs,
                      int64_t fs, int sep, int merge, void* stream) {
  const Rec<T> s{(const T*)src, src_rs, src_fs}, v{(const T*)vsrc, v_rs, 0};
  if (n > 0) {
    auto* rows = sep ? gather_forces_bwd_rows<T, true> : gather_forces_bwd_rows<T, false>;
    rows<<<blocks_for(n), GT, 0, (cudaStream_t)stream>>>(
        (const int64_t*)idx, (const T*)nw, n, K, (const T*)svnw, (const T*)fmT, ld_fm,
        s, v, (const T*)df, (T*)dfmT, ld_dfm, (T*)rowrec);
    if (int e = (int)cudaGetLastError()) return e;
  }
  if (n_src > 0) {
    auto* pass = sep ? gather_forces_bwd_src<T, true> : gather_forces_bwd_src<T, false>;
    pass<<<blocks_for(n_src), GT, 0, (cudaStream_t)stream>>>(
        Inverse{(const int64_t*)order, (const int64_t*)ptr, n_src}, K, (const T*)nw, s,
        v, (const T*)rowrec, merge, (T*)dsrc, rs, fs, (T*)dfmT, ld_dfm);
  }
  return (int)cudaGetLastError();
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
      const void* idx, const void* c, const void* vj, const void* xji,           \
      const void* nw, int64_t n, int K, const void* order, const void* ptr,      \
      int64_t n_src, const void* dayT, int64_t ld_ay, void* g, void* drow,       \
      int merge, void* dsrc, int64_t rs, int64_t fs, void* stream) {             \
    return launch_moments_bwd<T>(idx, c, vj, xji, nw, n, K, order, ptr, n_src,   \
                                 dayT, ld_ay, g, drow, merge, dsrc, rs, fs,      \
                                 stream);                                        \
  }                                                                              \
  int sb_gather_forces_##SUF(const void* idx, const void* nw, int64_t n, int K,  \
                             const void* svnw, const void* fmT, int64_t ld_fm,   \
                             const void* src, int64_t src_rs, int64_t src_fs,    \
                             const void* vsrc, int64_t v_rs, void* out, int sep, \
                             void* stream) {                                     \
    return launch_forces<T>(idx, nw, n, K, svnw, fmT, ld_fm, src, src_rs, src_fs, \
                            vsrc, v_rs, out, sep, stream);                       \
  }                                                                              \
  int sb_gather_forces_bwd_##SUF(                                                \
      const void* idx, const void* nw, int64_t n, int K, const void* svnw,       \
      const void* fmT, int64_t ld_fm, const void* src, int64_t src_rs,           \
      int64_t src_fs, const void* vsrc, int64_t v_rs, const void* df,            \
      const void* order, const void* ptr, int64_t n_src, void* dfmT,             \
      int64_t ld_dfm, void* rowrec, void* dsrc, int64_t rs, int64_t fs, int sep, \
      int merge, void* stream) {                                                 \
    return launch_forces_bwd<T>(idx, nw, n, K, svnw, fmT, ld_fm, src, src_rs,    \
                                src_fs, vsrc, v_rs, df, order, ptr, n_src, dfmT, \
                                ld_dfm, rowrec, dsrc, rs, fs, sep, merge,        \
                                stream);                                         \
  }

SB_GATHER_ENTRIES(f32, float)
SB_GATHER_ENTRIES(f64, double)

}  // extern "C"
