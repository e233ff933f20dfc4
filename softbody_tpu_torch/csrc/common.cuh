// What the pair-kernel sources share (pair_kernels.cu, the v4 path;
// fused_kernels.cu, the fused K1 + mid-section path): the tile geometry,
// the cubic-spline pair coefficients, and the tile loops both paths' K1, K2
// and backward kernels run.  Each kernel keeps only what it does beyond
// them (its epilogue).
//
// One block per tile of ROWS slot rows, one lane per row, NWARPS warps
// splitting the tile's candidate slab (slot = gidx[e / group] * group +
// e % group); each pass stages CHUNK slab entries in shared memory, one
// entry per thread, and warp w reads back entries [32w, 32w + 32), exactly
// the ones its own lanes staged, so a warp barrier suffices.  Cross-warp
// sums run in a fixed order (warp 0 first): no atomics, deterministic.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ROWS = 32;               // one lane per tile row
constexpr int NWARPS = 4;              // warps per tile, splitting the slab
constexpr int THREADS = 32 * NWARPS;
constexpr int CHUNK = THREADS;         // slab entries staged per pass

template <typename T> __device__ __forceinline__ T rsqrt_t(T x);
template <> __device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

template <typename T> __device__ __forceinline__ T relu(T x) { return x > T(0) ? x : T(0); }

// K1 slab entry: rest_3, mass, volume, pos - c (8 values).
template <typename T> struct alignas(16) K1Entry { T v[8]; };
// K2 slab entry: rest_3, volume, S_6, R^T_9, pad (20 values).
template <typename T> struct alignas(16) K2Entry { T v[20]; };

// Cubic-spline coefficients of one pair from r2 = |X_i - X_j|^2, rsqrt
// form: q = r2 rsqrt(r2 + tiny) / h, and the gradient polynomial is exactly
// zero at q = 0, so the self pair needs no mask; padding slots sit on a far
// grid, so their coefficients vanish.  grad W = gfac dx.
template <typename T>
__device__ __forceinline__ void spline_w_gfac(T r2, T inv_h, T c4, T c4h,
                                              T& w, T& gfac) {
  const T rs = rsqrt_t(r2 + T(1e-30));
  const T q = r2 * rs * inv_h;
  const T tq = relu(T(2) - q), oq = relu(T(1) - q);
  const T tq2 = tq * tq, oq2 = oq * oq;
  w = c4 * (tq2 * tq - T(4) * oq2 * oq);
  gfac = c4h * (T(12) * oq2 - T(3) * tq2) * rs;
}

template <typename T>
__device__ __forceinline__ T spline_gfac(T r2, T inv_h, T c4h) {
  const T rs = rsqrt_t(r2 + T(1e-30));
  const T q = r2 * rs * inv_h;
  const T tq = relu(T(2) - q), oq = relu(T(1) - q);
  return c4h * (T(12) * oq * oq - T(3) * tq * tq) * rs;
}

// ------------------------------------------------------------ forward sums
// K1's tile sums: red[w][NA k + a][lane] holds warp w's share of
// sum_j p_a L_k (a < 3) and, with ROWSUM (NA = 4), sum_j L_k (a = 3) for
// row `lane`, with L = [-w m_j dx ; gfac V_j dx] and p = pos_j - c, c the
// tile's first rest row, which the caller keeps in registers for its
// epilogue (re-reading it there cost K1 v4 8%).  Without ROWSUM (NA = 3)
// the row sums are neither formed nor stored.  rr (3, ROWS), st (5, slab)
// and gi are the tile's own.  Ends with a block barrier.
template <bool ROWSUM, typename T>
__device__ __forceinline__ void k1_tile_sums(
    const T* __restrict__ rr, const T* __restrict__ st,
    const T* __restrict__ posT, int64_t ld_pos, const int32_t* __restrict__ gi,
    int slab, int group, T inv_h, T c4, T c4h, const T (&c)[3], K1Entry<T>* ent,
    T (*red)[ROWSUM ? 24 : 18][ROWS]) {
  constexpr int NA = ROWSUM ? 4 : 3;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T c0 = c[0], c1 = c[1], c2 = c[2];
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T acc[6][NA];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[k][a] = T(0);

  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    const int e = threadIdx.x;
    if (e < n) {
      const int s = base + e;
      const int64_t slot = (int64_t)gi[s / group] * group + (s % group);
      K1Entry<T> x;
      x.v[0] = st[s];
      x.v[1] = st[slab + s];
      x.v[2] = st[2 * slab + s];
      x.v[3] = st[3 * slab + s];
      x.v[4] = st[4 * slab + s];
      x.v[5] = posT[slot] - c0;
      x.v[6] = posT[ld_pos + slot] - c1;
      x.v[7] = posT[2 * ld_pos + slot] - c2;
      ent[e] = x;
    }
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const K1Entry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      T w, gfac;
      spline_w_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4, c4h, w, gfac);
      const T cA = w * x.v[3], gv = gfac * x.v[4];
      const T L[6] = {-cA * dx0, -cA * dx1, -cA * dx2, gv * dx0, gv * dx1, gv * dx2};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        acc[k][0] += x.v[5] * L[k];
        acc[k][1] += x.v[6] * L[k];
        acc[k][2] += x.v[7] * L[k];
        if constexpr (ROWSUM) acc[k][3] += L[k];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < NA; ++a) red[warp][NA * k + a][lane] = acc[k][a];
  __syncthreads();
}

// Row r's centered K1 moment 3k + a (A[a][k] for k < 3, Y[a][k - 3] after)
// from k1_tile_sums: dot - (pos_i[a] - c_a) rowsum, pi = pos_i[a] - c_a.
template <typename T>
__device__ __forceinline__ T k1_moment(T (*red)[24][ROWS], int k, int a,
                                       int r, T pi) {
  T dot = T(0), rowsum = T(0);
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    dot += red[w][4 * k + a][r];
    rowsum += red[w][4 * k + 3][r];
  }
  return dot - pi * rowsum;
}

// Stage one pass of K2's slab entries (rest_3, V_j, the slot's S_6 | R^T_9).
template <typename T>
__device__ __forceinline__ void stage_k2(K2Entry<T>* ent, const T* __restrict__ st,
                                         const T* __restrict__ srT, int64_t ld_sr,
                                         const int32_t* __restrict__ gi, int slab,
                                         int group, int base, int n) {
  const int e = threadIdx.x;
  if (e < n) {
    const int s = base + e;
    const int64_t slot = (int64_t)gi[s / group] * group + (s % group);
    K2Entry<T> x;
    x.v[0] = st[s];
    x.v[1] = st[slab + s];
    x.v[2] = st[2 * slab + s];
    x.v[3] = st[4 * slab + s];
#pragma unroll
    for (int f = 0; f < 15; ++f) x.v[4 + f] = srT[f * ld_sr + slot];
    x.v[19] = T(0);
    ent[e] = x;
  }
}

// K2's tile sums for row `lane`, its F_i given: with nw = gfac V_j dx,
// z_d = sum_b nw_b S_j[d][b] and u = F_i z, red[w][a][lane] holds warp w's
// share of sum_j (R_j u)_a, and with SVNW red[w][3 + b][lane] its share of
// sum_j nw_b.  Ends with a block barrier.
template <bool SVNW, typename T>
__device__ __forceinline__ void k2_tile_sums(
    const T* __restrict__ rr, const T* __restrict__ st, const T (&F)[9],
    const T* __restrict__ srT, int64_t ld_sr, const int32_t* __restrict__ gi,
    int slab, int group, T inv_h, T c4h, K2Entry<T>* ent,
    T (*red)[SVNW ? 6 : 3][ROWS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  T sv0 = T(0), sv1 = T(0), sv2 = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    stage_k2(ent, st, srT, ld_sr, gi, slab, group, base, n);
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const K2Entry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T gv = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h) * x.v[3];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
      if (SVNW) {
        sv0 += nw0;
        sv1 += nw1;
        sv2 += nw2;
      }
      const T* S = x.v + 4;     // [s00 s01 s02 s11 s12 s22]
      const T z0 = nw0 * S[0] + nw1 * S[1] + nw2 * S[2];
      const T z1 = nw0 * S[1] + nw1 * S[3] + nw2 * S[4];
      const T z2 = nw0 * S[2] + nw1 * S[4] + nw2 * S[5];
      const T u0 = F[0] * z0 + F[1] * z1 + F[2] * z2;
      const T u1 = F[3] * z0 + F[4] * z1 + F[5] * z2;
      const T u2 = F[6] * z0 + F[7] * z1 + F[8] * z2;
      const T* Rt = x.v + 10;   // Rt[3c + a] = R[a][c]
      acc0 += Rt[0] * u0 + Rt[3] * u1 + Rt[6] * u2;
      acc1 += Rt[1] * u0 + Rt[4] * u1 + Rt[7] * u2;
      acc2 += Rt[2] * u0 + Rt[5] * u1 + Rt[8] * u2;
    }
    __syncwarp();
  }
  red[warp][0][lane] = acc0;
  red[warp][1][lane] = acc1;
  red[warp][2][lane] = acc2;
  if (SVNW) {
    red[warp][3][lane] = sv0;
    red[warp][4][lane] = sv1;
    red[warp][5][lane] = sv2;
  }
  __syncthreads();
}

// ----------------------------------------------------------- backward sums
// The slab side of K1's VJP, a whole kernel body: per slab entry
// dps[a](j) = sum_r sum_blk day[3 blk + a](r) L_blk(r, j), one thread per
// slab entry looping over the rows in order; the rows' rest coordinates and
// their 18 cotangents are shared-memory broadcasts.  dps (3, ld_ps), column
// tile * slab + s.
template <typename T>
__device__ __forceinline__ void k1_bwd_slab(
    const T* __restrict__ restT_rows, const T* __restrict__ static_slab,
    const T* __restrict__ dayT, int64_t ld_day, T* __restrict__ dps,
    int64_t ld_ps, int slab, T inv_h, T c4, T c4h) {
  __shared__ T xr[3][ROWS];
  __shared__ T ct[18][ROWS];

  const int tile = blockIdx.x;
  const int64_t col0 = (int64_t)tile * ROWS;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) xr[o / ROWS][o % ROWS] = rr[o];
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS)
    ct[o / ROWS][o % ROWS] = dayT[(o / ROWS) * ld_day + col0 + o % ROWS];
  __syncthreads();

  const T* st = static_slab + (int64_t)tile * 5 * slab;
  for (int s = threadIdx.x; s < slab; s += THREADS) {
    const T xj0 = st[s], xj1 = st[slab + s], xj2 = st[2 * slab + s];
    const T mj = st[3 * slab + s], vj = st[4 * slab + s];
    T g0 = T(0), g1 = T(0), g2 = T(0);
    for (int r = 0; r < ROWS; ++r) {
      const T dx0 = xr[0][r] - xj0, dx1 = xr[1][r] - xj1, dx2 = xr[2][r] - xj2;
      T w, gfac;
      spline_w_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4, c4h, w, gfac);
      const T cA = w * mj, gv = gfac * vj;
      const T L[6] = {-cA * dx0, -cA * dx1, -cA * dx2, gv * dx0, gv * dx1, gv * dx2};
#pragma unroll
      for (int blk = 0; blk < 6; ++blk) {
        g0 += ct[3 * blk][r] * L[blk];
        g1 += ct[3 * blk + 1][r] * L[blk];
        g2 += ct[3 * blk + 2][r] * L[blk];
      }
    }
    const int64_t e = (int64_t)tile * slab + s;
    dps[e] = g0;
    dps[ld_ps + e] = g1;
    dps[2 * ld_ps + e] = g2;
  }
}

// The row pass of K2's VJP for row `lane`, its df (the cotangent of the
// pair sum) given: with w'_c = sum_a df_a R_j[a][c], red[w][3c + d][lane]
// holds warp w's share of sum_j z_d w'_c, and with SVNW red[w][9 + b][lane]
// its share of sum_j nw_b.  Ends with a block barrier.
template <bool SVNW, typename T>
__device__ __forceinline__ void k2_bwd_row_sums(
    const T* __restrict__ rr, const T* __restrict__ st, const T* __restrict__ srT,
    int64_t ld_sr, const int32_t* __restrict__ gi, int slab, int group, T inv_h,
    T c4h, T df0, T df1, T df2, K2Entry<T>* ent, T (*red)[SVNW ? 12 : 9][ROWS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  constexpr int K = SVNW ? 12 : 9;
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    stage_k2(ent, st, srT, ld_sr, gi, slab, group, base, n);
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const K2Entry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T gv = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h) * x.v[3];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
      if (SVNW) {
        acc[K - 3] += nw0;
        acc[K - 2] += nw1;
        acc[K - 1] += nw2;
      }
      const T* S = x.v + 4;
      const T z[3] = {nw0 * S[0] + nw1 * S[1] + nw2 * S[2],
                      nw0 * S[1] + nw1 * S[3] + nw2 * S[4],
                      nw0 * S[2] + nw1 * S[4] + nw2 * S[5]};
      const T* Rt = x.v + 10;   // Rt[3c + a] = R[a][c]
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T wp = df0 * Rt[3 * c] + df1 * Rt[3 * c + 1] + df2 * Rt[3 * c + 2];
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[3 * c + d] += z[d] * wp;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[warp][k][lane] = acc[k];
  __syncthreads();
}

// The slab pass of K2's VJP, a whole kernel body: with z, u = F_i z and
// w'_c as above, per slab entry dR^T[3c + a] = sum_i df_a u_c and
// dS_6[SYM6[3d + b]] += sum_i nw_b y_d, y_d = sum_c F_i[c][d] w'_c; one
// thread per slab entry looping over the rows in order, 15 register sums.
// f9T (9, ld_f9): F_i, row 3c + d = F_i[c][d].  half_v (one row of length
// ld, or null): df is taken as df * (0.5 V_i), the fused path's scale.
template <typename T>
__device__ __forceinline__ void k2_bwd_slab(
    const T* __restrict__ restT_rows, const T* __restrict__ static_slab,
    const T* __restrict__ f9T, int64_t ld_f9, const T* __restrict__ half_v,
    const T* __restrict__ srT, int64_t ld_sr, const int32_t* __restrict__ gidx,
    const T* __restrict__ dfT, int64_t ld_df, T* __restrict__ dsr, int64_t ld_out,
    int slab, int group, T inv_h, T c4h) {
  __shared__ T xr[3][ROWS];
  __shared__ T F[9][ROWS];
  __shared__ T df[3][ROWS];

  const int tile = blockIdx.x;
  const int64_t col0 = (int64_t)tile * ROWS;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int a = o / ROWS, r = o % ROWS;
    xr[a][r] = rr[o];
    const T d = dfT[a * ld_df + col0 + r];
    df[a][r] = half_v == nullptr ? d : d * (T(0.5) * half_v[col0 + r]);
  }
  for (int o = threadIdx.x; o < 9 * ROWS; o += THREADS)
    F[o / ROWS][o % ROWS] = f9T[(o / ROWS) * ld_f9 + col0 + o % ROWS];
  __syncthreads();

  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const int32_t* gi = gidx + (int64_t)tile * (slab / group);
  for (int s = threadIdx.x; s < slab; s += THREADS) {
    const int64_t slot = (int64_t)gi[s / group] * group + (s % group);
    const T xj0 = st[s], xj1 = st[slab + s], xj2 = st[2 * slab + s];
    const T vj = st[4 * slab + s];
    T S[6], Rt[9];
#pragma unroll
    for (int f = 0; f < 6; ++f) S[f] = srT[f * ld_sr + slot];
#pragma unroll
    for (int f = 0; f < 9; ++f) Rt[f] = srT[(6 + f) * ld_sr + slot];
    T dS[6], dRt[9];
#pragma unroll
    for (int f = 0; f < 6; ++f) dS[f] = T(0);
#pragma unroll
    for (int f = 0; f < 9; ++f) dRt[f] = T(0);
    for (int r = 0; r < ROWS; ++r) {
      const T dx0 = xr[0][r] - xj0, dx1 = xr[1][r] - xj1, dx2 = xr[2][r] - xj2;
      const T gv = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h) * vj;
      const T nw[3] = {gv * dx0, gv * dx1, gv * dx2};
      const T z[3] = {nw[0] * S[0] + nw[1] * S[1] + nw[2] * S[2],
                      nw[0] * S[1] + nw[1] * S[3] + nw[2] * S[4],
                      nw[0] * S[2] + nw[1] * S[4] + nw[2] * S[5]};
      const T d[3] = {df[0][r], df[1][r], df[2][r]};
      T wp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T u = F[3 * c][r] * z[0] + F[3 * c + 1][r] * z[1] + F[3 * c + 2][r] * z[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) dRt[3 * c + a] += d[a] * u;
        wp[c] = d[0] * Rt[3 * c] + d[1] * Rt[3 * c + 1] + d[2] * Rt[3 * c + 2];
      }
      T y[3];
#pragma unroll
      for (int dd = 0; dd < 3; ++dd)
        y[dd] = F[dd][r] * wp[0] + F[3 + dd][r] * wp[1] + F[6 + dd][r] * wp[2];
      // dS_6[SYM6[3d + b]] += nw_b y_d
      dS[0] += nw[0] * y[0];
      dS[1] += nw[1] * y[0] + nw[0] * y[1];
      dS[2] += nw[2] * y[0] + nw[0] * y[2];
      dS[3] += nw[1] * y[1];
      dS[4] += nw[2] * y[1] + nw[1] * y[2];
      dS[5] += nw[2] * y[2];
    }
    const int64_t e = (int64_t)tile * slab + s;
#pragma unroll
    for (int f = 0; f < 6; ++f) dsr[f * ld_out + e] = dS[f];
#pragma unroll
    for (int f = 0; f < 9; ++f) dsr[(6 + f) * ld_out + e] = dRt[f];
  }
}

}  // namespace
