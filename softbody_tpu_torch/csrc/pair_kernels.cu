// Pair kernels of the sparse path, hand-written for Hopper (sm_90a).
//
// K1  moments_v4_kernel      replaces softbody_tpu/ops/pallas/pair_kernels.py
//                            :: _moments_kernel_v4 (launched by
//                            ops/pallas/packed.py :: _moments_v4_fwd)
// K2  forces_warp_v4_kernel  replaces softbody_tpu/ops/pallas/pair_kernels.py
//                            :: _forces_warp_kernel_v4 (launched by
//                            ops/pallas/packed.py :: _forces_warp_v4_fwd_srT)
// The backward kernels and the fixed-order scatter follow the forward ones,
// each with its own note (further down).
//
// What they compute (per tile of ROWS = 32 slot rows against its candidate
// slab of `slab` slots, slot = gidx[tile, e / group] * group + e % group):
//   K1: lhs = [-w m_j dx ; gfac V_j dx] (6 blocks), p = pos_j - c with c the
//       tile's first rest row; out row 3*blk + a =
//       sum_j p_a lhs_blk - (pos_i[a] - c_a) * sum_j lhs_blk.
//       The rowsum comes from the SAME in-kernel coefficients as the dots
//       (a host-f64 rowsum here was measured to destabilise a quiet body).
//   K2: nw = gfac V_j dx, Z_d = sum_b nw_b S_j[d, b], u = F_i Z,
//       out row a = sum_j (R_j u)_a.  (The TPU kernel summed D = R^T Z over
//       the slab and applied F_i after; applying F_i per pair needs 3
//       accumulators instead of 27 and 18 instead of 27 multiply-adds.)
//   Pair coefficients use the rsqrt form: rs = rsqrt(r2 + 1e-30) and the
//   gradient polynomial is exactly zero at q = 0, so the self pair needs no
//   mask; padding slots sit on a far grid, so their coefficients vanish.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 without tensor cores, 3.35 TB/s):
//   both kernels are OPERATION-bound.  Per pair K1 does 78 flops and K2 75;
//   per slab entry K1 stages 8 values and K2 19, each serving all 32 rows
//   of the tile: 78 (K1) and 32 (K2) flops per byte staged, above the
//   card's 20 FP32 flops per byte of device memory.  At the ~112k stretch
//   scene (72.4 M candidate pairs per force evaluation) that is ~0.08 ms
//   per evaluation for each kernel (chip_smoke.py computes the exact bound
//   from the run's shapes).
// What the design does about it: plain FP32 FMAs (never TF32 — a reduced-
//   precision dot destabilised the episode on the TPU), one lane per tile
//   row so every per-pair value stays in registers, the slab staged through
//   shared memory and read back as broadcasts (every lane of a warp reads
//   the same entry), four warps per tile splitting the slab, then a
//   fixed-order cross-warp reduction: no atomics, deterministic.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launch.  Kernels launch on the caller's stream
// and allocate nothing.

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_v4_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                  const T* __restrict__ static_slab,  // (t, 5, slab)
                  const T* __restrict__ posT,         // (3, ld_pos)
                  int64_t ld_pos,
                  const T* __restrict__ posT_rows,    // (3, ld_rows), column tile*ROWS + r
                  int64_t ld_rows,
                  const int32_t* __restrict__ gidx,   // (t, slab / group)
                  T* __restrict__ ayT,                // (18, ld_out)
                  int64_t ld_out,
                  int slab, int group, T inv_h, T c4, T c4h) {
  __shared__ K1Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][24][ROWS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T c0 = rr[0], c1 = rr[ROWS], c2 = rr[2 * ROWS];
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const int32_t* gi = gidx + (int64_t)tile * (slab / group);

  T acc[6][4];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[k][a] = T(0);

  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    // Each thread stages one entry; warp w consumes entries [32w, 32w+32),
    // exactly the ones its own lanes staged, so a warp barrier suffices.
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
      const T r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      const T rs = rsqrt_t(r2 + T(1e-30));
      const T q = r2 * rs * inv_h;
      const T tq = relu(T(2) - q), oq = relu(T(1) - q);
      const T tq2 = tq * tq, oq2 = oq * oq;
      const T w = c4 * (tq2 * tq - T(4) * oq2 * oq);
      const T gfac = c4h * (T(12) * oq2 - T(3) * tq2) * rs;
      const T cA = w * x.v[3], gv = gfac * x.v[4];
      const T L[6] = {-cA * dx0, -cA * dx1, -cA * dx2, gv * dx0, gv * dx1, gv * dx2};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        acc[k][0] += x.v[5] * L[k];
        acc[k][1] += x.v[6] * L[k];
        acc[k][2] += x.v[7] * L[k];
        acc[k][3] += L[k];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < 4; ++a) red[warp][4 * k + a][lane] = acc[k][a];
  __syncthreads();

  // 18 output rows x 32 lanes, warps summed in a fixed order.
  const T cc[3] = {c0, c1, c2};
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS) {
    const int r = o % ROWS, row = o / ROWS;
    const int k = row / 3, a = row % 3;
    T dot = T(0), rowsum = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      dot += red[w][4 * k + a][r];
      rowsum += red[w][4 * k + 3][r];
    }
    const int64_t col = (int64_t)tile * ROWS + r;
    const T pi = posT_rows[a * ld_rows + col] - cc[a];
    ayT[row * ld_out + col] = dot - pi * rowsum;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v4_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                      const T* __restrict__ static_slab,  // (t, 5, slab)
                      const T* __restrict__ f9T,          // (9, ld_f9), column tile*ROWS + r
                      int64_t ld_f9,
                      const T* __restrict__ srT,          // (15, ld_sr): S_6 | R^T_9
                      int64_t ld_sr,
                      const int32_t* __restrict__ gidx,   // (t, slab / group)
                      T* __restrict__ fT,                 // (3, ld_out)
                      int64_t ld_out,
                      int slab, int group, T inv_h, T c4h) {
  __shared__ K2Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][3][ROWS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const int32_t* gi = gidx + (int64_t)tile * (slab / group);
  const int64_t col = (int64_t)tile * ROWS + lane;
  T F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = f9T[k * ld_f9 + col];

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
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
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const K2Entry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      const T rs = rsqrt_t(r2 + T(1e-30));
      const T q = r2 * rs * inv_h;
      const T tq = relu(T(2) - q), oq = relu(T(1) - q);
      const T gv = c4h * (T(12) * oq * oq - T(3) * tq * tq) * rs * x.v[3];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
      // S_6 = [s00 s01 s02 s11 s12 s22] at v[4..9]
      const T* S = x.v + 4;
      const T z0 = nw0 * S[0] + nw1 * S[1] + nw2 * S[2];
      const T z1 = nw0 * S[1] + nw1 * S[3] + nw2 * S[4];
      const T z2 = nw0 * S[2] + nw1 * S[4] + nw2 * S[5];
      const T u0 = F[0] * z0 + F[1] * z1 + F[2] * z2;
      const T u1 = F[3] * z0 + F[4] * z1 + F[5] * z2;
      const T u2 = F[6] * z0 + F[7] * z1 + F[8] * z2;
      // R^T_9 at v[10..18]: v[10 + 3c + a] = R[a][c]
      const T* Rt = x.v + 10;
      acc0 += Rt[0] * u0 + Rt[3] * u1 + Rt[6] * u2;
      acc1 += Rt[1] * u0 + Rt[4] * u1 + Rt[7] * u2;
      acc2 += Rt[2] * u0 + Rt[5] * u1 + Rt[8] * u2;
    }
    __syncwarp();
  }

  red[warp][0][lane] = acc0;
  red[warp][1][lane] = acc1;
  red[warp][2][lane] = acc2;
  __syncthreads();
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int r = o % ROWS, a = o / ROWS;
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][a][r];
    fT[a * ld_out + (int64_t)tile * ROWS + r] = sum;
  }
}

// ---------------------------------------------------------------- backward
//
// K1 bwd  moments_v4_bwd_kernel replaces softbody_tpu/ops/pallas/
//         pair_kernels.py :: _moments_bwd_kernel_v4 (launched by
//         ops/pallas/packed.py :: _moments_v4_bwd_impl).
//   dps[a](j)   = sum_i sum_blk ct[3 blk + a](i) L_blk(i, j)   per slab entry
//   dprow[a](i) = -sum_blk ct[3 blk + a](i) rs6[blk](i)        per tile row
//   (rs6 = the host's static row sums: the gradient is exact for a function
//   ~1e-7 relative away from the f32 forward, packed.py:376-383).
//   One block per tile, one thread per slab entry looping over the 32 rows:
//   the row's rest coordinates and its 18 cotangents are shared-memory
//   broadcasts, the sum over rows runs in 3 registers in row order.
//   72 flops per pair.
//
// K2 bwd  replaces softbody_tpu/ops/pallas/pair_kernels.py ::
//         _forces_warp_bwd_kernel_v4 (launched by _forces_warp_bwd_v4_impl).
//   With z_d = sum_b nw_b S_j[d][b], u_c = sum_d F_i[c][d] z_d and
//   w'_c = sum_a df_a(i) R_j[a][c]:
//     df9[3c+d](i)     = sum_j z_d w'_c                   (over the slab)
//     dR^T[3c+a](j)    = sum_i df_a(i) u_c                (over the rows)
//     dS_6[SYM6](j)   += sum_i nw_b y_d,  y_d = sum_c F_i[c][d] w'_c
//   The two sums run in opposite directions, so two launches, each with one
//   owner and no cross-thread reduction but the fixed-order one of the
//   forward: forces_warp_v4_bwd_rows_kernel (the forward's structure: a lane
//   per row, four warps splitting the slab, 9 accumulators, 75 flops per
//   pair) and forces_warp_v4_bwd_slab_kernel (a thread per slab entry
//   looping over the rows, 15 accumulators, 123 flops per pair).  One
//   kernel would need the 15 slab sums reduced across the 32 row lanes per
//   pair; two launches recompute the pair coefficients instead (24 flops).
//
// slab_to_slots_kernel: the per-slab-entry buffers of all buckets, (k,
//   n_entries) field-major, added into (k, n_slots): one thread per (field,
//   slot) walks its slot group's CSR list of readers in ascending order.
//   Byte-bound (each entry read once).  No atomics anywhere: every sum runs
//   in a fixed order, so the episode gradient is bitwise repeatable.
//
// Bound on an H100 SXM: K1 bwd and both K2 bwd passes are operation-bound
// (as the forward kernels, each slab entry staged once serves 32 rows);
// chip_smoke.py computes each bound from the run's shapes.

template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_v4_bwd_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                      const T* __restrict__ static_slab,  // (t, 5, slab)
                      const T* __restrict__ dayT,         // (18, ld_day)
                      int64_t ld_day,
                      const T* __restrict__ rs6T,         // (6, ld_rs6)
                      int64_t ld_rs6,
                      T* __restrict__ dps,                // (3, ld_ps), column tile*slab + s
                      int64_t ld_ps,
                      T* __restrict__ dprow,              // (3, ld_row)
                      int64_t ld_row,
                      int slab, T inv_h, T c4, T c4h) {
  __shared__ T xr[3][ROWS];
  __shared__ T ct[18][ROWS];

  const int tile = blockIdx.x;
  const int64_t col0 = (int64_t)tile * ROWS;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) xr[o / ROWS][o % ROWS] = rr[o];
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS)
    ct[o / ROWS][o % ROWS] = dayT[(o / ROWS) * ld_day + col0 + o % ROWS];
  __syncthreads();

  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int a = o / ROWS, r = o % ROWS;
    T acc = T(0);
#pragma unroll
    for (int blk = 0; blk < 6; ++blk) acc += ct[3 * blk + a][r] * rs6T[blk * ld_rs6 + col0 + r];
    dprow[a * ld_row + col0 + r] = -acc;
  }

  const T* st = static_slab + (int64_t)tile * 5 * slab;
  for (int s = threadIdx.x; s < slab; s += THREADS) {
    const T xj0 = st[s], xj1 = st[slab + s], xj2 = st[2 * slab + s];
    const T mj = st[3 * slab + s], vj = st[4 * slab + s];
    T g0 = T(0), g1 = T(0), g2 = T(0);
    for (int r = 0; r < ROWS; ++r) {
      const T dx0 = xr[0][r] - xj0, dx1 = xr[1][r] - xj1, dx2 = xr[2][r] - xj2;
      const T r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      const T rs = rsqrt_t(r2 + T(1e-30));
      const T q = r2 * rs * inv_h;
      const T tq = relu(T(2) - q), oq = relu(T(1) - q);
      const T tq2 = tq * tq, oq2 = oq * oq;
      const T w = c4 * (tq2 * tq - T(4) * oq2 * oq);
      const T gfac = c4h * (T(12) * oq2 - T(3) * tq2) * rs;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v4_bwd_rows_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                               const T* __restrict__ static_slab,  // (t, 5, slab)
                               const T* __restrict__ srT,          // (15, ld_sr)
                               int64_t ld_sr,
                               const int32_t* __restrict__ gidx,   // (t, slab / group)
                               const T* __restrict__ dfT,          // (3, ld_df)
                               int64_t ld_df,
                               T* __restrict__ df9T,               // (9, ld_out)
                               int64_t ld_out,
                               int slab, int group, T inv_h, T c4h) {
  __shared__ K2Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][9][ROWS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const int32_t* gi = gidx + (int64_t)tile * (slab / group);
  const int64_t col = (int64_t)tile * ROWS + lane;
  const T df0 = dfT[col], df1 = dfT[ld_df + col], df2 = dfT[2 * ld_df + col];

  T acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
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
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const K2Entry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      const T rs = rsqrt_t(r2 + T(1e-30));
      const T q = r2 * rs * inv_h;
      const T tq = relu(T(2) - q), oq = relu(T(1) - q);
      const T gv = c4h * (T(12) * oq * oq - T(3) * tq * tq) * rs * x.v[3];
      const T nw0 = gv * dx0, nw1 = gv * dx1, nw2 = gv * dx2;
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
  for (int k = 0; k < 9; ++k) red[warp][k][lane] = acc[k];
  __syncthreads();
  for (int o = threadIdx.x; o < 9 * ROWS; o += THREADS) {
    const int r = o % ROWS, k = o / ROWS;
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][k][r];
    df9T[k * ld_out + (int64_t)tile * ROWS + r] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v4_bwd_slab_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                               const T* __restrict__ static_slab,  // (t, 5, slab)
                               const T* __restrict__ f9T,          // (9, ld_f9)
                               int64_t ld_f9,
                               const T* __restrict__ srT,          // (15, ld_sr)
                               int64_t ld_sr,
                               const int32_t* __restrict__ gidx,   // (t, slab / group)
                               const T* __restrict__ dfT,          // (3, ld_df)
                               int64_t ld_df,
                               T* __restrict__ dsr,                // (15, ld_out), column tile*slab + s
                               int64_t ld_out,
                               int slab, int group, T inv_h, T c4h) {
  __shared__ T xr[3][ROWS];
  __shared__ T F[9][ROWS];
  __shared__ T df[3][ROWS];

  const int tile = blockIdx.x;
  const int64_t col0 = (int64_t)tile * ROWS;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    xr[o / ROWS][o % ROWS] = rr[o];
    df[o / ROWS][o % ROWS] = dfT[(o / ROWS) * ld_df + col0 + o % ROWS];
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
      const T r2 = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      const T rs = rsqrt_t(r2 + T(1e-30));
      const T q = r2 * rs * inv_h;
      const T tq = relu(T(2) - q), oq = relu(T(1) - q);
      const T gv = c4h * (T(12) * oq * oq - T(3) * tq * tq) * rs * vj;
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
int launch_moments(const void* restT_rows, const void* static_slab,
                   const void* posT, int64_t ld_pos, const void* posT_rows,
                   int64_t ld_rows, const void* gidx, void* ayT, int64_t ld_out,
                   int t, int slab, int group, double inv_h, double c4,
                   double c4h, void* stream) {
  moments_v4_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)restT_rows, (const T*)static_slab, (const T*)posT, ld_pos,
      (const T*)posT_rows, ld_rows, (const int32_t*)gidx, (T*)ayT, ld_out,
      slab, group, (T)inv_h, (T)c4, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces(const void* restT_rows, const void* static_slab,
                  const void* f9T, int64_t ld_f9, const void* srT,
                  int64_t ld_sr, const void* gidx, void* fT, int64_t ld_out,
                  int t, int slab, int group, double inv_h, double c4h,
                  void* stream) {
  forces_warp_v4_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)restT_rows, (const T*)static_slab, (const T*)f9T, ld_f9,
      (const T*)srT, ld_sr, (const int32_t*)gidx, (T*)fT, ld_out,
      slab, group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_moments_bwd(const void* restT_rows, const void* static_slab,
                       const void* dayT, int64_t ld_day, const void* rs6T,
                       int64_t ld_rs6, void* dps, int64_t ld_ps, void* dprow,
                       int64_t ld_row, int t, int slab, double inv_h, double c4,
                       double c4h, void* stream) {
  moments_v4_bwd_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)restT_rows, (const T*)static_slab, (const T*)dayT, ld_day,
      (const T*)rs6T, ld_rs6, (T*)dps, ld_ps, (T*)dprow, ld_row, slab,
      (T)inv_h, (T)c4, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd_rows(const void* restT_rows, const void* static_slab,
                           const void* srT, int64_t ld_sr, const void* gidx,
                           const void* dfT, int64_t ld_df, void* df9T,
                           int64_t ld_out, int t, int slab, int group,
                           double inv_h, double c4h, void* stream) {
  forces_warp_v4_bwd_rows_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)restT_rows, (const T*)static_slab, (const T*)srT, ld_sr,
      (const int32_t*)gidx, (const T*)dfT, ld_df, (T*)df9T, ld_out, slab,
      group, (T)inv_h, (T)c4h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forces_bwd_slab(const void* restT_rows, const void* static_slab,
                           const void* f9T, int64_t ld_f9, const void* srT,
                           int64_t ld_sr, const void* gidx, const void* dfT,
                           int64_t ld_df, void* dsr, int64_t ld_out, int t,
                           int slab, int group, double inv_h, double c4h,
                           void* stream) {
  forces_warp_v4_bwd_slab_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)restT_rows, (const T*)static_slab, (const T*)f9T, ld_f9,
      (const T*)srT, ld_sr, (const int32_t*)gidx, (const T*)dfT, ld_df,
      (T*)dsr, ld_out, slab, group, (T)inv_h, (T)c4h);
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

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

const char* sb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int sb_moments_v4_f32(const void* restT_rows, const void* static_slab,
                      const void* posT, int64_t ld_pos, const void* posT_rows,
                      int64_t ld_rows, const void* gidx, void* ayT,
                      int64_t ld_out, int t, int slab, int group, double inv_h,
                      double c4, double c4h, void* stream) {
  return launch_moments<float>(restT_rows, static_slab, posT, ld_pos,
                               posT_rows, ld_rows, gidx, ayT, ld_out, t, slab,
                               group, inv_h, c4, c4h, stream);
}

int sb_moments_v4_f64(const void* restT_rows, const void* static_slab,
                      const void* posT, int64_t ld_pos, const void* posT_rows,
                      int64_t ld_rows, const void* gidx, void* ayT,
                      int64_t ld_out, int t, int slab, int group, double inv_h,
                      double c4, double c4h, void* stream) {
  return launch_moments<double>(restT_rows, static_slab, posT, ld_pos,
                                posT_rows, ld_rows, gidx, ayT, ld_out, t, slab,
                                group, inv_h, c4, c4h, stream);
}

int sb_forces_warp_v4_f32(const void* restT_rows, const void* static_slab,
                          const void* f9T, int64_t ld_f9, const void* srT,
                          int64_t ld_sr, const void* gidx, void* fT,
                          int64_t ld_out, int t, int slab, int group,
                          double inv_h, double c4h, void* stream) {
  return launch_forces<float>(restT_rows, static_slab, f9T, ld_f9, srT, ld_sr,
                              gidx, fT, ld_out, t, slab, group, inv_h, c4h,
                              stream);
}

int sb_forces_warp_v4_f64(const void* restT_rows, const void* static_slab,
                          const void* f9T, int64_t ld_f9, const void* srT,
                          int64_t ld_sr, const void* gidx, void* fT,
                          int64_t ld_out, int t, int slab, int group,
                          double inv_h, double c4h, void* stream) {
  return launch_forces<double>(restT_rows, static_slab, f9T, ld_f9, srT, ld_sr,
                               gidx, fT, ld_out, t, slab, group, inv_h, c4h,
                               stream);
}

#define SB_BWD_ENTRIES(SUF, T)                                                 \
  int sb_moments_v4_bwd_##SUF(const void* restT_rows, const void* static_slab, \
                              const void* dayT, int64_t ld_day,                \
                              const void* rs6T, int64_t ld_rs6, void* dps,     \
                              int64_t ld_ps, void* dprow, int64_t ld_row,      \
                              int t, int slab, double inv_h, double c4,        \
                              double c4h, void* stream) {                      \
    return launch_moments_bwd<T>(restT_rows, static_slab, dayT, ld_day, rs6T,  \
                                 ld_rs6, dps, ld_ps, dprow, ld_row, t, slab,   \
                                 inv_h, c4, c4h, stream);                      \
  }                                                                            \
  int sb_forces_warp_v4_bwd_rows_##SUF(                                        \
      const void* restT_rows, const void* static_slab, const void* srT,        \
      int64_t ld_sr, const void* gidx, const void* dfT, int64_t ld_df,         \
      void* df9T, int64_t ld_out, int t, int slab, int group, double inv_h,    \
      double c4h, void* stream) {                                              \
    return launch_forces_bwd_rows<T>(restT_rows, static_slab, srT, ld_sr,      \
                                     gidx, dfT, ld_df, df9T, ld_out, t, slab,  \
                                     group, inv_h, c4h, stream);               \
  }                                                                            \
  int sb_forces_warp_v4_bwd_slab_##SUF(                                        \
      const void* restT_rows, const void* static_slab, const void* f9T,        \
      int64_t ld_f9, const void* srT, int64_t ld_sr, const void* gidx,         \
      const void* dfT, int64_t ld_df, void* dsr, int64_t ld_out, int t,        \
      int slab, int group, double inv_h, double c4h, void* stream) {           \
    return launch_forces_bwd_slab<T>(restT_rows, static_slab, f9T, ld_f9, srT, \
                                     ld_sr, gidx, dfT, ld_df, dsr, ld_out, t,  \
                                     slab, group, inv_h, c4h, stream);         \
  }                                                                            \
  int sb_slab_to_slots_##SUF(const void* buf, int64_t ld_buf, const void* ptr, \
                             const void* idx, void* out, int64_t ld_out,       \
                             int k, int n_slots, int group, void* stream) {    \
    return launch_slab_to_slots<T>(buf, ld_buf, ptr, idx, out, ld_out, k,      \
                                   n_slots, group, stream);                    \
  }

SB_BWD_ENTRIES(f32, float)
SB_BWD_ENTRIES(f64, double)

}  // extern "C"
