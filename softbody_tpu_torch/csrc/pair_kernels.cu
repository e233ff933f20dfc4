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

#include "common.cuh"

namespace {

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
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T c[3] = {rr[0], rr[ROWS], rr[2 * ROWS]};   // the tile's first rest row
  k1_tile_sums<true>(rr, static_slab + (int64_t)tile * 5 * slab, posT, ld_pos,
                     gidx + (int64_t)tile * (slab / group), slab, group, inv_h, c4, c4h,
                     c, ent, red);
  // 18 output rows x 32 lanes
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS) {
    const int r = o % ROWS, row = o / ROWS, a = row % 3;
    const int64_t col = (int64_t)tile * ROWS + r;
    const T pi = posT_rows[a * ld_rows + col] - c[a];
    ayT[row * ld_out + col] = k1_moment(red, row / 3, a, r, pi);
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
  const int64_t col = (int64_t)tile * ROWS + (threadIdx.x & 31);
  T F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = f9T[k * ld_f9 + col];
  k2_tile_sums<false>(restT_rows + (int64_t)tile * 3 * ROWS,
                      static_slab + (int64_t)tile * 5 * slab, F, srT, ld_sr,
                      gidx + (int64_t)tile * (slab / group), slab, group, inv_h,
                      c4h, ent, red);
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
  const int64_t col0 = (int64_t)blockIdx.x * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int a = o / ROWS, r = o % ROWS;
    T acc = T(0);
#pragma unroll
    for (int blk = 0; blk < 6; ++blk)
      acc += dayT[(3 * blk + a) * ld_day + col0 + r] * rs6T[blk * ld_rs6 + col0 + r];
    dprow[a * ld_row + col0 + r] = -acc;
  }
  k1_bwd_slab(restT_rows, static_slab, dayT, ld_day, dps, ld_ps, slab, inv_h, c4, c4h);
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
  const int64_t col = (int64_t)tile * ROWS + (threadIdx.x & 31);
  k2_bwd_row_sums<false>(restT_rows + (int64_t)tile * 3 * ROWS,
                         static_slab + (int64_t)tile * 5 * slab, srT, ld_sr,
                         gidx + (int64_t)tile * (slab / group), slab, group, inv_h,
                         c4h, dfT[col], dfT[ld_df + col], dfT[2 * ld_df + col], ent,
                         red);
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
  k2_bwd_slab(restT_rows, static_slab, f9T, ld_f9, (const T*)nullptr, srT, ld_sr,
              gidx, dfT, ld_df, dsr, ld_out, slab, group, inv_h, c4h);
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
