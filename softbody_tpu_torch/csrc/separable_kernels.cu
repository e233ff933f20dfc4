// Kernels of the Taichi pairing (pair_def_grad = "j", separable forces),
// hand-written for Hopper (sm_90a).  Each replaces one Pallas body of
// softbody_tpu/ops/pallas/pair_kernels.py:
//
// forces_sep_kernel            :: _forces_kernel (launched by
//                                 _forces_fwd_impl, from ops/pallas/packed.py
//                                 :: forces_packed)
// forces_sep_bwd_rows_kernel   :: _forces_bwd_kernel, as two launches
// forces_sep_bwd_slab_kernel      (pair_kernels.py :: _forces_vjp_bwd, from
//                                 packed.py :: _forces_packed_vjp_bwd)
//
// What they compute (tile of ROWS = 32 rows against its candidate slab,
// slot = gidx[tile, e / group] * group + e % group; lane-major operands;
// G = V M per slot, row 3a + b = G[a][b]; nw = gfac dx = grad W_ij):
//   forces_sep: f_a = 0.5 V_i (sum_j (G_j nw)_a + sum_b M_i[a][b] svnw_b)
//     with M_i = G_i / V_safe,i (V_safe = V where V > 0, else 1, so an
//     empty slot's row behaves as the TPU kernel's) and svnw_b =
//     sum_j V_j nw_b recomputed over the slab, as the TPU kernel does.
//     Stores fT (3, m).
//   forces_sep_bwd_rows: with d_a = 0.5 V_i df_a, dG_rows[3a + b] =
//     (d_a / V_safe,i) svnw_b, the term_i path (dgrT (9, m)).
//   forces_sep_bwd_slab: per slab entry dG_slab[3a + b] = sum_i nw_b d_a,
//     the term_j path, (9, t * slab) field-major, to slab_to_slots.
//   Volumes get no cotangent (material constants), as in the TPU VJP.
//
// Bound on an H100 SXM (67 TFLOP/s FP32, 3.35 TB/s): all three are
// OPERATION-bound.  Per pair forces_sep does 50 flops (the spline 23, the
// G_j nw sum 18, the V_j nw sum 6, nw 3), the rows pass 32 and the slab
// pass 44; per slab entry the forward stages 13 values (rest_3, V_j, G_9)
// and the rows pass 4, each serving the tile's 32 rows.
// What the design does about it: the K2 tile design of pair_kernels.cu
// (plain FP32 FMAs, never TF32; a lane per row; the slab staged through
// shared memory and read back as broadcasts; fixed-order cross-warp sums,
// no atomics).  The TPU kernel ran term_j as an MXU dot of the (3 rows,
// slab) nw stack against the slab's G (slab, 9); here each lane keeps its
// row's three sums in registers.  The backward is two launches so that
// every sum has one owner: the rows pass (a lane per row, as the forward)
// and the slab pass (a thread per slab entry looping over the 32 rows in
// order); the TPU kernel's single body needed the 9 slab sums reduced
// across rows.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launch.  Kernels launch on the caller's stream
// and allocate nothing.

#include "common.cuh"

namespace {

// forces_sep slab entry: rest_3, V_j, G_9, pad (16 values).
template <typename T> struct alignas(16) SepEntry { T v[16]; };
// the rows pass's slab entry: rest_3, V_j.
template <typename T> struct alignas(16) RestEntry { T v[4]; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_sep_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                  const T* __restrict__ static_slab,  // (t, 5, slab)
                  const T* __restrict__ gT_rows,      // (9, ld_gr), column tile*ROWS + r
                  int64_t ld_gr,
                  const T* __restrict__ gT,           // (9, ld_g): G of every slot
                  int64_t ld_g,
                  const T* __restrict__ vol_rows,     // (t*ROWS,)
                  const int32_t* __restrict__ gidx,   // (t, slab / group)
                  T* __restrict__ fT,                 // (3, ld_out)
                  int64_t ld_out,
                  int slab, int group, T inv_h, T c4h) {
  __shared__ SepEntry<T> ent[CHUNK];
  __shared__ T red[NWARPS][6][ROWS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const int32_t* gi = gidx + (int64_t)tile * (slab / group);
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  T sv0 = T(0), sv1 = T(0), sv2 = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    const int e = threadIdx.x;
    if (e < n) {
      const int s = base + e;
      const int64_t slot = (int64_t)gi[s / group] * group + (s % group);
      SepEntry<T> x;
      x.v[0] = st[s];
      x.v[1] = st[slab + s];
      x.v[2] = st[2 * slab + s];
      x.v[3] = st[4 * slab + s];
#pragma unroll
      for (int f = 0; f < 9; ++f) x.v[4 + f] = gT[f * ld_g + slot];
      x.v[13] = x.v[14] = x.v[15] = T(0);
      ent[e] = x;
    }
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const SepEntry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T g = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h);
      const T nw0 = g * dx0, nw1 = g * dx1, nw2 = g * dx2;
      const T* G = x.v + 4;     // G[3a + b] = G_j[a][b]
      acc0 += G[0] * nw0 + G[1] * nw1 + G[2] * nw2;
      acc1 += G[3] * nw0 + G[4] * nw1 + G[5] * nw2;
      acc2 += G[6] * nw0 + G[7] * nw1 + G[8] * nw2;
      sv0 += x.v[3] * nw0;
      sv1 += x.v[3] * nw1;
      sv2 += x.v[3] * nw2;
    }
    __syncwarp();
  }
  red[warp][0][lane] = acc0;
  red[warp][1][lane] = acc1;
  red[warp][2][lane] = acc2;
  red[warp][3][lane] = sv0;
  red[warp][4][lane] = sv1;
  red[warp][5][lane] = sv2;
  __syncthreads();
  // f_a = 0.5 V_i (termj_a + sum_b (G_i[a][b] / V_safe) svnw_b)
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int r = o % ROWS, a = o / ROWS;
    const int64_t col = (int64_t)tile * ROWS + r;
    T tj = T(0), sv[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      tj += red[w][a][r];
#pragma unroll
      for (int b = 0; b < 3; ++b) sv[b] += red[w][3 + b][r];
    }
    const T v = vol_rows[col];
    const T vs = v > T(0) ? v : T(1);
    const T* Grow = gT_rows + (int64_t)(3 * a) * ld_gr + col;
    const T ti = (Grow[0] / vs) * sv[0] + (Grow[ld_gr] / vs) * sv[1]
                 + (Grow[2 * ld_gr] / vs) * sv[2];
    fT[a * ld_out + col] = (T(0.5) * v) * (tj + ti);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_sep_bwd_rows_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                           const T* __restrict__ static_slab,  // (t, 5, slab)
                           const T* __restrict__ vol_rows,     // (t*ROWS,)
                           const T* __restrict__ dfT,          // (3, ld_df)
                           int64_t ld_df,
                           T* __restrict__ dgrT,               // (9, ld_out)
                           int64_t ld_out,
                           int slab, T inv_h, T c4h) {
  __shared__ RestEntry<T> ent[CHUNK];
  __shared__ T red[NWARPS][3][ROWS];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T* st = static_slab + (int64_t)tile * 5 * slab;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T sv0 = T(0), sv1 = T(0), sv2 = T(0);
  for (int base = 0; base < slab; base += CHUNK) {
    const int n = min(CHUNK, slab - base);
    const int e = threadIdx.x;
    if (e < n) {
      const int s = base + e;
      RestEntry<T> x;
      x.v[0] = st[s];
      x.v[1] = st[slab + s];
      x.v[2] = st[2 * slab + s];
      x.v[3] = st[4 * slab + s];
      ent[e] = x;
    }
    __syncwarp();
    const int e1 = min(warp * 32 + 32, n);
    for (int j = warp * 32; j < e1; ++j) {
      const RestEntry<T> x = ent[j];
      const T dx0 = xi0 - x.v[0], dx1 = xi1 - x.v[1], dx2 = xi2 - x.v[2];
      const T g = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h);
      sv0 += x.v[3] * (g * dx0);
      sv1 += x.v[3] * (g * dx1);
      sv2 += x.v[3] * (g * dx2);
    }
    __syncwarp();
  }
  red[warp][0][lane] = sv0;
  red[warp][1][lane] = sv1;
  red[warp][2][lane] = sv2;
  __syncthreads();
  // dG_rows[3a + b] = ((df_a * 0.5 V_i) / V_safe) svnw_b
  for (int o = threadIdx.x; o < 9 * ROWS; o += THREADS) {
    const int r = o % ROWS, k = o / ROWS, a = k / 3, b = k % 3;
    const int64_t col = (int64_t)tile * ROWS + r;
    T sv = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sv += red[w][b][r];
    const T v = vol_rows[col];
    const T vs = v > T(0) ? v : T(1);
    dgrT[k * ld_out + col] = ((dfT[a * ld_df + col] * (T(0.5) * v)) / vs) * sv;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_sep_bwd_slab_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                           const T* __restrict__ static_slab,  // (t, 5, slab)
                           const T* __restrict__ vol_rows,     // (t*ROWS,)
                           const T* __restrict__ dfT,          // (3, ld_df)
                           int64_t ld_df,
                           T* __restrict__ dgs,                // (9, ld_out), column tile*slab + s
                           int64_t ld_out,
                           int slab, T inv_h, T c4h) {
  __shared__ T xr[3][ROWS];
  __shared__ T d[3][ROWS];

  const int tile = blockIdx.x;
  const int64_t col0 = (int64_t)tile * ROWS;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int a = o / ROWS, r = o % ROWS;
    xr[a][r] = rr[o];
    d[a][r] = dfT[a * ld_df + col0 + r] * (T(0.5) * vol_rows[col0 + r]);
  }
  __syncthreads();

  const T* st = static_slab + (int64_t)tile * 5 * slab;
  for (int s = threadIdx.x; s < slab; s += THREADS) {
    const T xj0 = st[s], xj1 = st[slab + s], xj2 = st[2 * slab + s];
    T acc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = T(0);
    for (int r = 0; r < ROWS; ++r) {
      const T dx0 = xr[0][r] - xj0, dx1 = xr[1][r] - xj1, dx2 = xr[2][r] - xj2;
      const T g = spline_gfac(dx0 * dx0 + dx1 * dx1 + dx2 * dx2, inv_h, c4h);
      const T nw[3] = {g * dx0, g * dx1, g * dx2};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) acc[3 * a + b] += nw[b] * d[a][r];
    }
    const int64_t e = (int64_t)tile * slab + s;
#pragma unroll
    for (int k = 0; k < 9; ++k) dgs[k * ld_out + e] = acc[k];
  }
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

#define SB_SEP_ENTRIES(SUF, T)                                                 \
  int sb_forces_sep_##SUF(                                                     \
      const void* restT_rows, const void* static_slab, const void* gT_rows,    \
      int64_t ld_gr, const void* gT, int64_t ld_g, const void* vol_rows,       \
      const void* gidx, void* fT, int64_t ld_out, int t, int slab, int group,  \
      double inv_h, double c4h, void* stream) {                                \
    forces_sep_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(             \
        (const T*)restT_rows, (const T*)static_slab, (const T*)gT_rows, ld_gr, \
        (const T*)gT, ld_g, (const T*)vol_rows, (const int32_t*)gidx, (T*)fT,  \
        ld_out, slab, group, (T)inv_h, (T)c4h);                                \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_forces_sep_bwd_rows_##SUF(                                            \
      const void* restT_rows, const void* static_slab, const void* vol_rows,   \
      const void* dfT, int64_t ld_df, void* dgrT, int64_t ld_out, int t,       \
      int slab, double inv_h, double c4h, void* stream) {                      \
    forces_sep_bwd_rows_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(    \
        (const T*)restT_rows, (const T*)static_slab, (const T*)vol_rows,       \
        (const T*)dfT, ld_df, (T*)dgrT, ld_out, slab, (T)inv_h, (T)c4h);       \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_forces_sep_bwd_slab_##SUF(                                            \
      const void* restT_rows, const void* static_slab, const void* vol_rows,   \
      const void* dfT, int64_t ld_df, void* dgs, int64_t ld_out, int t,        \
      int slab, double inv_h, double c4h, void* stream) {                      \
    forces_sep_bwd_slab_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(    \
        (const T*)restT_rows, (const T*)static_slab, (const T*)vol_rows,       \
        (const T*)dfT, ld_df, (T*)dgs, ld_out, slab, (T)inv_h, (T)c4h);        \
    return (int)cudaGetLastError();                                            \
  }

SB_SEP_ENTRIES(f32, float)
SB_SEP_ENTRIES(f64, double)

}  // extern "C"
