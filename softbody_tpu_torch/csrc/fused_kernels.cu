// Kernels of the fused K1 + mid-section path (cfg.fused_mid), hand-written
// for Hopper (sm_90a).  Each replaces one Pallas body of
// softbody_tpu/ops/pallas/pair_kernels.py:
//
// moments_mid_kernel              :: _moments_mid_kernel (launched by
//                                    ops/pallas/packed.py :: _fused_call)
// forces_warp_v2_kernel           :: _forces_warp_kernel_v2 (packed.py ::
//                                    _forces_warp_packed_fwd)
// moments_raw_bwd_kernel          :: _moments_bwd_kernel (pair_kernels.py ::
//                                    _moments_vjp_bwd, from packed.py ::
//                                    _fused_vjp_bwd)
// forces_warp_v2_bwd_rows_kernel  :: _forces_warp_bwd_kernel_v2, as two
// forces_warp_v2_bwd_slab_kernel     launches (pair_kernels.py ::
//                                    _forces_warp_bwd_impl, from packed.py ::
//                                    _forces_warp_packed_vjp_bwd)
// moments_raw_kernel              :: _moments_kernel (pair_kernels.py ::
//                                    _moments_fwd_impl, from packed.py ::
//                                    moments_packed: the blocked layout's
//                                    K1) and the inner kernel of
//                                    _moments_fwd_manual, the same function
//                                    with the slab staged by manual
//                                    double-buffered DMA (TPU only); its
//                                    Hopper form, cp.async / TMA double
//                                    buffering of the slab, is a tuning item
//
// The blocked layout's K2 is forces_warp_v2 (Warp pairing) or
// separable_kernels.cu's forces_sep (Taichi pairing); its raw K1's
// backward is moments_raw_bwd.
//
// What they compute (tile of ROWS = 32 rows against its candidate slab,
// slot = gidx[tile, e / group] * group + e % group; lane-major operands):
//   moments_mid: K1's moments exactly as moments_v4 (pair_kernels.cu): the
//     sums of lhs = [-w m_j dx ; gfac V_j dx] against p = pos_j - c, c the
//     tile's first rest row, and against 1; then, per row, the whole
//     mid-section: A | Y = dots - (pos_i - c) * rowsum, the Jacobi polar
//     R = U V^T of A (8 sweeps, the order and branch rules of ops/mat3.py
//     :: _eigh3_components / _svd3_components), F = I + (R^T Y - rc)^T (or
//     Y - rc with corotated off), the StVK stress S = (2 mu E + lam tr E I)
//     * scale, M = R F S.  Stores fm = [F_9 | M_9 | V_i] (19, m),
//     sr = [S_6 | R^T_9] (15, m) and, for the backward, the A | Y rows.
//     The TPU kernel contracted ABSOLUTE positions and subtracted
//     pos_i * rs6 with the host's static row sums; in f32 that cancellation
//     moves the forces by 5e-5 of their maximum and destabilised a quiet
//     body (pair_kernels.py:512-526).  Centering in the kernel is the same
//     function in exact arithmetic and keeps f32 at the v4 path's accuracy.
//   forces_warp_v2: per pair nw = gfac V_j dx, z_d = sum_b nw_b S_j[d][b],
//     u_c = sum_d F_i[c][d] z_d; termj_a = sum_j (R_j u)_a and
//     svnw_b = sum_j nw_b over the slab; f_a = 0.5 V_i (termj_a +
//     sum_b M_i[a][b] svnw_b), stored as fT (3, m).
//   moments_raw_bwd: dps[a](j) = sum_i sum_blk day[3 blk + a](i) L_blk(i, j),
//     the slab side of K1's VJP.  The row side (-day . rs6 with the static
//     row sums, as the JAX VJP takes it) is a few elementwise ops outside.
//   forces_warp_v2_bwd: with df scaled by 0.5 V_i, the K2 v4 backward
//     (pair_kernels.cu) plus dM[3a+b] = df_a svnw_b: the row pass gives
//     dfm = [dF_9 | dM_9 | 0] (19, m), the slab pass [dS_6 | dR^T_9] per
//     slab entry (to slab_to_slots).
//
// Bound on an H100 SXM (67 TFLOP/s FP32, 3.35 TB/s): every kernel here is
// OPERATION-bound, as the v4 ones: per pair moments_mid does K1's 78 flops,
// forces_warp_v2 78 (K2's 75 + svnw), moments_raw_bwd 72, the backward's
// row pass 78 and slab pass 123, each slab entry staged once serving 32
// rows.  moments_mid adds its mid-section once per ROW, ~2,250 flops (24
// Jacobi rotations): 0.004 ms of work at ~112k, against 0.084 ms for the
// pairs (chip_smoke.py computes every bound from the run's shapes).
// What the design does about it: the v4 tile design (plain FP32 FMAs, never
// TF32; a lane per row; the slab staged through shared memory and read back
// as broadcasts; fixed-order cross-warp sums, no atomics) and the
// mid-section in the epilogue, one thread per row, in registers — on the
// TPU it ran on (rows, 1) columns and made the fused path 3x slower
// (config.py:78-84); here it replaces ~2,600 eager launches per step.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launch.  Kernels launch on the caller's stream
// and allocate nothing.

#include "common.cuh"

namespace {

template <typename T> __device__ __forceinline__ T sqrt_t(T x);
template <> __device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double sqrt_t<double>(double x) { return sqrt(x); }
template <typename T> __device__ __forceinline__ T abs_t(T x) { return x < T(0) ? -x : x; }
template <typename T> __device__ __forceinline__ T sign_t(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// ------------------------------------------- the per-row mid-section
// 3x3 algebra on register arrays, following ops/mat3.py line by line.

template <typename T>
__device__ __forceinline__ void givens(T app, T aqq, T apq, T& c, T& s) {
  const bool small = abs_t(apq) < T(1e-30);
  const T apq_safe = small ? T(1) : apq;
  const T theta = (aqq - app) / (T(2) * apq_safe);
  T t = sign_t(theta) / (abs_t(theta) + sqrt_t(T(1) + theta * theta));
  if (theta == T(0)) t = T(1);
  const T cc = T(1) / sqrt_t(T(1) + t * t);
  const T ss = t * cc;
  c = small ? T(1) : cc;
  s = small ? T(0) : ss;
}

// S <- J^T S J, V <- V J (mat3._rotate)
template <int P, int Q, typename T>
__device__ __forceinline__ void rotate(T (&S)[3][3], T (&V)[3][3]) {
  T c, s;
  givens(S[P][P], S[Q][Q], S[P][Q], c, s);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T sp = S[i][P], sq = S[i][Q];
    S[i][P] = c * sp - s * sq;
    S[i][Q] = s * sp + c * sq;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T rp = S[P][j], rq = S[Q][j];
    S[P][j] = c * rp - s * rq;
    S[Q][j] = s * rp + c * rq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T vp = V[i][P], vq = V[i][Q];
    V[i][P] = c * vp - s * vq;
    V[i][Q] = s * vp + c * vq;
  }
}

// one step of the descending sort network on (e, V columns)
template <int A, int B, typename T>
__device__ __forceinline__ void sort_swap(T (&e)[3], T (&V)[3][3]) {
  if (e[A] < e[B]) {
    const T tmp = e[A]; e[A] = e[B]; e[B] = tmp;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T v = V[i][A]; V[i][A] = V[i][B]; V[i][B] = v;
    }
  }
}

template <typename T>
__device__ __forceinline__ T dot3(const T (&u)[3], const T (&v)[3]) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T (&u)[3], const T (&v)[3], T (&out)[3]) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

// v / |v| where |v| > 1e-12, else the fallback
template <typename T>
__device__ __forceinline__ void normalize3(const T (&v)[3], const T (&fallback)[3],
                                           T (&out)[3]) {
  const T n = sqrt_t(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const bool ok = n > T(1e-12);
  const T n_safe = ok ? n : T(1);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = ok ? v[i] / n_safe : fallback[i];
}

// R = U V^T from the Jacobi SVD of a (mat3._svd3_components + polar3)
template <typename T>
__device__ __forceinline__ void polar3(const T (&a)[3][3], int sweeps, T (&R)[3][3]) {
  T S[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S[i][j] = a[0][i] * a[0][j] + a[1][i] * a[1][j] + a[2][i] * a[2][j];
      V[i][j] = i == j ? T(1) : T(0);
    }
  for (int k = 0; k < sweeps; ++k) {
    rotate<0, 1>(S, V);
    rotate<0, 2>(S, V);
    rotate<1, 2>(S, V);
  }
  T e[3] = {S[0][0], S[1][1], S[2][2]};
  sort_swap<0, 1>(e, V);
  sort_swap<1, 2>(e, V);
  sort_swap<0, 1>(e, V);
  // B = a V = U diag(sigma); the singular values themselves are not needed
  T b[3][3];   // b[k] = column k of B
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      b[k][i] = a[i][0] * V[0][k] + a[i][1] * V[1][k] + a[i][2] * V[2][k];
  const T e0[3] = {T(1), T(0), T(0)};
  const T e1[3] = {T(0), T(1), T(0)};
  T u0[3], u1[3], u2[3], tmp[3], alt[3];
  normalize3(b[0], e0, u0);
  const T rolled[3] = {u0[2] + T(0.5), u0[0], u0[1]};
  cross3(u0, rolled, tmp);
  normalize3(tmp, e1, alt);
  const T d01 = dot3(u0, b[1]);
#pragma unroll
  for (int i = 0; i < 3; ++i) tmp[i] = b[1][i] - d01 * u0[i];
  normalize3(tmp, alt, u1);
  const T d20 = dot3(u0, b[2]);
  T u2b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u2b[i] = b[2][i] - d20 * u0[i];
  const T d21 = dot3(u1, u2b);
#pragma unroll
  for (int i = 0; i < 3; ++i) u2b[i] = u2b[i] - d21 * u1[i];
  T c01[3];
  cross3(u0, u1, c01);
  T sgn = dot3(u2b, c01);
  sgn = abs_t(sgn) > T(1e-12) ? sign_t(sgn) : T(1);
#pragma unroll
  for (int i = 0; i < 3; ++i) tmp[i] = sgn * c01[i];
  normalize3(u2b, tmp, u2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = u0[i] * V[j][0] + u1[i] * V[j][1] + u2[i] * V[j][2];
}

// A, Y, rc -> R, F, S, M (sim/blocked.mid_rows)
template <typename T>
__device__ __forceinline__ void mid_row(const T (&A)[3][3], const T (&Y)[3][3],
                                        const T (&rc)[3][3], T mu, T lam, T scale,
                                        bool corotated, int sweeps,
                                        T (&R)[3][3], T (&F)[3][3], T (&S)[3][3],
                                        T (&M)[3][3]) {
  T nab[3][3];
  if (corotated) {
    polar3(A, sweeps, R);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        nab[i][j] = (R[0][i] * Y[0][j] + R[1][i] * Y[1][j] + R[2][i] * Y[2][j])
                    - rc[i][j];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        R[i][j] = i == j ? T(1) : T(0);
        nab[i][j] = Y[i][j] - rc[i][j];
      }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = i == j ? T(1) + nab[j][i] : nab[j][i];
  T E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T ftf = F[0][i] * F[0][j] + F[1][i] * F[1][j] + F[2][i] * F[2][j];
      E[i][j] = i == j ? T(0.5) * (ftf - T(1)) : T(0.5) * ftf;
    }
  const T tr = E[0][0] + E[1][1] + E[2][2];
  const T two_mu = T(2) * mu;
  const T lam_tr = lam * tr;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      S[i][j] = (i == j ? two_mu * E[i][j] + lam_tr : two_mu * E[i][j]) * scale;
  T FS[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      FS[i][j] = F[i][0] * S[0][j] + F[i][1] * S[1][j] + F[i][2] * S[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = R[i][0] * FS[0][j] + R[i][1] * FS[1][j] + R[i][2] * FS[2][j];
}

// ---------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_mid_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                   const T* __restrict__ static_slab,  // (t, 5, slab)
                   const T* __restrict__ posT,         // (3, ld_pos)
                   int64_t ld_pos,
                   const T* __restrict__ posT_rows,    // (3, ld_rows), column tile*ROWS + r
                   int64_t ld_rows,
                   const int32_t* __restrict__ gidx,   // (t, slab / group)
                   const T* __restrict__ mu,           // (t*ROWS,)
                   const T* __restrict__ lam,          // (t*ROWS,)
                   const T* __restrict__ vol,          // (t*ROWS,)
                   const T* __restrict__ rcT,          // (9, ld_rc): rc[a][b] at 3a+b
                   int64_t ld_rc,
                   const T* __restrict__ scale,        // (t*ROWS,)
                   T* __restrict__ fmT,                // (19, ld_fm)
                   int64_t ld_fm,
                   T* __restrict__ srT,                // (15, ld_sr)
                   int64_t ld_sr,
                   T* __restrict__ ayT,                // (18, ld_ay) or null
                   int64_t ld_ay,
                   int slab, int group, T inv_h, T c4, T c4h, int corotated,
                   int sweeps) {
  __shared__ K1Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][24][ROWS];

  // stage 1: K1's sums (moments_v4_kernel's)
  const int tile = blockIdx.x;
  const T* rr = restT_rows + (int64_t)tile * 3 * ROWS;
  const T c[3] = {rr[0], rr[ROWS], rr[2 * ROWS]};   // the tile's first rest row
  k1_tile_sums<true>(rr, static_slab + (int64_t)tile * 5 * slab, posT, ld_pos,
                     gidx + (int64_t)tile * (slab / group), slab, group, inv_h, c4, c4h,
                     c, ent, red);
  if (threadIdx.x >= ROWS) return;   // no barrier follows

  // stage 2: the mid-section, one thread per row
  const int r = threadIdx.x;
  const int64_t col = (int64_t)tile * ROWS + r;
  T A[3][3], Y[3][3];
#pragma unroll
  for (int row = 0; row < 18; ++row) {
    const int k = row / 3, a = row % 3;
    const T v = k1_moment(red, k, a, r, posT_rows[a * ld_rows + col] - c[a]);
    if (ayT != nullptr) ayT[row * ld_ay + col] = v;
    // row 3*blk + a: A[a][blk] for blk < 3, Y[a][blk - 3] after
    if (k < 3) A[a][k] = v; else Y[a][k - 3] = v;
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

// moments_raw_kernel: K1's tile sums against the ABSOLUTE positions (the
// shift c = 0): row 3 blk + a of ayT is sum_j lhs_blk pos_j[a], the raw,
// uncentered dots of _moments_kernel.  The caller subtracts
// pos_i[a] rs6[blk] with rs6 from this same kernel on an all-ones RHS (the
// blocked scene's build), so the correction cancels against sums of the
// same f32 coefficients; centering here would change the output that the
// build and the SPMD shards read raw.  The row sums are not formed
// (k1_tile_sums<false>): 72 flops per pair, not K1 v4's 78.
template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_raw_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                   const T* __restrict__ static_slab,  // (t, 5, slab)
                   const T* __restrict__ posT,         // (3, ld_pos)
                   int64_t ld_pos,
                   const int32_t* __restrict__ gidx,   // (t, slab / group)
                   T* __restrict__ ayT,                // (18, ld_out)
                   int64_t ld_out,
                   int slab, int group, T inv_h, T c4, T c4h) {
  __shared__ K1Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][18][ROWS];

  const int tile = blockIdx.x;
  const T zero[3] = {T(0), T(0), T(0)};
  k1_tile_sums<false>(restT_rows + (int64_t)tile * 3 * ROWS,
                      static_slab + (int64_t)tile * 5 * slab, posT, ld_pos,
                      gidx + (int64_t)tile * (slab / group), slab, group, inv_h, c4, c4h,
                      zero, ent, red);
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS) {
    const int r = o % ROWS, row = o / ROWS;
    T dot = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) dot += red[w][row][r];
    ayT[row * ld_out + (int64_t)tile * ROWS + r] = dot;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v2_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                      const T* __restrict__ static_slab,  // (t, 5, slab)
                      const T* __restrict__ fmT,          // (19, ld_fm): F_9 | M_9 | V
                      int64_t ld_fm,
                      const T* __restrict__ srT,          // (15, ld_sr): S_6 | R^T_9
                      int64_t ld_sr,
                      const int32_t* __restrict__ gidx,   // (t, slab / group)
                      T* __restrict__ fT,                 // (3, ld_out)
                      int64_t ld_out,
                      int slab, int group, T inv_h, T c4h) {
  __shared__ K2Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][6][ROWS];

  const int tile = blockIdx.x;
  const int64_t col = (int64_t)tile * ROWS + (threadIdx.x & 31);
  T F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = fmT[k * ld_fm + col];
  k2_tile_sums<true>(restT_rows + (int64_t)tile * 3 * ROWS,
                     static_slab + (int64_t)tile * 5 * slab, F, srT, ld_sr,
                     gidx + (int64_t)tile * (slab / group), slab, group, inv_h, c4h,
                     ent, red);
  // f_a = 0.5 V_i (termj_a + sum_b M_i[a][b] svnw_b)
  for (int o = threadIdx.x; o < 3 * ROWS; o += THREADS) {
    const int r = o % ROWS, a = o / ROWS;
    const int64_t c = (int64_t)tile * ROWS + r;
    T tj = T(0), sv[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      tj += red[w][a][r];
#pragma unroll
      for (int b = 0; b < 3; ++b) sv[b] += red[w][3 + b][r];
    }
    const T* Mrow = fmT + (9 + 3 * a) * ld_fm + c;
    const T ti = Mrow[0] * sv[0] + Mrow[ld_fm] * sv[1] + Mrow[2 * ld_fm] * sv[2];
    fT[a * ld_out + c] = (T(0.5) * fmT[18 * ld_fm + c]) * (tj + ti);
  }
}

// ---------------------------------------------------------------- backward
// moments_raw_bwd_kernel: one block per tile, one thread per slab entry
// looping over the 32 rows, as moments_v4_bwd_kernel without its row term.
// forces_warp_v2_bwd_rows_kernel: the forward's layout (a lane per row, four
// warps splitting the slab), 12 accumulators: dF's 9 and svnw's 3.
// forces_warp_v2_bwd_slab_kernel: a thread per slab entry looping over the
// rows, 15 accumulators.  The two K2 passes sum in opposite directions;
// each output has one owner and the only cross-thread sum is the forward's
// fixed-order warp reduction, so the gradient is bitwise repeatable.

template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_raw_bwd_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                       const T* __restrict__ static_slab,  // (t, 5, slab)
                       const T* __restrict__ dayT,         // (18, ld_day)
                       int64_t ld_day,
                       T* __restrict__ dps,                // (3, ld_ps), column tile*slab + s
                       int64_t ld_ps,
                       int slab, T inv_h, T c4, T c4h) {
  k1_bwd_slab(restT_rows, static_slab, dayT, ld_day, dps, ld_ps, slab, inv_h, c4, c4h);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v2_bwd_rows_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                               const T* __restrict__ static_slab,  // (t, 5, slab)
                               const T* __restrict__ fmT,          // (19, ld_fm)
                               int64_t ld_fm,
                               const T* __restrict__ srT,          // (15, ld_sr)
                               int64_t ld_sr,
                               const int32_t* __restrict__ gidx,   // (t, slab / group)
                               const T* __restrict__ dfT,          // (3, ld_df)
                               int64_t ld_df,
                               T* __restrict__ dfmT,               // (19, ld_out)
                               int64_t ld_out,
                               int slab, int group, T inv_h, T c4h) {
  __shared__ K2Entry<T> ent[CHUNK];
  __shared__ T red[NWARPS][12][ROWS];

  const int tile = blockIdx.x;
  const int64_t col = (int64_t)tile * ROWS + (threadIdx.x & 31);
  const T hv = T(0.5) * fmT[18 * ld_fm + col];
  k2_bwd_row_sums<true>(restT_rows + (int64_t)tile * 3 * ROWS,
                        static_slab + (int64_t)tile * 5 * slab, srT, ld_sr,
                        gidx + (int64_t)tile * (slab / group), slab, group, inv_h,
                        c4h, dfT[col] * hv, dfT[ld_df + col] * hv,
                        dfT[2 * ld_df + col] * hv, ent, red);
  for (int o = threadIdx.x; o < 19 * ROWS; o += THREADS) {
    const int r = o % ROWS, k = o / ROWS;
    const int64_t c = (int64_t)tile * ROWS + r;
    T out = T(0);
    if (k < 9) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) out += red[w][k][r];
    } else if (k < 18) {
      // dM[3a + b] = df_a svnw_b
      const int a = (k - 9) / 3, b = (k - 9) % 3;
      T sv = T(0);
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) sv += red[w][9 + b][r];
      out = (dfT[a * ld_df + c] * (T(0.5) * fmT[18 * ld_fm + c])) * sv;
    }
    dfmT[k * ld_out + c] = out;   // row 18: V_i is a material constant
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
forces_warp_v2_bwd_slab_kernel(const T* __restrict__ restT_rows,   // (t, 3, ROWS)
                               const T* __restrict__ static_slab,  // (t, 5, slab)
                               const T* __restrict__ fmT,          // (19, ld_fm)
                               int64_t ld_fm,
                               const T* __restrict__ srT,          // (15, ld_sr)
                               int64_t ld_sr,
                               const int32_t* __restrict__ gidx,   // (t, slab / group)
                               const T* __restrict__ dfT,          // (3, ld_df)
                               int64_t ld_df,
                               T* __restrict__ dsr,                // (15, ld_out), column tile*slab + s
                               int64_t ld_out,
                               int slab, int group, T inv_h, T c4h) {
  // F_i is fmT's rows 0-8; df is scaled by 0.5 V_i, row 18
  k2_bwd_slab(restT_rows, static_slab, fmT, ld_fm, fmT + 18 * ld_fm, srT, ld_sr,
              gidx, dfT, ld_df, dsr, ld_out, slab, group, inv_h, c4h);
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

#define SB_FUSED_ENTRIES(SUF, T)                                               \
  int sb_moments_mid_##SUF(                                                    \
      const void* restT_rows, const void* static_slab, const void* posT,       \
      int64_t ld_pos, const void* posT_rows, int64_t ld_rows,                  \
      const void* gidx, const void* mu, const void* lam, const void* vol,      \
      const void* rcT, int64_t ld_rc, const void* scale, void* fmT,            \
      int64_t ld_fm, void* srT, int64_t ld_sr, void* ayT, int64_t ld_ay,       \
      int t, int slab, int group, double inv_h, double c4, double c4h,         \
      int corotated, int sweeps, void* stream) {                               \
    moments_mid_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(            \
        (const T*)restT_rows, (const T*)static_slab, (const T*)posT, ld_pos,   \
        (const T*)posT_rows, ld_rows, (const int32_t*)gidx, (const T*)mu,      \
        (const T*)lam, (const T*)vol, (const T*)rcT, ld_rc, (const T*)scale,   \
        (T*)fmT, ld_fm, (T*)srT, ld_sr, (T*)ayT, ld_ay, slab, group,           \
        (T)inv_h, (T)c4, (T)c4h, corotated, sweeps);                           \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_moments_raw_##SUF(                                                    \
      const void* restT_rows, const void* static_slab, const void* posT,       \
      int64_t ld_pos, const void* gidx, void* ayT, int64_t ld_out, int t,      \
      int slab, int group, double inv_h, double c4, double c4h,                \
      void* stream) {                                                          \
    moments_raw_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(            \
        (const T*)restT_rows, (const T*)static_slab, (const T*)posT, ld_pos,   \
        (const int32_t*)gidx, (T*)ayT, ld_out, slab, group, (T)inv_h, (T)c4,   \
        (T)c4h);                                                               \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_forces_warp_v2_##SUF(                                                 \
      const void* restT_rows, const void* static_slab, const void* fmT,        \
      int64_t ld_fm, const void* srT, int64_t ld_sr, const void* gidx,         \
      void* fT, int64_t ld_out, int t, int slab, int group, double inv_h,      \
      double c4h, void* stream) {                                              \
    forces_warp_v2_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(         \
        (const T*)restT_rows, (const T*)static_slab, (const T*)fmT, ld_fm,     \
        (const T*)srT, ld_sr, (const int32_t*)gidx, (T*)fT, ld_out, slab,      \
        group, (T)inv_h, (T)c4h);                                              \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_moments_raw_bwd_##SUF(                                                \
      const void* restT_rows, const void* static_slab, const void* dayT,       \
      int64_t ld_day, void* dps, int64_t ld_ps, int t, int slab, double inv_h, \
      double c4, double c4h, void* stream) {                                   \
    moments_raw_bwd_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>(        \
        (const T*)restT_rows, (const T*)static_slab, (const T*)dayT, ld_day,   \
        (T*)dps, ld_ps, slab, (T)inv_h, (T)c4, (T)c4h);                        \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_forces_warp_v2_bwd_rows_##SUF(                                        \
      const void* restT_rows, const void* static_slab, const void* fmT,        \
      int64_t ld_fm, const void* srT, int64_t ld_sr, const void* gidx,         \
      const void* dfT, int64_t ld_df, void* dfmT, int64_t ld_out, int t,       \
      int slab, int group, double inv_h, double c4h, void* stream) {           \
    forces_warp_v2_bwd_rows_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>( \
        (const T*)restT_rows, (const T*)static_slab, (const T*)fmT, ld_fm,     \
        (const T*)srT, ld_sr, (const int32_t*)gidx, (const T*)dfT, ld_df,      \
        (T*)dfmT, ld_out, slab, group, (T)inv_h, (T)c4h);                      \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int sb_forces_warp_v2_bwd_slab_##SUF(                                        \
      const void* restT_rows, const void* static_slab, const void* fmT,        \
      int64_t ld_fm, const void* srT, int64_t ld_sr, const void* gidx,         \
      const void* dfT, int64_t ld_df, void* dsr, int64_t ld_out, int t,        \
      int slab, int group, double inv_h, double c4h, void* stream) {           \
    forces_warp_v2_bwd_slab_kernel<T><<<t, THREADS, 0, (cudaStream_t)stream>>>( \
        (const T*)restT_rows, (const T*)static_slab, (const T*)fmT, ld_fm,     \
        (const T*)srT, ld_sr, (const int32_t*)gidx, (const T*)dfT, ld_df,      \
        (T*)dsr, ld_out, slab, group, (T)inv_h, (T)c4h);                       \
    return (int)cudaGetLastError();                                            \
  }

SB_FUSED_ENTRIES(f32, float)
SB_FUSED_ENTRIES(f64, double)

}  // extern "C"
