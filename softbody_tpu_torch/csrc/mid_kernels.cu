// The mid-section and its VJP as their own launches, hand-written for
// Hopper (sm_90a):
//
// mid_records_kernel      replaces softbody_tpu/ops/pallas/packed.py ::
//                         _mid_xla (the XLA reference of the fused kernel's
//                         epilogue, which XLA compiles into the jitted step
//                         on the default path and paths A and B:
//                         softbody_tpu/sim/blocked.py :: _mid_section)
// mid_records_bwd_kernel  replaces jax.vjp of _mid_xla inside
//                         packed.py :: _fused_vjp_bwd (and XLA's VJP of
//                         _mid_section in the unfused steps)
//
// What they compute, one thread per tile row, nothing shared between rows
// (no atomics: bitwise repeatable):
//   forward: from K1's A | Y rows ayT (18, m) (row 3b+a = [a][b]; with the
//     raw-dot correction A, Y = dots - pos_i[a] rs6[b], as _mid_xla's dyn /
//     stat operands, path B's uncentered dots), the per-row statics (mu,
//     lam, vol, the rest correction rc) and the stiffness scale, mid.cuh's
//     mid_row: the Jacobi polar R of A, F = I + (R^T Y - rc)^T, the StVK
//     stress S and M = R F S, stored as the K2 records fmT (19, m) =
//     [F_9 | M_9 | V] and srT (15, n_sr) = [S_6 | R^T_9], srT's columns
//     [m, n_sr) zeroed (the slots past the tile rows, which K2 reads).
//   backward: the cotangents dfmT (19, m) and dsrT (15, m) -> dayT
//     (18, m), dscale (m,) and, with the correction, dposT_rows (3, m) =
//     -sum_b (dA[a][b] rs6[b] + dY[a][b] rs6[3 + b]).  Each thread
//     recomputes its row's forward in registers from ayT (as JAX's VJP
//     recomputes from its ay residual) and back-propagates it (mid.cuh's
//     mid_row_bwd, the polar through its clamped VJP).
//
// Bound on an H100 SXM (67 TFLOP/s FP32, 3.35 TB/s): BYTES.  The forward
// moves 65 values per row (31 read, 34 written) for ~2,090 flops, the
// backward 82 (63 read, 19 written) for ~2,690: about 8 flops per byte in
// f32, under the card's 20 (chip_smoke.py computes the bound from the
// run's shapes; the raw-dot correction adds 9 values read, and 3 written
// backward).  What the design does about
// it: every operand is lane-major, so a warp's loads and stores of one
// field are 32 consecutive values; nothing is read twice; the row's whole
// chain (24 Jacobi rotations, the SVD, F, S, M and, backward, the VJP)
// stays in registers, so no intermediate touches memory.
//
// Rounding: this file is compiled with --fmad=false (ops/_build.py), so
// every multiply and add rounds on its own, as the plain version's
// elementwise torch ops do, and mid.cuh writes the plain version's formulas
// in its order.  The inflatable body is a shell: many rows' neighbours are
// nearly coplanar, their A's smallest singular value ~1e-4 of the largest,
// and there the f32 polar's VJP is sensitive to how its forward rounds.
// On an H100 at the ~112k stretch scene's 120,832 rows, with contracted
// multiply-adds the backward's dayT stood 1.1e-4 of its maximum from the
// plain version's (both ~5e-5 from f64); rounded op by op the forward is
// bitwise the plain version's and dayT 8.4e-7 from it (chip_smoke.py phase
// 44).  The correction's products pos_i[a] rs6[b] round on their own too:
// path B's f32 dots cancel against them.
//
// Entry points have a plain C interface for ctypes; each returns
// cudaGetLastError() of its launch.  Kernels launch on the caller's stream
// and allocate nothing.

#include "common.cuh"
#include "mid.cuh"

namespace {

constexpr int MID_THREADS = 128;

// Row `col`'s A and Y from ayT (row 3b+a is [a][b]); with CORR, minus
// pos_i[a] rs6[b] (rs6[3 + b] for Y), p and rs6 returned for the backward.
template <typename T, bool CORR>
__device__ __forceinline__ void load_ay(const T* __restrict__ ayT, int64_t ld_ay,
                                        const T* __restrict__ posT_rows, int64_t ld_pos,
                                        const T* __restrict__ rs6T, int64_t ld_rs6,
                                        int64_t col, T (&A)[3][3], T (&Y)[3][3],
                                        T (&p)[3], T (&rs)[6]) {
  if constexpr (CORR) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = posT_rows[a * ld_pos + col];
#pragma unroll
    for (int k = 0; k < 6; ++k) rs[k] = rs6T[k * ld_rs6 + col];
  }
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T va = ayT[(3 * b + a) * ld_ay + col];
      T vy = ayT[(9 + 3 * b + a) * ld_ay + col];
      if constexpr (CORR) {
        va = va - p[a] * rs[b];
        vy = vy - p[a] * rs[3 + b];
      }
      A[a][b] = va;
      Y[a][b] = vy;
    }
}

template <typename T>
__device__ __forceinline__ void load_rc(const T* __restrict__ rcT, int64_t ld_rc,
                                        int64_t col, T (&rc)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rc[i][j] = rcT[(3 * i + j) * ld_rc + col];
}

template <typename T, bool CORR>
__global__ void __launch_bounds__(MID_THREADS)
mid_records_kernel(const T* __restrict__ ayT, int64_t ld_ay,          // (18, ld_ay)
                   const T* __restrict__ posT_rows, int64_t ld_pos,   // (3, ld_pos), CORR
                   const T* __restrict__ rs6T, int64_t ld_rs6,        // (6, ld_rs6), CORR
                   const T* __restrict__ mu, const T* __restrict__ lam,
                   const T* __restrict__ vol,                         // (m,) each
                   const T* __restrict__ rcT, int64_t ld_rc,          // (9, ld_rc): rc[a][b] at 3a+b
                   const T* __restrict__ scale,                       // (m,)
                   T* __restrict__ fmT, int64_t ld_fm,                // (19, ld_fm)
                   T* __restrict__ srT, int64_t ld_sr,                // (15, ld_sr)
                   int64_t m, int64_t n_sr, int corotated, int sweeps) {
  const int64_t col = (int64_t)blockIdx.x * MID_THREADS + threadIdx.x;
  if (col >= n_sr) return;
  if (col >= m) {                 // a slot past the tile rows: its record is zero
#pragma unroll
    for (int k = 0; k < 15; ++k) srT[k * ld_sr + col] = T(0);
    return;
  }
  T A[3][3], Y[3][3], p[3], rs[6], rc[3][3];
  load_ay<T, CORR>(ayT, ld_ay, posT_rows, ld_pos, rs6T, ld_rs6, col, A, Y, p, rs);
  load_rc(rcT, ld_rc, col, rc);
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

template <typename T, bool CORR>
__global__ void __launch_bounds__(MID_THREADS)
mid_records_bwd_kernel(const T* __restrict__ ayT, int64_t ld_ay,
                       const T* __restrict__ posT_rows, int64_t ld_pos,
                       const T* __restrict__ rs6T, int64_t ld_rs6,
                       const T* __restrict__ mu, const T* __restrict__ lam,
                       const T* __restrict__ rcT, int64_t ld_rc,
                       const T* __restrict__ scale,
                       const T* __restrict__ dfmT, int64_t ld_dfm,   // (19, ld_dfm): row 18 unread
                       const T* __restrict__ dsrT, int64_t ld_dsr,   // (15, ld_dsr)
                       T* __restrict__ dayT, int64_t ld_day,         // (18, ld_day)
                       T* __restrict__ dscale,                       // (m,)
                       T* __restrict__ dposT, int64_t ld_dpos,       // (3, ld_dpos), CORR
                       int64_t m, int corotated, int sweeps) {
  const int64_t col = (int64_t)blockIdx.x * MID_THREADS + threadIdx.x;
  if (col >= m) return;
  T A[3][3], Y[3][3], p[3], rs[6], rc[3][3];
  load_ay<T, CORR>(ayT, ld_ay, posT_rows, ld_pos, rs6T, ld_rs6, col, A, Y, p, rs);
  load_rc(rcT, ld_rc, col, rc);
  T dF[3][3], dM[3][3], dR[3][3], dS6[6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dF[i][j] = dfmT[(3 * i + j) * ld_dfm + col];
      dM[i][j] = dfmT[(9 + 3 * i + j) * ld_dfm + col];
      dR[i][j] = dsrT[(6 + 3 * j + i) * ld_dsr + col];
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) dS6[k] = dsrT[k * ld_dsr + col];
  T dA[3][3], dY[3][3], ds;
  mid_row_bwd(A, Y, rc, mu[col], lam[col], scale[col], corotated != 0, sweeps, dF, dM,
              dS6, dR, dA, dY, ds);
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dayT[(3 * b + a) * ld_day + col] = dA[a][b];
      dayT[(9 + 3 * b + a) * ld_day + col] = dY[a][b];
    }
  dscale[col] = ds;
  if constexpr (CORR) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc += dA[a][b] * rs[b] + dY[a][b] * rs[3 + b];
      dposT[a * ld_dpos + col] = -acc;
    }
  }
}

int blocks_for(int64_t n) { return (int)((n + MID_THREADS - 1) / MID_THREADS); }

template <typename T>
int launch_mid_records(const void* ayT, int64_t ld_ay, const void* posT_rows,
                       int64_t ld_pos, const void* rs6T, int64_t ld_rs6, const void* mu,
                       const void* lam, const void* vol, const void* rcT, int64_t ld_rc,
                       const void* scale, void* fmT, int64_t ld_fm, void* srT,
                       int64_t ld_sr, int64_t m, int64_t n_sr, int corotated, int sweeps,
                       void* stream) {
  auto* kernel = posT_rows != nullptr ? mid_records_kernel<T, true>
                                      : mid_records_kernel<T, false>;
  kernel<<<blocks_for(n_sr), MID_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ayT, ld_ay, (const T*)posT_rows, ld_pos, (const T*)rs6T, ld_rs6,
      (const T*)mu, (const T*)lam, (const T*)vol, (const T*)rcT, ld_rc, (const T*)scale,
      (T*)fmT, ld_fm, (T*)srT, ld_sr, m, n_sr, corotated, sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mid_records_bwd(const void* ayT, int64_t ld_ay, const void* posT_rows,
                           int64_t ld_pos, const void* rs6T, int64_t ld_rs6,
                           const void* mu, const void* lam, const void* rcT,
                           int64_t ld_rc, const void* scale, const void* dfmT,
                           int64_t ld_dfm, const void* dsrT, int64_t ld_dsr, void* dayT,
                           int64_t ld_day, void* dscale, void* dposT, int64_t ld_dpos,
                           int64_t m, int corotated, int sweeps, void* stream) {
  auto* kernel = posT_rows != nullptr ? mid_records_bwd_kernel<T, true>
                                      : mid_records_bwd_kernel<T, false>;
  kernel<<<blocks_for(m), MID_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ayT, ld_ay, (const T*)posT_rows, ld_pos, (const T*)rs6T, ld_rs6,
      (const T*)mu, (const T*)lam, (const T*)rcT, ld_rc, (const T*)scale,
      (const T*)dfmT, ld_dfm, (const T*)dsrT, ld_dsr, (T*)dayT, ld_day, (T*)dscale,
      (T*)dposT, ld_dpos, m, corotated, sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

#define SB_MID_ENTRIES(SUF, T)                                                 \
  int sb_mid_records_##SUF(                                                    \
      const void* ayT, int64_t ld_ay, const void* posT_rows, int64_t ld_pos,   \
      const void* rs6T, int64_t ld_rs6, const void* mu, const void* lam,       \
      const void* vol, const void* rcT, int64_t ld_rc, const void* scale,      \
      void* fmT, int64_t ld_fm, void* srT, int64_t ld_sr, int64_t m,           \
      int64_t n_sr, int corotated, int sweeps, void* stream) {                 \
    return launch_mid_records<T>(ayT, ld_ay, posT_rows, ld_pos, rs6T, ld_rs6,  \
                                 mu, lam, vol, rcT, ld_rc, scale, fmT, ld_fm,  \
                                 srT, ld_sr, m, n_sr, corotated, sweeps,       \
                                 stream);                                      \
  }                                                                            \
  int sb_mid_records_bwd_##SUF(                                                \
      const void* ayT, int64_t ld_ay, const void* posT_rows, int64_t ld_pos,   \
      const void* rs6T, int64_t ld_rs6, const void* mu, const void* lam,       \
      const void* rcT, int64_t ld_rc, const void* scale, const void* dfmT,     \
      int64_t ld_dfm, const void* dsrT, int64_t ld_dsr, void* dayT,            \
      int64_t ld_day, void* dscale, void* dposT, int64_t ld_dpos, int64_t m,   \
      int corotated, int sweeps, void* stream) {                               \
    return launch_mid_records_bwd<T>(ayT, ld_ay, posT_rows, ld_pos, rs6T,      \
                                     ld_rs6, mu, lam, rcT, ld_rc, scale, dfmT, \
                                     ld_dfm, dsrT, ld_dsr, dayT, ld_day,       \
                                     dscale, dposT, ld_dpos, m, corotated,     \
                                     sweeps, stream);                          \
  }

SB_MID_ENTRIES(f32, float)
SB_MID_ENTRIES(f64, double)

}  // extern "C"
