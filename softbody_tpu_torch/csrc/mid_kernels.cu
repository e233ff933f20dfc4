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
// mid_records_ring_kernel, mid_records_bwd_ring_kernel
//                         the same functions, bit for bit, in persistent
//                         blocks with a cp.async ring: the design measured
//                         against the two above and not put on any path
//                         (below)
//
// What they compute, one thread per row, nothing shared between rows
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
// What bounds them on an H100 SXM (3.35 TB/s, 132 SMs of 4 schedulers):
// not the bytes.  The forward moves 65 values per row (31 read, 34
// written), the backward 82 (63 read, 19 written): 9.4 / 11.8 us at
// m = 120,832 in f32 (chip_smoke.py computes that bound from the run's
// shapes; the raw-dot correction adds 9 values read, and 3 written
// backward).  Their ~2,090 / ~2,690 flops per row would take 4 / 5 us at
// the FP32 peak, which counts fused multiply-adds; this file rounds every
// operation on its own (below), and every division and square root is an
// IEEE sequence of several instructions with a slow-path branch (a row
// runs 24 Jacobi rotations of 2 divisions, a reciprocal and 2 square roots
// each).  So a row is ~4,700 / ~5,500 SASS instructions, an issue floor
// (instructions x rows / 32 / (132 x 4) / clock; pair_times.py counts them
// and gives it) of ~17 / ~20 us at 1.98 GHz, above half the bytes bound,
// and the kernels take ~1.7 / ~2.2 times that: a warp's chain of dependent
// divisions and square roots leaves its scheduler idle unless other warps'
// rows are in flight.
//
// What the design does about it: one thread per row, a block of
// MID_THREADS rows, every block launched at once, so that each SM holds
// as many rows as its registers allow (the forward at 64 registers: 8
// blocks, the ~112k scene's ~915 rows per SM in one round; the backward at
// 128 registers: 4 blocks, 1.79 rounds, the second round's blocks starting
// as the first round's finish) and overlaps their chains.  Operands are
// lane-major (a warp's load or store of one field is 32 consecutive
// values), read once straight into registers, and the row's whole chain
// stays in registers, so no intermediate touches memory.  The Givens step
// computes sign / x as sign * (1 / x) (mid.cuh): the same values, a
// shorter chain.
//
// The ring kernels are the persistent design: (SMs x resident blocks)
// blocks, each walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of MID_THREADS rows; each thread copies its next row's operands field by
// field into its own slots of a shared-memory ring with cp.async (4 or 8
// bytes a copy: any row stride and base; a thread reads back only what it
// copied, so no barrier), while its current row computes, and reads them
// from there where the chain needs them; a ring of 2 stages where a block
// walks more than one tile, else 1 (ring_plan).  They give the one-wave
// kernels' outputs bit for bit, and on the H100 they are no faster where
// every block takes one tile and slower wherever blocks walk several
// (PERF.md §6): at the port's row counts an SM holds all its rows at once
// (or, backward, in two rounds that the block scheduler already overlaps),
// so walking tiles only leaves fewer rows in flight per round to hide a
// row's chain, and the ring's shared memory costs resident blocks.  They
// are kept as that measurement's reference, on no path.

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

// A row's operands: field f of a lane-major operand at p[f * ld + src],
// a vector's at p[src].  In global memory src is the row's column; in a
// ring stage p points at the thread's own slot, ld is MID_THREADS and src
// 0.  vol is read forward only, dfmT (rows 0-17) and dsrT backward only,
// posT_rows and rs6T with the raw-dot correction only.
template <typename T>
struct Rows {
  const T *ayT, *rcT, *posT_rows, *rs6T, *dfmT, *dsrT;
  int64_t ld_ay, ld_rc, ld_pos, ld_rs6, ld_dfm, ld_dsr;
  const T *mu, *lam, *vol, *scale;
};

template <typename T>
struct FwdOut {
  T* fmT;     // (19, ld_fm)
  T* srT;     // (15, ld_sr)
  int64_t ld_fm, ld_sr;
};

template <typename T>
struct BwdOut {
  T* dayT;    // (18, ld_day)
  T* dscale;  // (m,)
  T* dposT;   // (3, ld_dpos), with the correction
  int64_t ld_day, ld_dpos;
};

// Row A and Y (row 3b+a of ayT is [a][b]); with CORR, minus pos_i[a]
// rs6[b] (rs6[3 + b] for Y), p and rs6 returned for the backward.
template <typename T, bool CORR>
__device__ __forceinline__ void load_ay(const Rows<T>& o, int64_t src, T (&A)[3][3],
                                        T (&Y)[3][3], T (&p)[3], T (&rs)[6]) {
  if constexpr (CORR) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = o.posT_rows[a * o.ld_pos + src];
#pragma unroll
    for (int k = 0; k < 6; ++k) rs[k] = o.rs6T[k * o.ld_rs6 + src];
  }
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T va = o.ayT[(3 * b + a) * o.ld_ay + src];
      T vy = o.ayT[(9 + 3 * b + a) * o.ld_ay + src];
      if constexpr (CORR) {
        va = va - p[a] * rs[b];
        vy = vy - p[a] * rs[3 + b];
      }
      A[a][b] = va;
      Y[a][b] = vy;
    }
}

// rc[a][b] at row 3a+b of rcT
template <typename T>
__device__ __forceinline__ void load_rc(const Rows<T>& o, int64_t src, T (&rc)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rc[i][j] = o.rcT[(3 * i + j) * o.ld_rc + src];
}

// The forward of one row: its operands at src, its records at column col.
template <typename T, bool CORR>
__device__ __forceinline__ void fwd_row(const Rows<T>& o, int64_t src, const FwdOut<T>& out,
                                        int64_t col, bool corotated, int sweeps) {
  T A[3][3], Y[3][3], p[3], rs[6], rc[3][3];
  load_ay<T, CORR>(o, src, A, Y, p, rs);
  load_rc(o, src, rc);
  T R[3][3], F[3][3], S[3][3], M[3][3];
  mid_row(A, Y, rc, o.mu[src], o.lam[src], o.scale[src], corotated, sweeps, R, F, S, M);
  T* const fmT = out.fmT;
  T* const srT = out.srT;
  const int64_t ld_fm = out.ld_fm, ld_sr = out.ld_sr;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fmT[(3 * i + j) * ld_fm + col] = F[i][j];
      fmT[(9 + 3 * i + j) * ld_fm + col] = M[i][j];
      srT[(6 + 3 * j + i) * ld_sr + col] = R[i][j];   // R^T_9: [3c + a] = R[a][c]
    }
  fmT[18 * ld_fm + col] = o.vol[src];
  srT[0 * ld_sr + col] = S[0][0];
  srT[1 * ld_sr + col] = S[0][1];
  srT[2 * ld_sr + col] = S[0][2];
  srT[3 * ld_sr + col] = S[1][1];
  srT[4 * ld_sr + col] = S[1][2];
  srT[5 * ld_sr + col] = S[2][2];
}

// The backward of one row: its operands at src, its cotangents at col.
template <typename T, bool CORR>
__device__ __forceinline__ void bwd_row(const Rows<T>& o, int64_t src, const BwdOut<T>& out,
                                        int64_t col, bool corotated, int sweeps) {
  T A[3][3], Y[3][3], p[3], rs[6], rc[3][3];
  load_ay<T, CORR>(o, src, A, Y, p, rs);
  load_rc(o, src, rc);
  T dF[3][3], dM[3][3], dR[3][3], dS6[6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dF[i][j] = o.dfmT[(3 * i + j) * o.ld_dfm + src];
      dM[i][j] = o.dfmT[(9 + 3 * i + j) * o.ld_dfm + src];
      dR[i][j] = o.dsrT[(6 + 3 * j + i) * o.ld_dsr + src];
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) dS6[k] = o.dsrT[k * o.ld_dsr + src];
  T dA[3][3], dY[3][3], ds;
  mid_row_bwd(A, Y, rc, o.mu[src], o.lam[src], o.scale[src], corotated, sweeps, dF, dM,
              dS6, dR, dA, dY, ds);
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      out.dayT[(3 * b + a) * out.ld_day + col] = dA[a][b];
      out.dayT[(9 + 3 * b + a) * out.ld_day + col] = dY[a][b];
    }
  out.dscale[col] = ds;
  if constexpr (CORR) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc += dA[a][b] * rs[b] + dY[a][b] * rs[3 + b];
      out.dposT[a * out.ld_dpos + col] = -acc;
    }
  }
}

// The kernels' own operands (restrict-qualified: read-only, no aliasing)
// as Rows, read at the row's own column.
#define MID_FWD_PARAMS                                                          \
  const T* __restrict__ ayT, int64_t ld_ay,          /* (18, ld_ay) */          \
      const T* __restrict__ posT_rows, int64_t ld_pos, /* (3, ld_pos), CORR */  \
      const T* __restrict__ rs6T, int64_t ld_rs6,      /* (6, ld_rs6), CORR */  \
      const T* __restrict__ mu, const T* __restrict__ lam,                     \
      const T* __restrict__ vol,                       /* (m,) each */         \
      const T* __restrict__ rcT, int64_t ld_rc,        /* (9, ld_rc) */         \
      const T* __restrict__ scale,                     /* (m,) */              \
      T* __restrict__ fmT, int64_t ld_fm,              /* (19, ld_fm) */        \
      T* __restrict__ srT, int64_t ld_sr,              /* (15, ld_sr) */        \
      int64_t m, int64_t n_sr, int corotated, int sweeps
#define MID_FWD_ROWS                                                            \
  Rows<T>{ayT, rcT, posT_rows, rs6T, nullptr, nullptr, ld_ay, ld_rc, ld_pos,    \
          ld_rs6, 0, 0, mu, lam, vol, scale}
#define MID_BWD_PARAMS                                                          \
  const T* __restrict__ ayT, int64_t ld_ay, const T* __restrict__ posT_rows,    \
      int64_t ld_pos, const T* __restrict__ rs6T, int64_t ld_rs6,              \
      const T* __restrict__ mu, const T* __restrict__ lam,                     \
      const T* __restrict__ rcT, int64_t ld_rc, const T* __restrict__ scale,   \
      const T* __restrict__ dfmT, int64_t ld_dfm, /* (19, ld_dfm): row 18 unread */ \
      const T* __restrict__ dsrT, int64_t ld_dsr, /* (15, ld_dsr) */             \
      T* __restrict__ dayT, int64_t ld_day,       /* (18, ld_day) */             \
      T* __restrict__ dscale,                     /* (m,) */                    \
      T* __restrict__ dposT, int64_t ld_dpos,     /* (3, ld_dpos), CORR */       \
      int64_t m, int corotated, int sweeps
#define MID_BWD_ROWS                                                            \
  Rows<T>{ayT, rcT, posT_rows, rs6T, dfmT, dsrT, ld_ay, ld_rc, ld_pos, ld_rs6,  \
          ld_dfm, ld_dsr, mu, lam, nullptr, scale}

// ------------------------------------------------------------ one wave
template <typename T, bool CORR>
__global__ void __launch_bounds__(MID_THREADS) mid_records_kernel(MID_FWD_PARAMS) {
  const int64_t col = (int64_t)blockIdx.x * MID_THREADS + threadIdx.x;
  if (col >= n_sr) return;
  if (col >= m) {                 // a slot past the tile rows: its record is zero
#pragma unroll
    for (int k = 0; k < 15; ++k) srT[k * ld_sr + col] = T(0);
    return;
  }
  fwd_row<T, CORR>(MID_FWD_ROWS, col, FwdOut<T>{fmT, srT, ld_fm, ld_sr}, col,
                   corotated != 0, sweeps);
}

template <typename T, bool CORR>
__global__ void __launch_bounds__(MID_THREADS) mid_records_bwd_kernel(MID_BWD_PARAMS) {
  const int64_t col = (int64_t)blockIdx.x * MID_THREADS + threadIdx.x;
  if (col >= m) return;
  bwd_row<T, CORR>(MID_BWD_ROWS, col, BwdOut<T>{dayT, dscale, dposT, ld_day, ld_dpos},
                   col, corotated != 0, sweeps);
}

// ------------------------------------------------------------ the ring
// A stage holds each staged field's MID_THREADS values (thread t's at t):
// forward ayT 18, rcT 9, mu, lam, vol, scale; backward ayT 18, rcT 9, mu,
// lam, scale, dfmT 18, dsrT 15; the correction adds posT_rows 3, rs6T 6.
template <bool BWD, bool CORR>
constexpr int RING_FIELDS = (BWD ? 63 : 31) + (CORR ? 9 : 0);

// sizeof(T) bytes global -> shared, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The view of a stage at `slot` (the thread's slot of its first field) as
// Rows; with `copy`, first issue the copies of global column col's fields
// into it.
template <typename T, bool BWD, bool CORR>
__device__ __forceinline__ Rows<T> stage_row(const Rows<T>& g, int64_t col, T* slot,
                                             bool copy) {
  constexpr int64_t L = MID_THREADS;
  Rows<T> s{};
  s.ld_ay = s.ld_rc = s.ld_pos = s.ld_rs6 = s.ld_dfm = s.ld_dsr = L;
  T* q = slot;
  auto take = [&](const T* src, int64_t ld, int fields) {
    if (copy)
      for (int f = 0; f < fields; ++f) cp_async(q + f * L, src + f * ld + col);
    const T* at = q;
    q += fields * L;
    return at;
  };
  s.ayT = take(g.ayT, g.ld_ay, 18);
  s.rcT = take(g.rcT, g.ld_rc, 9);
  s.mu = take(g.mu, 0, 1);
  s.lam = take(g.lam, 0, 1);
  if constexpr (!BWD) s.vol = take(g.vol, 0, 1);
  s.scale = take(g.scale, 0, 1);
  if constexpr (BWD) {
    s.dfmT = take(g.dfmT, g.ld_dfm, 18);
    s.dsrT = take(g.dsrT, g.ld_dsr, 15);
  }
  if constexpr (CORR) {
    s.posT_rows = take(g.posT_rows, g.ld_pos, 3);
    s.rs6T = take(g.rs6T, g.ld_rs6, 6);
  }
  return s;
}

// Walk this block's tiles blockIdx.x + k gridDim.x, each thread its row of
// each, running body(rows in the stage, col) on rows < m; with 2 stages
// the next tile's copies are in flight while the current tile computes.
template <typename T, bool BWD, bool CORR, int STAGES, typename Body>
__device__ __forceinline__ void walk_ring(const Rows<T>& g, int64_t m, Body body) {
  constexpr int NF = RING_FIELDS<BWD, CORR>;
  extern __shared__ __align__(16) unsigned char mid_smem[];
  T* const slot = reinterpret_cast<T*>(mid_smem) + threadIdx.x;
  const int64_t tiles = (m + MID_THREADS - 1) / MID_THREADS;
  auto fetch = [&](int64_t tile, int stage) {   // one copy group a tile
    const int64_t col = tile * MID_THREADS + threadIdx.x;
    if (tile < tiles && col < m)
      stage_row<T, BWD, CORR>(g, col, slot + stage * NF * MID_THREADS, true);
    cp_async_commit();
  };
  fetch(blockIdx.x, 0);
  int k = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int stage = STAGES == 1 ? 0 : (k & 1);
    if constexpr (STAGES == 2) {
      fetch(tile + gridDim.x, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int64_t col = tile * MID_THREADS + threadIdx.x;
    if (col < m)
      body(stage_row<T, BWD, CORR>(g, col, slot + stage * NF * MID_THREADS, false), col);
    if constexpr (STAGES == 1) fetch(tile + gridDim.x, 0);
  }
}

// The f32 forward held to 64 registers, as the one-wave kernel compiles:
// 8 blocks of MID_THREADS rows per SM, the ~112k scene's rows in one round.
template <typename T, bool CORR, int STAGES>
__global__ void __launch_bounds__(MID_THREADS, sizeof(T) == 4 ? 8 : 1)
mid_records_ring_kernel(MID_FWD_PARAMS) {
  // srT's padding columns [m, n_sr), grid-stride
  for (int64_t c = m + (int64_t)blockIdx.x * MID_THREADS + threadIdx.x; c < n_sr;
       c += (int64_t)gridDim.x * MID_THREADS)
#pragma unroll
    for (int k = 0; k < 15; ++k) srT[k * ld_sr + c] = T(0);
  const FwdOut<T> out{fmT, srT, ld_fm, ld_sr};
  walk_ring<T, false, CORR, STAGES>(MID_FWD_ROWS, m, [&](const Rows<T>& s, int64_t col) {
    fwd_row<T, CORR>(s, 0, out, col, corotated != 0, sweeps);
  });
}

template <typename T, bool CORR, int STAGES>
__global__ void __launch_bounds__(MID_THREADS) mid_records_bwd_ring_kernel(MID_BWD_PARAMS) {
  const BwdOut<T> out{dayT, dscale, dposT, ld_day, ld_dpos};
  walk_ring<T, true, CORR, STAGES>(MID_BWD_ROWS, m, [&](const Rows<T>& s, int64_t col) {
    bwd_row<T, CORR>(s, 0, out, col, corotated != 0, sweeps);
  });
}

template <typename T, bool BWD, bool CORR, int STAGES>
const void* ring_kernel() {
  if constexpr (BWD) return (const void*)mid_records_bwd_ring_kernel<T, CORR, STAGES>;
  else return (const void*)mid_records_ring_kernel<T, CORR, STAGES>;
}

// A ring launch: grid, stages, dynamic shared memory bytes a block, resident
// blocks per SM at that memory.  The grid is every SM's resident blocks
// (at most one block a tile, at least one); 1 stage where that is a block
// for every tile (nothing to fetch ahead), else 2.
struct RingPlan {
  int grid, stages, smem, resident;
};

template <typename T, bool BWD, bool CORR>
int ring_plan(int64_t m, RingPlan& p) {
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  const int64_t tiles = (m + MID_THREADS - 1) / MID_THREADS;
  for (int stages = 1; stages <= 2; ++stages) {
    const void* kernel = stages == 1 ? ring_kernel<T, BWD, CORR, 1>()
                                     : ring_kernel<T, BWD, CORR, 2>();
    const int smem = stages * RING_FIELDS<BWD, CORR> * MID_THREADS * (int)sizeof(T);
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return (int)e;
    int resident = 0;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, kernel, MID_THREADS, smem))
      return (int)e;
    const int64_t slots = (int64_t)sms * resident;
    p = {(int)(tiles < slots ? (tiles > 0 ? tiles : 1) : slots), stages, smem, resident};
    if (tiles <= p.grid) break;
  }
  return 0;
}

int blocks_for(int64_t n) { return (int)((n + MID_THREADS - 1) / MID_THREADS); }

// registers, local bytes (stack and spills), static shared memory per
// block, threads per block and resident blocks per SM of one one-wave
// instantiation (which: 0 forward, 1 with the correction, 2 backward, 3
// with it)
template <typename T>
int mid_info(int which, int* out) {
  const void* kernel = which == 0   ? (const void*)mid_records_kernel<T, false>
                       : which == 1 ? (const void*)mid_records_kernel<T, true>
                       : which == 2 ? (const void*)mid_records_bwd_kernel<T, false>
                                    : (const void*)mid_records_bwd_kernel<T, true>;
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, kernel)) return (int)e;
  int blocks = 0;
  if (cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, MID_THREADS, 0))
    return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = MID_THREADS;
  out[4] = blocks;
  return 0;
}

template <typename T>
int launch_mid_records(const void* ayT, int64_t ld_ay, const void* posT_rows,
                       int64_t ld_pos, const void* rs6T, int64_t ld_rs6, const void* mu,
                       const void* lam, const void* vol, const void* rcT, int64_t ld_rc,
                       const void* scale, void* fmT, int64_t ld_fm, void* srT,
                       int64_t ld_sr, int64_t m, int64_t n_sr, int corotated, int sweeps,
                       bool ring, void* stream) {
  const bool corr = posT_rows != nullptr;
  if (!ring) {
    auto* kernel = corr ? mid_records_kernel<T, true> : mid_records_kernel<T, false>;
    kernel<<<blocks_for(n_sr), MID_THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)ayT, ld_ay, (const T*)posT_rows, ld_pos, (const T*)rs6T, ld_rs6,
        (const T*)mu, (const T*)lam, (const T*)vol, (const T*)rcT, ld_rc, (const T*)scale,
        (T*)fmT, ld_fm, (T*)srT, ld_sr, m, n_sr, corotated, sweeps);
    return (int)cudaGetLastError();
  }
  RingPlan p;
  if (int e = corr ? ring_plan<T, false, true>(m, p) : ring_plan<T, false, false>(m, p))
    return e;
  auto* kernel = corr ? (p.stages == 2 ? mid_records_ring_kernel<T, true, 2>
                                       : mid_records_ring_kernel<T, true, 1>)
                      : (p.stages == 2 ? mid_records_ring_kernel<T, false, 2>
                                       : mid_records_ring_kernel<T, false, 1>);
  kernel<<<p.grid, MID_THREADS, p.smem, (cudaStream_t)stream>>>(
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
                           int64_t m, int corotated, int sweeps, bool ring, void* stream) {
  const bool corr = posT_rows != nullptr;
  if (!ring) {
    auto* kernel = corr ? mid_records_bwd_kernel<T, true> : mid_records_bwd_kernel<T, false>;
    kernel<<<blocks_for(m), MID_THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)ayT, ld_ay, (const T*)posT_rows, ld_pos, (const T*)rs6T, ld_rs6,
        (const T*)mu, (const T*)lam, (const T*)rcT, ld_rc, (const T*)scale,
        (const T*)dfmT, ld_dfm, (const T*)dsrT, ld_dsr, (T*)dayT, ld_day, (T*)dscale,
        (T*)dposT, ld_dpos, m, corotated, sweeps);
    return (int)cudaGetLastError();
  }
  RingPlan p;
  if (int e = corr ? ring_plan<T, true, true>(m, p) : ring_plan<T, true, false>(m, p))
    return e;
  auto* kernel = corr ? (p.stages == 2 ? mid_records_bwd_ring_kernel<T, true, 2>
                                       : mid_records_bwd_ring_kernel<T, true, 1>)
                      : (p.stages == 2 ? mid_records_bwd_ring_kernel<T, false, 2>
                                       : mid_records_bwd_ring_kernel<T, false, 1>);
  kernel<<<p.grid, MID_THREADS, p.smem, (cudaStream_t)stream>>>(
      (const T*)ayT, ld_ay, (const T*)posT_rows, ld_pos, (const T*)rs6T, ld_rs6,
      (const T*)mu, (const T*)lam, (const T*)rcT, ld_rc, (const T*)scale,
      (const T*)dfmT, ld_dfm, (const T*)dsrT, ld_dsr, (T*)dayT, ld_day, (T*)dscale,
      (T*)dposT, ld_dpos, m, corotated, sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int mid_ring_plan(int which, int64_t m, int* out) {
  RingPlan p;
  const int e = which == 0   ? ring_plan<T, false, false>(m, p)
                : which == 1 ? ring_plan<T, false, true>(m, p)
                : which == 2 ? ring_plan<T, true, false>(m, p)
                             : ring_plan<T, true, true>(m, p);
  if (e) return e;
  out[0] = p.grid;
  out[1] = p.stages;
  out[2] = p.smem;
  out[3] = p.resident;
  return 0;
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

// ``which``: 0 mid_records, 1 with the correction, 2 mid_records_bwd, 3 with
// the correction; ``mode``: 0 f32, 1 f64; out: 5 ints (mid_info)
int sb_mid_info(int which, int mode, int* out) {
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return mode ? mid_info<double>(which, out) : mid_info<float>(which, out);
}

// The ring kernels' launch at m rows (which and mode as sb_mid_info's);
// out: grid, stages, dynamic shared memory bytes, resident blocks per SM
int sb_mid_ring_plan(int which, int mode, int64_t m, int* out) {
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return mode ? mid_ring_plan<double>(which, m, out) : mid_ring_plan<float>(which, m, out);
}

// sb_mid_records[_ring]_<SUF> and sb_mid_records_bwd[_ring]_<SUF>
#define SB_MID_ENTRIES(NAME, SUF, T, RING)                                      \
  int sb_mid_records##NAME##SUF(                                               \
      const void* ayT, int64_t ld_ay, const void* posT_rows, int64_t ld_pos,   \
      const void* rs6T, int64_t ld_rs6, const void* mu, const void* lam,       \
      const void* vol, const void* rcT, int64_t ld_rc, const void* scale,      \
      void* fmT, int64_t ld_fm, void* srT, int64_t ld_sr, int64_t m,           \
      int64_t n_sr, int corotated, int sweeps, void* stream) {                 \
    return launch_mid_records<T>(ayT, ld_ay, posT_rows, ld_pos, rs6T, ld_rs6,  \
                                 mu, lam, vol, rcT, ld_rc, scale, fmT, ld_fm,  \
                                 srT, ld_sr, m, n_sr, corotated, sweeps, RING, \
                                 stream);                                      \
  }                                                                            \
  int sb_mid_records_bwd##NAME##SUF(                                           \
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
                                     sweeps, RING, stream);                    \
  }

SB_MID_ENTRIES(_, f32, float, false)
SB_MID_ENTRIES(_, f64, double, false)
SB_MID_ENTRIES(_ring_, f32, float, true)
SB_MID_ENTRIES(_ring_, f64, double, true)

}  // extern "C"
