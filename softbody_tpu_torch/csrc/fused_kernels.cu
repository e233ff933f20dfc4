// The raw K1 of the blocked layout, hand-written for Hopper (sm_90a):
//
// moments_raw_kernel  :: _moments_kernel (softbody_tpu/ops/pallas/
//                        pair_kernels.py :: _moments_fwd_impl, from
//                        ops/pallas/packed.py :: moments_packed: the blocked
//                        layout's K1) and the inner kernel of
//                        _moments_fwd_manual, the same function with the
//                        slab staged by manual double-buffered DMA (TPU
//                        only); its Hopper form, cp.async / TMA double
//                        buffering of the slab, is a tuning item
//
// The fused path's kernels (moments_mid, K2 v2 and their backwards), the
// raw K1's backward moments_raw_bwd and the blocked layout's
// Taichi-pairing K2 (forces_sep and its backward) are whole-scene kernels
// of pair_kernels.cu.
//
// What it computes (tile of ROWS = 32 rows against its candidate slab,
// slot = gidx[tile, e / group] * group + e % group; lane-major operands):
// the sums of lhs = [-w m_j dx ; gfac V_j dx] against the ABSOLUTE
// positions pos_j, one block per tile (common.cuh's k1_tile_sums).
//
// Bound on an H100 SXM (67 TFLOP/s FP32, 3.35 TB/s): OPERATION-bound, as
// the v4 kernels: 72 flops per pair, each slab entry staged once serving
// 32 rows (chip_smoke.py computes the bound from the run's shapes).
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() of its launch.  The kernel launches on the caller's
// stream and allocates nothing.

#include "common.cuh"

namespace {

// moments_raw_kernel: K1's tile sums against the ABSOLUTE positions (the
// shift c = 0): row 3 blk + a of ayT is sum_j lhs_blk pos_j[a], the raw,
// uncentered dots of _moments_kernel.  The caller subtracts
// pos_i[a] rs6[blk] with rs6 from this same kernel on an all-ones RHS (the
// blocked scene's build), so the correction cancels against sums of the
// same f32 coefficients; centering here would change the output that the
// build and the SPMD shards read raw.
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
  k1_tile_sums(restT_rows + (int64_t)tile * 3 * ROWS, static_slab + (int64_t)tile * 5 * slab,
               posT, ld_pos, gidx + (int64_t)tile * (slab / group), slab, group, inv_h, c4,
               c4h, ent, red);
  for (int o = threadIdx.x; o < 18 * ROWS; o += THREADS) {
    const int r = o % ROWS, row = o / ROWS;
    T dot = T(0);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) dot += red[w][row][r];
    ayT[row * ld_out + (int64_t)tile * ROWS + r] = dot;
  }
}

}  // namespace

extern "C" {

int sb_rows() { return ROWS; }

#define SB_RAW_ENTRIES(SUF, T)                                                 \
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
  }

SB_RAW_ENTRIES(f32, float)
SB_RAW_ENTRIES(f64, double)

}  // extern "C"
