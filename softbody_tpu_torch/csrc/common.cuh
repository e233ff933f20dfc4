// What the pair-kernel sources share (pair_kernels.cu, the whole-scene
// kernels; fused_kernels.cu, the raw K1): the tile geometry, the
// cubic-spline pair coefficients, and the raw K1's per-tile loop; and the
// packed records' vector loads and stores (gather_kernels.cu,
// mid_kernels.cu).
//
// The per-bucket kernel (fused_kernels.cu) runs one block per tile of ROWS
// slot rows, one lane per row, NWARPS warps splitting the tile's candidate
// slab (slot = gidx[e / group] * group + e % group); each pass stages
// CHUNK slab entries in shared memory, one
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

// W values of a packed row-major record at p (16-byte aligned), moved with
// W * sizeof(T) / 16 vector loads or stores (float4, or double2 in f64).
__device__ __forceinline__ void unpack(const float4& x, float* y) {
  y[0] = x.x; y[1] = x.y; y[2] = x.z; y[3] = x.w;
}
__device__ __forceinline__ void unpack(const double2& x, double* y) {
  y[0] = x.x; y[1] = x.y;
}
__device__ __forceinline__ float4 pack(const float* y) {
  return make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ double2 pack(const double* y) { return make_double2(y[0], y[1]); }

template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&v)[W]) {
  using V = decltype(pack((const T*)nullptr));
  constexpr int PER = 16 / sizeof(T);
  static_assert(W % PER == 0, "a record is whole 16-byte pieces");
#pragma unroll
  for (int k = 0; k < W / PER; ++k) unpack(__ldg(reinterpret_cast<const V*>(p) + k), v + PER * k);
}

template <typename T, int W>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&v)[W]) {
  using V = decltype(pack((const T*)nullptr));
  constexpr int PER = 16 / sizeof(T);
  static_assert(W % PER == 0, "a record is whole 16-byte pieces");
#pragma unroll
  for (int k = 0; k < W / PER; ++k) reinterpret_cast<V*>(p)[k] = pack(v + PER * k);
}

// K1 slab entry: rest_3, mass, volume, pos (8 values).
template <typename T> struct alignas(16) K1Entry { T v[8]; };

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

// ------------------------------------------------------------ forward sums
// The raw K1's tile sums: red[w][3 k + a][lane] holds warp w's share of
// sum_j pos_j[a] L_k for row `lane`, with L = [-w m_j dx ; gfac V_j dx]
// (72 flops per pair).  rr (3, ROWS), st (5, slab) and gi are the tile's
// own.  Ends with a block barrier.
template <typename T>
__device__ __forceinline__ void k1_tile_sums(
    const T* __restrict__ rr, const T* __restrict__ st,
    const T* __restrict__ posT, int64_t ld_pos, const int32_t* __restrict__ gi,
    int slab, int group, T inv_h, T c4, T c4h, K1Entry<T>* ent, T (*red)[18][ROWS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T xi0 = rr[lane], xi1 = rr[ROWS + lane], xi2 = rr[2 * ROWS + lane];
  T acc[6][3];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[k][a] = T(0);

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
      x.v[5] = posT[slot];
      x.v[6] = posT[ld_pos + slot];
      x.v[7] = posT[2 * ld_pos + slot];
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
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int a = 0; a < 3; ++a) red[warp][3 * k + a][lane] = acc[k][a];
  __syncthreads();
}

}  // namespace
