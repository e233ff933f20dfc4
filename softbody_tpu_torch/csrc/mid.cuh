// The fused path's per-row mid-section, one thread per row, on register
// arrays: the Jacobi polar R = U V^T of A (the sweep order and branch
// rules of ops/mat3.py :: _eigh3_components / _svd3_components, line by
// line), F = I + (R^T Y - rc)^T (Y - rc with corotated off), the StVK
// stress S = (2 mu E + lam tr E I) scale and M = R F S (sim/blocked.py ::
// mid_rows).  The epilogue of pair_kernels.cu's moments_mid_kernel.

#pragma once

#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ T sqrt_t(T x);
template <> __device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double sqrt_t<double>(double x) { return sqrt(x); }
template <typename T> __device__ __forceinline__ T abs_t(T x) { return x < T(0) ? -x : x; }
template <typename T> __device__ __forceinline__ T sign_t(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

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

}  // namespace
