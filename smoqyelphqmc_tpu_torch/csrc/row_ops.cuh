// Site-row operators shared by kernels K1 (mtm.cu) and K2 (pcg.cu).
//
// One CTA works on one (system, tau) row of N sites held in shared memory. A
// checkerboard color is u <- C_c u + S_c u[partner_c]: a gather by the
// partner table, which needs the whole row, so colors are separated by
// __syncthreads() and written ping-pong between two row buffers. The C/S
// tables carry a tau-row stride: 0 when the hoppings do not depend on tau
// (one compressed row), N otherwise.
#pragma once

#include <cuda_runtime.h>

namespace smoqy {

constexpr int kThreads = 256;  // every kernel of the port runs 256-thread CTAs

template <typename T>
struct CbTables {
  const T* C;          // (n_colors, rows, N)
  const T* S;          // (n_colors, rows, N)
  const int* partner;  // (n_colors, N)
  const T* expV;       // (Ltau, N) exp(-dtau V)
  int N;
  int Ltau;
  int n_colors;
  int tau_stride;    // 0 (rows == 1) or N (rows == Ltau)
  int color_stride;  // rows * N
  int symmetric;     // 1: B = CB^T D CB; 0: B = D CB, B^T = CB^T D
};

template <typename T>
__device__ __forceinline__ T* other_buf(T* r, T* a, T* b) {
  return r == a ? b : a;
}

// All colors in order (reverse = transpose); returns the buffer with the result.
template <typename T>
__device__ T* cb_sweep(const CbTables<T>& tb, int l, T* u, T* t, bool reverse) {
  for (int i = 0; i < tb.n_colors; ++i) {
    const int c = reverse ? tb.n_colors - 1 - i : i;
    const size_t off = (size_t)c * tb.color_stride + (size_t)l * tb.tau_stride;
    const T* Cc = tb.C + off;
    const T* Sc = tb.S + off;
    const int* pc = tb.partner + (size_t)c * tb.N;
    for (int n = threadIdx.x; n < tb.N; n += blockDim.x) {
      t[n] = Cc[n] * u[n] + Sc[n] * u[pc[n]];
    }
    __syncthreads();
    T* s = u;
    u = t;
    t = s;
  }
  return u;
}

template <typename T>
__device__ void scale_expV(const CbTables<T>& tb, int l, T* u) {
  const T* e = tb.expV + (size_t)l * tb.N;
  for (int n = threadIdx.x; n < tb.N; n += blockDim.x) u[n] = e[n] * u[n];
  __syncthreads();
}

// B_l u; u must be complete in shared memory (synchronised) on entry.
template <typename T>
__device__ T* apply_B(const CbTables<T>& tb, int l, T* u, T* t) {
  if (tb.symmetric) {
    T* r = cb_sweep(tb, l, u, t, true);
    scale_expV(tb, l, r);
    return cb_sweep(tb, l, r, other_buf(r, u, t), false);
  }
  T* r = cb_sweep(tb, l, u, t, false);
  scale_expV(tb, l, r);
  return r;
}

// B_l^T u.
template <typename T>
__device__ T* apply_Bt(const CbTables<T>& tb, int l, T* u, T* t) {
  if (tb.symmetric) return apply_B(tb, l, u, t);
  scale_expV(tb, l, u);
  return cb_sweep(tb, l, u, t, true);
}

// Row l of M^T M v for one system v (Ltau, N):
//   m_l = v_l + sgn1_l B_l v_{l-1},  out_l = m_l + sgnL_l B_{l+1}^T m_{l+1},
// with sgn1 = +1 at row 0 and sgnL = +1 at row Ltau-1 (-1 elsewhere). m_{l+1}
// is recomputed here (three B applications per row) instead of a second pass
// over a stored m: one launch, no scratch plane, and the row's inputs
// v_{l-1}, v_l, v_{l+1} are all the global reads. A, X, Y are three N-row
// shared buffers. Returns this thread's share of dot(w, out_l) when w != null.
template <typename T>
__device__ T mtm_row(const CbTables<T>& tb, const T* v, T* out, int l, T* A, T* X, T* Y,
                     const T* w) {
  const int N = tb.N, L = tb.Ltau;
  const int lm = (l + L - 1) % L;
  const int lp = (l + 1) % L;
  const T s1_l = (l == 0) ? T(1) : T(-1);
  const T s1_lp = (lp == 0) ? T(1) : T(-1);
  const T sL_l = (l == L - 1) ? T(1) : T(-1);

  for (int n = threadIdx.x; n < N; n += blockDim.x) X[n] = v[(size_t)lm * N + n];
  __syncthreads();
  T* r = apply_B(tb, l, X, Y);
  for (int n = threadIdx.x; n < N; n += blockDim.x) A[n] = v[(size_t)l * N + n] + s1_l * r[n];
  __syncthreads();

  for (int n = threadIdx.x; n < N; n += blockDim.x) X[n] = v[(size_t)l * N + n];
  __syncthreads();
  r = apply_B(tb, lp, X, Y);
  for (int n = threadIdx.x; n < N; n += blockDim.x) r[n] = v[(size_t)lp * N + n] + s1_lp * r[n];
  __syncthreads();
  r = apply_Bt(tb, lp, r, other_buf(r, X, Y));

  T acc = T(0);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T o = A[n] + sL_l * r[n];
    out[n] = o;
    if (w != nullptr) acc += w[n] * o;
  }
  __syncthreads();
  return acc;
}

// Sum over the CTA (blockDim.x a multiple of 32, at most 1024); the result is
// valid in thread 0. red holds blockDim.x / 32 doubles.
__device__ inline double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x / 32)) ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

}  // namespace smoqy
