// Site-row operators shared by kernels K2 (pcg.cu) and K3 (pcg_force.cu),
// and the asynchronous copies and row wrap that K1 and K4 use too.
//
// One CTA works on one (system, tau) row of N sites held in shared memory
// (mtm_rows_block: on a block of consecutive tau rows). A
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
// kNegS negates S: with reverse, that is the inverse CB^{-1} (each 2x2 hop
// block has unit determinant).
template <typename T, bool kNegS = false>
__device__ T* cb_sweep(const CbTables<T>& tb, int l, T* u, T* t, bool reverse) {
  for (int i = 0; i < tb.n_colors; ++i) {
    const int c = reverse ? tb.n_colors - 1 - i : i;
    const size_t off = (size_t)c * tb.color_stride + (size_t)l * tb.tau_stride;
    const T* Cc = tb.C + off;
    const T* Sc = tb.S + off;
    const int* pc = tb.partner + (size_t)c * tb.N;
    for (int n = threadIdx.x; n < tb.N; n += blockDim.x) {
      if (kNegS) {
        t[n] = Cc[n] * u[n] - Sc[n] * u[pc[n]];
      } else {
        t[n] = Cc[n] * u[n] + Sc[n] * u[pc[n]];
      }
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
// v(j, n) gives element n of row j (mtm_row_from; mtm_row reads a plane).
template <typename T, typename Load>
__device__ T mtm_row_from(const CbTables<T>& tb, Load v, T* out, int l, T* A, T* X, T* Y,
                          const T* w) {
  const int N = tb.N, L = tb.Ltau;
  const int lm = (l + L - 1) % L;
  const int lp = (l + 1) % L;
  const T s1_l = (l == 0) ? T(1) : T(-1);
  const T s1_lp = (lp == 0) ? T(1) : T(-1);
  const T sL_l = (l == L - 1) ? T(1) : T(-1);

  for (int n = threadIdx.x; n < N; n += blockDim.x) X[n] = v(lm, n);
  __syncthreads();
  T* r = apply_B(tb, l, X, Y);
  for (int n = threadIdx.x; n < N; n += blockDim.x) A[n] = v(l, n) + s1_l * r[n];
  __syncthreads();

  for (int n = threadIdx.x; n < N; n += blockDim.x) X[n] = v(l, n);
  __syncthreads();
  r = apply_B(tb, lp, X, Y);
  for (int n = threadIdx.x; n < N; n += blockDim.x) r[n] = v(lp, n) + s1_lp * r[n];
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

template <typename T>
__device__ T mtm_row(const CbTables<T>& tb, const T* v, T* out, int l, T* A, T* X, T* Y,
                     const T* w) {
  const int N = tb.N;
  return mtm_row_from<T>(
      tb, [=](int j, int n) { return v[(size_t)j * N + n]; }, out, l, A, X, Y, w);
}

// ---- asynchronous copies global -> shared (cp.async) ----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes = 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// sizeof(T) bytes global -> shared (4 or 8)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"((int)sizeof(T)));
}

// count elements src -> dst by the CTA, 16 bytes a copy where both are
// 16-byte aligned and count fills whole copies, else one element a copy;
// the caller commits and waits.
template <typename T>
__device__ void copy_async(T* dst, const T* src, int count) {
  constexpr int kPer = 16 / sizeof(T);
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0 && count % kPer == 0) {
    for (int c = threadIdx.x; c < count / kPer; c += blockDim.x)
      cp_async16(dst + c * kPer, src + c * kPer, 16);
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) cp_async_elem(dst + e, src + e);
  }
}

// Rows first, first + 1, ... (mod L) of an (L, N) plane into dst, rows x N.
template <typename T>
__device__ void stage_rows_async(T* dst, const T* plane, int first, int rows, int L, int N) {
  for (int done = 0, j = first; done < rows; j = 0) {
    const int run = rows - done < L - j ? rows - done : L - j;  // rows up to the wrap
    copy_async(dst + (size_t)done * N, plane + (size_t)j * N, run * N);
    done += run;
  }
}

// ---- tau-blocked rows: one CTA takes T consecutive tau rows of one system ----
//
// Buffer rows hold k rows of N sites each, row i at tau row (lb + i) mod Ltau.
// A thread takes sites n = threadIdx.x, + blockDim.x, ... and runs down all k
// rows of each, so a stage reads a site's tables once for the block and the
// rows share each __syncthreads(). Every read from device memory (the staged
// rows and expV) is a cp.async issued before the block's first stage.

// Rows of N values that mtm_rows_block's buffer holds for a block of T rows.
__host__ __device__ constexpr int mtm_block_rows(int T) { return 5 * T + 5; }

__device__ __forceinline__ int wrap_row(int l, int L) {
  while (l >= L) l -= L;
  return l;
}

// t = C_c u + S_c u[partner_c] on k rows, times E (expV of each row's tau,
// row-aligned with u) when kScale: the diagonal factor that follows this
// color in B.
template <typename T, bool kScale>
__device__ void color_rows(const CbTables<T>& tb, const T* E, int c, int lb, int k, const T* u,
                           T* t) {
  const int N = tb.N, L = tb.Ltau;
  const T* Cc = tb.C + (size_t)c * tb.color_stride;
  const T* Sc = tb.S + (size_t)c * tb.color_stride;
  const int* pc = tb.partner + (size_t)c * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int pn = pc[n];
    T cn = Cc[n], sn = Sc[n];
    for (int i = 0; i < k; ++i) {
      if (tb.tau_stride != 0) {  // tau-dependent hoppings: this row's tables
        const size_t ro = (size_t)wrap_row(lb + i, L) * tb.tau_stride + n;
        cn = Cc[ro];
        sn = Sc[ro];
      }
      const T* ui = u + i * N;
      T v = cn * ui[n] + sn * ui[pn];
      if (kScale) v = E[i * N + n] * v;
      t[i * N + n] = v;
    }
  }
}

// B_l u on k rows of u (symmetric factorization: the colors reversed, expV,
// the colors in order, as apply_B), ping-ponging through a and b (k rows
// each, neither of them u); returns the buffer with the result. u and E
// must be complete in shared memory (synchronised) on entry; n_colors >= 1.
template <typename T>
__device__ const T* apply_B_rows(const CbTables<T>& tb, const T* E, int lb, int k, const T* u,
                                 T* a, T* b) {
  const int nc = tb.n_colors;
  const T* in = u;
  T* out = a;
  for (int s = 0; s < 2 * nc; ++s) {
    if (s < nc - 1) {
      color_rows<T, false>(tb, E, nc - 1 - s, lb, k, in, out);
    } else if (s == nc - 1) {
      color_rows<T, true>(tb, E, 0, lb, k, in, out);
    } else {
      color_rows<T, false>(tb, E, s - nc, lb, k, in, out);
    }
    __syncthreads();
    in = out;
    out = out == a ? b : a;
  }
  return in;
}

// Rows l0 .. l0+nr-1 (nr >= 1, l0 + nr <= Ltau) of M^T M v for one system v
// (Ltau, N), symmetric factorization:
//   m_j = v_j + sgn1_j B_j v_{j-1}            j = l0 .. l0+nr      (nr + 1 B)
//   out_j = m_j + sgnL_j B_{j+1} m_{j+1}      j = l0 .. l0+nr-1    (nr B)
// with rows taken mod Ltau, sgn1 = +1 at row 0 and sgnL = +1 at row Ltau-1
// (-1 elsewhere): 2 nr + 1 B applications where one row at a time takes 3 nr,
// and ~2 (2 n_colors + 1) barriers for the block. v is the plane va, or
// comb(va, vb) element by element where vb is given (both staged). emit(j,
// n, out_j[n], v_j[n]) writes the output and returns its share of a dot,
// summed over this thread's elements into the return value. buf holds
// mtm_block_rows(nr) N values: V (nr + 2 rows, v_{l0-1} .. v_{l0+nr}), Mb
// (nr + 1, m; with X it first holds vb's rows), X (nr + 1), Y (nr) and E
// (nr + 1, expV of rows l0 .. l0+nr).
template <typename T, typename Comb, typename Emit>
__device__ double mtm_rows_block(const CbTables<T>& tb, const T* va, const T* vb, Comb comb, int l0,
                                 int nr, T* buf, Emit emit) {
  const int N = tb.N, L = tb.Ltau;
  T* V = buf;
  T* Mb = V + (nr + 2) * N;
  T* X = Mb + (nr + 1) * N;
  T* Y = X + (nr + 1) * N;
  T* E = Y + nr * N;
  const int lv = wrap_row(l0 + L - 1, L);  // tau row of V[0]
  stage_rows_async(V, va, lv, nr + 2, L, N);
  if (vb != nullptr) stage_rows_async(Mb, vb, lv, nr + 2, L, N);
  stage_rows_async(E, tb.expV, l0, nr + 1, L, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (vb != nullptr) {
    for (int e = threadIdx.x; e < (nr + 2) * N; e += blockDim.x) V[e] = comb(V[e], Mb[e]);
    __syncthreads();
  }
  const T* r = apply_B_rows(tb, E, l0, nr + 1, V, X, Mb);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int i = 0; i <= nr; ++i) {
      const T s1 = l0 + i == 0 || l0 + i == L ? T(1) : T(-1);  // tau 0 (l0 + i <= L)
      Mb[i * N + n] = V[(i + 1) * N + n] + s1 * r[i * N + n];  // r may be Mb: in place
    }
  }
  __syncthreads();
  r = apply_B_rows(tb, E + N, wrap_row(l0 + 1, L), nr, Mb + N, X, Y);
  double acc = 0.0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int i = 0; i < nr; ++i) {
      const int j = l0 + i;
      const T sL = j == L - 1 ? T(1) : T(-1);
      acc += emit(j, n, Mb[i * N + n] + sL * r[i * N + n], V[(i + 1) * N + n]);
    }
  }
  __syncthreads();  // buf is staged again by the next block
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
