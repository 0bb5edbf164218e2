// Kernel K1: the M^T M matvec of the fermion determinant matrix, f32 and f64.
//
// Replaces `_mtm_kernel_roll` (smoqyelphqmc_tpu/ops/pallas_fused.py:121, its
// pallas_call at :250). The TPU kernel decomposed the checkerboard partner
// gather into lane-roll classes because a gather was not native there; here
// the partner table (n_colors, N) is read directly, which also covers the
// irregular partner maps of `_mtm_kernel_mm` (:165).
//
// What bounds it on the H100: memory. Per (system, tau) row it reads three
// input rows (v_{l-1}, v_l, v_{l+1}), the row's diagonal factors and the
// (compressed) C/S/partner tables, and writes one row; the arithmetic is
// 3 * (2 n_colors + 1) multiply-adds per site. The design keeps every
// intermediate of the three B applications in shared memory (one CTA per row,
// colors separated by __syncthreads), so device memory sees the inputs and
// the output once, and the tables stay resident in L2 across rows.
//
// C interface (bound with ctypes from ops/mtm.py): returns cudaGetLastError().

#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(smoqy::kThreads)
mtm_kernel(const T* __restrict__ v, T* __restrict__ out, smoqy::CbTables<T> tb, int n_sys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* X = A + tb.N;
  T* Y = X + tb.N;
  const size_t plane = (size_t)tb.Ltau * tb.N;
  const int rows = n_sys * tb.Ltau;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int s = row / tb.Ltau;
    const int l = row % tb.Ltau;
    smoqy::mtm_row<T>(tb, v + s * plane, out + (size_t)row * tb.N, l, A, X, Y, nullptr);
  }
}

template <typename T>
int launch_mtm(const T* v, T* out, const T* C, const T* S, const int* partner, const T* expV,
               int n_sys, int Ltau, int N, int n_colors, int tab_rows, int symmetric,
               cudaStream_t stream) {
  smoqy::CbTables<T> tb;
  tb.C = C;
  tb.S = S;
  tb.partner = partner;
  tb.expV = expV;
  tb.N = N;
  tb.Ltau = Ltau;
  tb.n_colors = n_colors;
  tb.tau_stride = (tab_rows == 1) ? 0 : N;
  tb.color_stride = tab_rows * N;
  tb.symmetric = symmetric;
  const size_t smem = 3 * (size_t)N * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mtm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = n_sys * Ltau;
  mtm_kernel<T><<<rows, smoqy::kThreads, smem, stream>>>(v, out, tb, n_sys);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int smoqy_mtm_f32(const float* v, float* out, const float* C, const float* S,
                             const int* partner, const float* expV, int n_sys, int Ltau, int N,
                             int n_colors, int tab_rows, int symmetric, void* stream) {
  return launch_mtm<float>(v, out, C, S, partner, expV, n_sys, Ltau, N, n_colors, tab_rows,
                           symmetric, static_cast<cudaStream_t>(stream));
}

extern "C" int smoqy_mtm_f64(const double* v, double* out, const double* C, const double* S,
                             const int* partner, const double* expV, int n_sys, int Ltau, int N,
                             int n_colors, int tab_rows, int symmetric, void* stream) {
  return launch_mtm<double>(v, out, C, S, partner, expV, n_sys, Ltau, N, n_colors, tab_rows,
                            symmetric, static_cast<cudaStream_t>(stream));
}
