// Kernel K4: the Holstein force epilogue alone, P1 and P2 from a given psi_raw.
//
// Replaces `_force_kernel` (smoqyelphqmc_tpu/ops/pallas_fused.py:934, its
// pallas_call in FusedForce.__call__ at :1004). The function and the design
// (one CTA per (walker, tau) row, neighbour rows recomputed in the CTA) are
// in force_epilogue.cuh, shared with K3.
//
// What bounds it on the H100: the color sweeps' shared-memory gathers and
// __syncthreads (per row and channel, 8 sweeps and 3 expV scalings of N
// sites), not device memory: each row reads three rows of psi_raw and Lam
// per channel and writes two rows.
//
// C interface (bound with ctypes from ops/force.py): returns cudaGetLastError().

#include <cuda_runtime.h>

#include "force_epilogue.cuh"

namespace {

__global__ void __launch_bounds__(smoqy::kThreads)
force_kernel(const float* __restrict__ x, const float* __restrict__ Lam, float* __restrict__ P1,
             float* __restrict__ P2, smoqy::CbTables<float> tb, int n_walkers, int want_p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);
  const size_t plane = (size_t)tb.Ltau * tb.N;
  const float* expV = tb.expV;
  for (int row = blockIdx.x; row < n_walkers * tb.Ltau; row += gridDim.x) {
    const int w = row / tb.Ltau;
    smoqy::CbTables<float> tw = tb;
    tw.expV = expV + w * plane;
    smoqy::force_row(tw, x + 2 * w * plane, Lam + w * plane, row % tb.Ltau, want_p2 != 0, buf,
                     P1 + (size_t)row * tb.N, P2 + (size_t)row * tb.N);
  }
}

}  // namespace

// x: (W, 2, Ltau, N); Lam, expV, P1, P2: (W, Ltau, N); C/S tables as in K1.
extern "C" int smoqy_force(const float* x, const float* Lam, float* P1, float* P2, const float* C,
                           const float* S, const int* partner, const float* expV, int n_walkers,
                           int Ltau, int N, int n_colors, int tab_rows, int want_p2,
                           void* stream) {
  smoqy::CbTables<float> tb;
  tb.C = C;
  tb.S = S;
  tb.partner = partner;
  tb.expV = expV;
  tb.N = N;
  tb.Ltau = Ltau;
  tb.n_colors = n_colors;
  tb.tau_stride = (tab_rows == 1) ? 0 : N;
  tb.color_stride = tab_rows * N;
  tb.symmetric = 1;
  const size_t smem = (size_t)smoqy::kForceRows * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  force_kernel<<<n_walkers * Ltau, smoqy::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, Lam, P1, P2, tb, n_walkers, want_p2);
  return (int)cudaGetLastError();
}
