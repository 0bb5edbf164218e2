// The Holstein force epilogue: the product planes P1, P2 of one (walker, tau)
// row from a solution psi_raw, which K3 (pcg_force.cu) runs on the solution
// it has just found. K4 (force.cu) computes the same planes on tau blocks.
//
// Replaces the epilogue of `_pcg_force_kernel` and `_force_kernel`
// (the JAX package's ops/pallas_fused.py:707-737, :959-976). For one channel
// pair x = psi_raw (2, Ltau, N) and the shift matrix Lam (Ltau, N):
//
//   psi = roll(x, +1) / Lam,  lam_psi = roll(Lam psi, -1)
//   w = B roll(lam_psi, +1),  sw = sgn1 w,  A = lam_psi + sw   (= M lam_psi)
//   P1 = sum_ch (CB^T A) (CB^{-1} sw)
//   P2 = sum_ch roll(M^T A, +1) psi                         (want_p2)
//
// Symmetric factorization only (B = CB^T D CB = B^T), as in the TPU kernels.
//
// Rows depend on their neighbours: P2 at row l reads M^T A at l-1, which
// reads A at l-1 and l, which read lam_psi at l-2..l, i.e. x at rows l-2..l.
// Each CTA recomputes what its row needs (three B applications and two color
// sweeps per channel) instead of storing A and sw in scratch planes between
// two grid-wide phases: no scratch memory and no extra grid.sync() in K3.
// The device-memory reads are three x rows and
// three Lam rows per channel; the tables stay resident in L2.
#pragma once

#include "row_ops.cuh"

namespace smoqy {

// Shared-memory rows the epilogue needs (floats = kForceRows * N).
constexpr int kForceRows = 8;

// lam_psi[j] = Lam[j+1] (x[j] / Lam[j+1]), the op order of the TPU kernels.
__device__ __forceinline__ float lam_psi_at(const float* x, const float* Lam, int j, int L, int N,
                                            int n) {
  const float lam1 = Lam[(size_t)((j + 1) % L) * N + n];
  return lam1 * (x[(size_t)j * N + n] / lam1);
}

// P1, P2 (N each) of row l for one walker: tb carries that walker's expV, x
// its channel pair (channel 1 one plane after channel 0), Lam its shift
// matrix. buf holds kForceRows * N floats of shared memory.
__device__ inline void force_row(const CbTables<float>& tb, const float* x, const float* Lam, int l,
                                 bool want_p2, float* buf, float* P1, float* P2) {
  const int N = tb.N, L = tb.Ltau;
  const size_t plane = (size_t)L * N;
  const int lm = (l + L - 1) % L;
  const int lmm = (l + L - 2) % L;
  const float s1_l = (l == 0) ? 1.f : -1.f;
  const float s1_lm = (lm == 0) ? 1.f : -1.f;
  const float sL_lm = (lm == L - 1) ? 1.f : -1.f;
  float* A = buf;
  float* SW = buf + N;
  float* T0 = buf + 2 * N;
  float* T1 = buf + 3 * N;
  float* T2 = buf + 4 * N;
  float* T3 = buf + 5 * N;
  float* acc1 = buf + 6 * N;
  float* acc2 = buf + 7 * N;

  for (int ch = 0; ch < 2; ++ch) {
    const float* xc = x + ch * plane;
    // w_l = B_l lam_psi_{l-1}
    for (int n = threadIdx.x; n < N; n += blockDim.x) T0[n] = lam_psi_at(xc, Lam, lm, L, N, n);
    __syncthreads();
    const float* r = apply_B(tb, l, T0, T1);
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float sw = s1_l * r[n];
      const float a = lam_psi_at(xc, Lam, l, L, N, n) + sw;
      SW[n] = sw;
      A[n] = a;
      T2[n] = a;
    }
    __syncthreads();
    const float* up = cb_sweep(tb, l, T2, T3, true);          // CB^T A
    const float* vp = cb_sweep<float, true>(tb, l, SW, T0, true);  // CB^{-1} sw
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float prod = up[n] * vp[n];
      acc1[n] = ch == 0 ? prod : acc1[n] + prod;
    }
    __syncthreads();
    if (want_p2) {
      // M^T A at l-1 = A_{l-1} + sgnL_{l-1} B_l^T A_l, with
      // A_{l-1} = lam_psi_{l-1} + sgn1_{l-1} B_{l-1} lam_psi_{l-2}
      const float* rA = apply_Bt(tb, l, A, T1);
      for (int n = threadIdx.x; n < N; n += blockDim.x) T2[n] = lam_psi_at(xc, Lam, lmm, L, N, n);
      __syncthreads();
      const float* r2 = apply_B(tb, lm, T2, T3);
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const float a_lm = lam_psi_at(xc, Lam, lm, L, N, n) + s1_lm * r2[n];
        const float mta = a_lm + sL_lm * rA[n];
        const float prod = mta * (xc[(size_t)lm * N + n] / Lam[(size_t)l * N + n]);
        acc2[n] = ch == 0 ? prod : acc2[n] + prod;
      }
      __syncthreads();
    }
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    P1[n] = acc1[n];
    P2[n] = want_p2 ? acc2[n] : 0.f;
  }
  __syncthreads();
}

}  // namespace smoqy
