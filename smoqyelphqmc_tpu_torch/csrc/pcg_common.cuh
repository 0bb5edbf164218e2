// The cooperative whole-solve machinery shared by kernels K2 (pcg.cu) and K3
// (pcg_force.cu): per-system dot partials reduced in a fixed order, the bf16
// preconditioner products on a 32 x 32 shared-memory tiling, and the
// cooperative grid size.
//
// Both kernels' argument structs carry the fields these functions read (the
// Krylov planes r, z, the preconditioner operands W, Q, filt, its scratch U,
// Am, Bm, the partial array and the sizes B, Ltau, Lh, N), so the functions
// are templates on the argument type.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace smoqy {

namespace cg = cooperative_groups;

constexpr int kTile = 32;
constexpr int kLd = kTile + 1;
constexpr int kMaxSystems = 256;
constexpr int kMaxGrid = 1024;
constexpr int kCtasPerSm = 2;
enum { kPartPAp = 0, kPartRR = 1, kPartRZ = 2 };

__device__ __forceinline__ float to_bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_bf16_value(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Shared {
  double red[kThreads / 32];
  double part[kMaxSystems];
  float rdotz[kMaxSystems];
  float eps[kMaxSystems];
  float alpha[kMaxSystems];
  float beta[kMaxSystems];
  int active[kMaxSystems];
  int on[kMaxSystems];
};

__device__ inline void zero_part(Shared& sh, int B) {
  for (int s = threadIdx.x; s < B; s += blockDim.x) sh.part[s] = 0.0;
  __syncthreads();
}

template <typename Args>
__device__ void flush_part(const Args& a, Shared& sh, int which) {
  __syncthreads();
  for (int s = threadIdx.x; s < a.B; s += blockDim.x)
    a.part[((size_t)which * kMaxGrid + blockIdx.x) * a.B + s] = sh.part[s];
}

// Fixed-order sum of one system's CTA partials: identical in every CTA.
template <typename Args>
__device__ double reduce_part(const Args& a, int which, int s) {
  double acc = 0.0;
  for (unsigned g = 0; g < gridDim.x; ++g) acc += a.part[((size_t)which * kMaxGrid + g) * a.B + s];
  return acc;
}

// C[bt](m, n) = sum_k A[bt](m, k) Bq[bt](k, n) for every batch entry bt, over
// 32 x 32 output tiles spread across the grid; operands are rounded to bf16
// on load and summed in f32. epi(bt, m, n, value) stores the value and
// returns this element's share of a per-system dot (summed when kDot).
template <bool kDot, typename TA, typename TB, typename Epi>
__device__ void gemm_bf16(Shared& sh, float* sA, float* sB, int nb, int M, int Nc, int K,
                          const TA* A, size_t a_b, size_t a_m, size_t a_k, const TB* Bq,
                          size_t b_b, size_t b_k, size_t b_n, Epi epi) {
  const int tm = (M + kTile - 1) / kTile;
  const int tn = (Nc + kTile - 1) / kTile;
  const int n_tiles = nb * tm * tn;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;  // 0..7
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int bt = tile / (tm * tn);
    const int rem = tile % (tm * tn);
    const int m0 = (rem / tn) * kTile;
    const int n0 = (rem % tn) * kTile;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += kTile) {
      for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
        const int i = e / kTile, j = e % kTile;
        const int m = m0 + i, k = k0 + j;
        sA[i * kLd + j] =
            (m < M && k < K) ? to_bf16_value(A[bt * a_b + m * a_m + k * a_k]) : 0.f;
        const int kk = k0 + i, n = n0 + j;
        sB[i * kLd + j] =
            (kk < K && n < Nc) ? to_bf16_value(Bq[bt * b_b + kk * b_k + n * b_n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const float bv = sB[kk * kLd + tx];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(sA[(ty + 8 * q) * kLd + kk], bv, acc[q]);
      }
      __syncthreads();
    }
    double local = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + ty + 8 * q, n = n0 + tx;
      if (m < M && n < Nc) local += (double)epi(bt, m, n, acc[q]);
    }
    if (kDot) {
      const double t = block_sum(local, sh.red);
      if (threadIdx.x == 0) sh.part[bt] += t;
    }
  }
}

// z = P^{-1} r for every system, plus the CTA partials of dot(r, z):
//   U  = [Wre; Wim] r          (2Lh x Ltau)(Ltau x N) per system
//   Am = (U Q) * filt          (B 2Lh x N)(N x N)
//   Bm = Am Q^T
//   z  = [Wre^T Wim^T] Bm      (Ltau x 2Lh)(2Lh x N) per system
template <typename Args>
__device__ void precond(const Args& a, cg::grid_group& grid, Shared& sh, float* sA, float* sB) {
  const int B = a.B, L = a.Ltau, Lh = a.Lh, N = a.N, M2 = 2 * a.Lh;
  const size_t plane = (size_t)L * N;
  float* U = a.U;
  float* Am = a.Am;
  float* Bm = a.Bm;
  float* z = a.z;
  const float* r = a.r;
  const float* filt = a.filt;

  gemm_bf16<false>(sh, sA, sB, B, M2, N, L, a.W, 0, L, 1, r, plane, N, 1,
                   [=](int bt, int m, int n, float v) {
                     U[((size_t)bt * M2 + m) * N + n] = v;
                     return 0.f;
                   });
  grid.sync();
  gemm_bf16<false>(sh, sA, sB, 1, B * M2, N, N, U, 0, N, 1, a.Q, 0, N, 1,
                   [=](int, int m, int n, float v) {
                     Am[(size_t)m * N + n] = v * filt[(size_t)(m % Lh) * N + n];
                     return 0.f;
                   });
  grid.sync();
  gemm_bf16<false>(sh, sA, sB, 1, B * M2, N, N, Am, 0, N, 1, a.Q, 0, 1, N,
                   [=](int, int m, int n, float v) {
                     Bm[(size_t)m * N + n] = v;
                     return 0.f;
                   });
  grid.sync();
  zero_part(sh, B);
  gemm_bf16<true>(sh, sA, sB, B, L, N, M2, a.W, 0, 1, L, Bm, (size_t)M2 * N, N, 1,
                  [=](int bt, int m, int n, float v) {
                    const size_t i = bt * plane + (size_t)m * N + n;
                    z[i] = v;
                    return v * r[i];
                  });
  flush_part(a, sh, kPartRZ);
  grid.sync();
}

// CTAs of a cooperative launch of `kernel` (at most kCtasPerSm per SM, at most
// kMaxGrid), after raising its dynamic shared-memory limit to `smem` bytes.
template <typename Kernel>
int cooperative_grid(Kernel kernel, size_t smem, int* grid_out) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int g = (per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * sms;
  *grid_out = g < kMaxGrid ? g : kMaxGrid;
  return 0;
}

}  // namespace smoqy
