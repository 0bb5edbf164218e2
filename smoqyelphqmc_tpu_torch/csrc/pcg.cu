// Kernel K2: the whole spectral-preconditioned CG solve in one launch.
//
// Replaces `_pcg_kernel` (smoqyelphqmc_tpu/ops/pallas_fused.py:495, its
// pallas_call at :579). It solves [M^T M] x = b for B independent systems
// whose right-hand sides arrive scaled to unit norm, so the per-system
// stopping test |r| < tol is absolute; it returns x, the per-system eps and
// the iteration count (the host side, ops/pcg.py, keeps FusedPCG.__call__'s
// normalisation and warm-start handling).
//
// Form: a persistent cooperative kernel. The TPU kernel kept one chunk's
// Krylov set resident in VMEM; an SM has 228 KB of shared memory, while one
// (240, 288) f32 plane is 276 KB, so here the Krylov vectors (x, r, p, z, Ap)
// and the preconditioner's half-spectrum planes stay in device memory, where
// a system's set (~1.4 MB) stays resident in the 50 MB L2. The grid
// (occupancy x SMs, at most two CTAs per SM) walks every phase of an
// iteration, and cooperative_groups' grid.sync() separates the phases:
//
//   Ap = M^T M p            one CTA per (system, tau) row, row_ops.cuh
//   x += a p, r -= a Ap     rows
//   z = P^{-1} r            four tiled products, bf16 operands, f32 sums:
//     U  = [Wre; Wim] r          (2Lh x Ltau)(Ltau x N) per system
//     Am = (U Q) * filt          (B 2Lh x N)(N x N)
//     Bm = Am Q^T
//     z  = [Wre^T Wim^T] Bm      (Ltau x 2Lh)(2Lh x N) per system
//   p = z + beta p          rows
//
// Per-system dots are reduced per CTA (in double) into a (grid, B) partial
// array and summed in a fixed order by every CTA after the next grid.sync, so
// every CTA holds the same alpha, beta and active mask without another sync.
// Six grid-wide syncs per iteration.
//
// What bounds it on the H100: at the headline size (B = 2, Ltau = 240,
// N = 288) the preconditioner's products, ~2 x 37 M multiply-adds per
// iteration, on a plain shared-memory tiling without tensor cores, and the
// grid-wide syncs; the matvec rows are memory-bound as in K1. Tensor cores
// (mma.sync / wgmma) for the products are later work.
//
// C interface (bound with ctypes from ops/pcg.py): returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kLd = kTile + 1;
constexpr int kMaxSystems = 256;
constexpr int kMaxGrid = 1024;
constexpr int kCtasPerSm = 2;
enum { kPartPAp = 0, kPartRR = 1, kPartRZ = 2 };

struct PcgArgs {
  const float* b;
  float* x;
  float* eps_out;
  int* iters_out;
  smoqy::CbTables<float> tb;
  const __nv_bfloat16* W;  // (2 Lh, Ltau): antiperiodic DFT rows, real then imaginary
  const __nv_bfloat16* Q;  // (N, N) eigenvectors of Bbar
  const float* filt;       // (Lh, N), pair factor folded in
  float* r;
  float* p;
  float* z;
  float* Ap;
  float* U;   // (B, 2 Lh, N)
  float* Am;  // (B, 2 Lh, N)
  float* Bm;  // (B, 2 Lh, N)
  double* part;  // (3, kMaxGrid, B)
  int B;
  int Ltau;
  int Lh;
  int N;
  float tol;
  int maxiter;
};

__device__ __forceinline__ float to_bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_bf16_value(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Shared {
  double red[smoqy::kThreads / 32];
  double part[kMaxSystems];
  float rdotz[kMaxSystems];
  float eps[kMaxSystems];
  float alpha[kMaxSystems];
  float beta[kMaxSystems];
  int active[kMaxSystems];
  int on[kMaxSystems];
};

__device__ void zero_part(Shared& sh, int B) {
  for (int s = threadIdx.x; s < B; s += blockDim.x) sh.part[s] = 0.0;
  __syncthreads();
}

__device__ void flush_part(const PcgArgs& a, Shared& sh, int which) {
  __syncthreads();
  for (int s = threadIdx.x; s < a.B; s += blockDim.x)
    a.part[((size_t)which * kMaxGrid + blockIdx.x) * a.B + s] = sh.part[s];
}

// Fixed-order sum of one system's CTA partials: identical in every CTA.
__device__ double reduce_part(const PcgArgs& a, int which, int s) {
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
      const double t = smoqy::block_sum(local, sh.red);
      if (threadIdx.x == 0) sh.part[bt] += t;
    }
  }
}

// z = P^{-1} r for every system, plus the CTA partials of dot(r, z).
__device__ void precond(const PcgArgs& a, cg::grid_group& grid, Shared& sh, float* sA, float* sB) {
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

__global__ void __launch_bounds__(smoqy::kThreads) pcg_kernel(PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  // the GEMM tiles and the matvec row buffers alias: no phase uses both
  float* sA = reinterpret_cast<float*>(smem_raw);
  float* sB = sA + kTile * kLd;
  float* rowA = reinterpret_cast<float*>(smem_raw);
  float* rowX = rowA + a.N;
  float* rowY = rowX + a.N;

  const int B = a.B, L = a.Ltau, N = a.N;
  const size_t plane = (size_t)L * N;
  const int rows = B * L;
  const int tid = threadIdx.x;

  // x = 0, r = b, |r|^2
  zero_part(sh, B);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * N;
    double loc = 0.0;
    for (int n = tid; n < N; n += blockDim.x) {
      const float bv = a.b[off + n];
      a.x[off + n] = 0.f;
      a.r[off + n] = bv;
      loc += (double)bv * bv;
    }
    const double t = smoqy::block_sum(loc, sh.red);
    if (tid == 0) sh.part[row / L] += t;
  }
  flush_part(a, sh, kPartRR);
  grid.sync();
  for (int s = tid; s < B; s += blockDim.x) {
    sh.eps[s] = (float)sqrt(reduce_part(a, kPartRR, s));
    sh.active[s] = sh.eps[s] >= a.tol;
  }
  __syncthreads();
  precond(a, grid, sh, sA, sB);
  for (int s = tid; s < B; s += blockDim.x) sh.rdotz[s] = (float)reduce_part(a, kPartRZ, s);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * N;
    for (int n = tid; n < N; n += blockDim.x) a.p[off + n] = a.z[off + n];
  }
  grid.sync();

  int it = 0;
  while (true) {
    __syncthreads();
    int any = 0;
    for (int s = 0; s < B; ++s) any |= sh.active[s];
    if (!any || it >= a.maxiter) break;

    // Ap = M^T M p and dot(p, Ap), rows of active systems only
    zero_part(sh, B);
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int s = row / L;
      if (!sh.active[s]) continue;
      const float* ps = a.p + s * plane;
      const float loc = smoqy::mtm_row<float>(a.tb, ps, a.Ap + (size_t)row * N, row % L, rowA,
                                              rowX, rowY, a.p + (size_t)row * N);
      const double t = smoqy::block_sum((double)loc, sh.red);
      if (tid == 0) sh.part[s] += t;
    }
    flush_part(a, sh, kPartPAp);
    grid.sync();
    for (int s = tid; s < B; s += blockDim.x) {
      const float pAp = (float)reduce_part(a, kPartPAp, s);
      sh.alpha[s] = sh.active[s] ? sh.rdotz[s] / (pAp != 0.f ? pAp : 1.f) : 0.f;
    }
    zero_part(sh, B);  // its __syncthreads also publishes alpha

    // x += alpha p, r -= alpha Ap, |r|^2
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int s = row / L;
      if (!sh.active[s]) continue;
      const float al = sh.alpha[s];
      const size_t off = (size_t)row * N;
      double loc = 0.0;
      for (int n = tid; n < N; n += blockDim.x) {
        a.x[off + n] = a.x[off + n] + al * a.p[off + n];
        const float rn = a.r[off + n] - al * a.Ap[off + n];
        a.r[off + n] = rn;
        loc += (double)rn * rn;
      }
      const double t = smoqy::block_sum(loc, sh.red);
      if (tid == 0) sh.part[s] += t;
    }
    flush_part(a, sh, kPartRR);
    grid.sync();
    for (int s = tid; s < B; s += blockDim.x) {
      if (sh.active[s]) sh.eps[s] = (float)sqrt(reduce_part(a, kPartRR, s));
      sh.on[s] = sh.active[s] && sh.eps[s] >= a.tol;
    }
    __syncthreads();

    precond(a, grid, sh, sA, sB);
    for (int s = tid; s < B; s += blockDim.x) {
      const float nrz = (float)reduce_part(a, kPartRZ, s);
      sh.beta[s] = sh.on[s] ? nrz / (sh.rdotz[s] != 0.f ? sh.rdotz[s] : 1.f) : 0.f;
      if (sh.on[s]) sh.rdotz[s] = nrz;
    }
    __syncthreads();
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int s = row / L;
      if (!sh.on[s]) continue;
      const float be = sh.beta[s];
      const size_t off = (size_t)row * N;
      for (int n = tid; n < N; n += blockDim.x) a.p[off + n] = a.z[off + n] + be * a.p[off + n];
    }
    __syncthreads();
    for (int s = tid; s < B; s += blockDim.x) sh.active[s] = sh.on[s];
    ++it;
    grid.sync();
  }

  if (blockIdx.x == 0) {
    for (int s = tid; s < B; s += blockDim.x) a.eps_out[s] = sh.eps[s];
    if (tid == 0) *a.iters_out = it;
  }
}

size_t pcg_smem_bytes(int N) {
  const size_t gemm = 2 * kTile * kLd * sizeof(float);
  const size_t row = 3 * (size_t)N * sizeof(float);
  return gemm > row ? gemm : row;
}

int pcg_grid(int N, int* grid_out) {
  const size_t smem = pcg_smem_bytes(N);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel, smoqy::kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int g = (per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * sms;
  *grid_out = g < kMaxGrid ? g : kMaxGrid;
  return 0;
}

}  // namespace

// Number of CTAs the cooperative launch uses for N sites (or a negative
// cudaError_t). The partial array must hold 3 * smoqy_pcg_max_grid() * B doubles.
extern "C" int smoqy_pcg_grid(int N) {
  int g = 0;
  const int e = pcg_grid(N, &g);
  return e ? -e : g;
}

extern "C" int smoqy_pcg_max_grid() { return kMaxGrid; }

extern "C" int smoqy_pcg_max_systems() { return kMaxSystems; }

extern "C" int smoqy_pcg(const float* b, float* x, float* eps, int* iters, const float* C,
                         const float* S, const int* partner, const float* expV, const void* W,
                         const void* Q, const float* filt, float* work, double* part, int B,
                         int Ltau, int Lh, int N, int n_colors, int tab_rows, int symmetric,
                         float tol, int maxiter, void* stream) {
  if (B < 1 || B > kMaxSystems) return (int)cudaErrorInvalidValue;
  int g = 0;
  int e = pcg_grid(N, &g);
  if (e) return e;
  PcgArgs a;
  a.b = b;
  a.x = x;
  a.eps_out = eps;
  a.iters_out = iters;
  a.tb.C = C;
  a.tb.S = S;
  a.tb.partner = partner;
  a.tb.expV = expV;
  a.tb.N = N;
  a.tb.Ltau = Ltau;
  a.tb.n_colors = n_colors;
  a.tb.tau_stride = (tab_rows == 1) ? 0 : N;
  a.tb.color_stride = tab_rows * N;
  a.tb.symmetric = symmetric;
  a.W = static_cast<const __nv_bfloat16*>(W);
  a.Q = static_cast<const __nv_bfloat16*>(Q);
  a.filt = filt;
  const size_t plane = (size_t)B * Ltau * N;
  const size_t half = (size_t)B * 2 * Lh * N;
  a.r = work;
  a.p = work + plane;
  a.z = work + 2 * plane;
  a.Ap = work + 3 * plane;
  a.U = work + 4 * plane;
  a.Am = a.U + half;
  a.Bm = a.Am + half;
  a.part = part;
  a.B = B;
  a.Ltau = Ltau;
  a.Lh = Lh;
  a.N = N;
  a.tol = tol;
  a.maxiter = maxiter;
  void* args[] = {&a};
  cudaError_t ce = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(g),
                                               dim3(smoqy::kThreads), args, pcg_smem_bytes(N),
                                               static_cast<cudaStream_t>(stream));
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
