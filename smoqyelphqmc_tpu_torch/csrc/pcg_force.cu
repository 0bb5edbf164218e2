// Kernel K3: the whole spectral-preconditioned CG solve with an in-kernel warm
// start, followed by the Holstein force epilogue, for W walkers in one launch.
//
// Replaces `_pcg_force_kernel` (smoqyelphqmc_tpu/ops/pallas_fused.py:620, its
// pallas_call in _pcg_force_call at :770), which ran one (re, im) channel pair
// per grid step and was vmapped over walkers. Here the B = 2W channel systems
// of all walkers share one cooperative grid:
//
//   b, x0, x: (W, 2, Ltau, N), system s = 2w + channel;
//   expV, Lam: (W, Ltau, N), walker w = s / 2 (the walker stride of the
//   tables); C/S/partner and the preconditioner W, Q, filt are shared.
//
// Unlike K2, the warm start enters the kernel: x = x0, r = b - M^T M x0, and
// each system stops at |r| < tol |b| (its own |b|); the kernel reports eps / |b|
// per system and, per walker, the number of iterations until both of its
// channels stopped (the loop count of the TPU kernel's channel-pair grid step).
//
// Form: a persistent cooperative kernel on K2's machinery (pcg_common.cuh:
// dot partials summed in a fixed order, a warp per system; the
// preconditioner's products on the tensor cores), with its own loop of six
// grid syncs per iteration (K2's loop has five),
// with one more phase before the loop (the warm residual) and the epilogue
// after it: once the loop's last grid.sync has published x, every CTA takes
// (walker, tau) rows and runs force_epilogue.cuh on them, recomputing the
// neighbour rows it needs, so the epilogue adds no grid sync and no scratch
// plane. The grid is sized from this kernel's own occupancy.
//
// What bounds it on the H100: the chain of dependent phases behind grid
// syncs, as in K2; at W = 8 the sixteen systems give the products (2 x 37 M
// bf16 multiply-adds per system and iteration at Ltau = 240, N = 288) eight
// times K2's tiles, ~4.5 per CTA. The epilogue is one pass over W Ltau rows.
//
// C interface (bound with ctypes from ops/pcg_force.py): returns a cudaError_t.

#include <cuda_runtime.h>

#include "force_epilogue.cuh"
#include "pcg_common.cuh"

namespace {

using namespace smoqy;

constexpr float kTiny = 1e-30f;

struct PcgForceArgs {
  const float* b;
  const float* x0;
  const float* Lam;
  float* x;
  float* P1;
  float* P2;
  float* eps_out;   // (B,) eps / |b|
  int* iters_out;   // (W,)
  CbTables<float> tb;  // expV of walker 0; walker w at + w Ltau N
  const __nv_bfloat16* W;
  const __nv_bfloat16* Wt;
  const __nv_bfloat16* Q;
  const __nv_bfloat16* Qt;
  const float* filt;
  float* r;
  float* p;
  float* z;
  float* Ap;
  __nv_bfloat16* U;
  __nv_bfloat16* Am;
  __nv_bfloat16* Bm;
  double* part;
  int B;
  int Ltau;
  int Lh;
  int N;
  float tol;
  int maxiter;
  int want_p2;
};

__device__ __forceinline__ CbTables<float> walker_tables(const PcgForceArgs& a, int w) {
  CbTables<float> t = a.tb;
  t.expV += (size_t)w * a.Ltau * a.N;
  return t;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm) pcg_force_kernel(PcgForceArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  __shared__ float tolc[kMaxSystems];
  __shared__ float normb[kMaxSystems];
  __shared__ int wit[kMaxSystems / 2];
  // GEMM stages, matvec rows and epilogue rows alias: no phase uses two of them
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* rowA = reinterpret_cast<float*>(smem_raw);
  float* rowX = rowA + a.N;
  float* rowY = rowX + a.N;

  const int B = a.B, L = a.Ltau, N = a.N, nw = a.B / 2;
  const size_t plane = (size_t)L * N;
  const int rows = B * L;
  const int tid = threadIdx.x;

  // |b|^2 and x = x0 (partials in the PAp slot) ...
  zero_part(sh, B);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * N;
    double loc = 0.0;
    for (int n = tid; n < N; n += blockDim.x) {
      const float bv = a.b[off + n];
      a.x[off + n] = a.x0[off + n];
      loc += (double)bv * bv;
    }
    const double t = block_sum(loc, sh.red);
    if (tid == 0) sh.part[row / L] += t;
  }
  flush_part(a, sh, kPartPAp);
  // ... then r = b - M^T M x0 and |r|^2 (RR slot); both read only b and x0
  zero_part(sh, B);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int s = row / L;
    const size_t off = (size_t)row * N;
    mtm_row<float>(walker_tables(a, s >> 1), a.x0 + s * plane, a.Ap + off, row % L, rowA, rowX,
                   rowY, nullptr);
    double loc = 0.0;
    for (int n = tid; n < N; n += blockDim.x) {
      const float rn = a.b[off + n] - a.Ap[off + n];
      a.r[off + n] = rn;
      loc += (double)rn * rn;
    }
    const double t = block_sum(loc, sh.red);
    if (tid == 0) sh.part[s] += t;
  }
  flush_part(a, sh, kPartRR);
  grid.sync();
  reduce_parts(a, sh, kPartPAp);
  for (int s = tid; s < B; s += blockDim.x) {
    normb[s] = (float)sqrt(sh.sum[s]);
    tolc[s] = a.tol * fmaxf(normb[s], kTiny);
  }
  reduce_parts(a, sh, kPartRR);
  for (int s = tid; s < B; s += blockDim.x) {
    sh.eps[s] = (float)sqrt(sh.sum[s]);
    sh.active[s] = sh.eps[s] >= tolc[s];
  }
  for (int w = tid; w < nw; w += blockDim.x) wit[w] = 0;
  __syncthreads();
  const F32Src rsrc(a.r, plane, N, N);
  precond(a, grid, sh, sg, rsrc, a.r, [] {}, [](int) {});
  reduce_parts(a, sh, kPartRZ);
  for (int s = tid; s < B; s += blockDim.x) sh.rdotz[s] = (float)sh.sum[s];
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
    for (int w = tid; w < nw; w += blockDim.x) wit[w] += sh.active[2 * w] | sh.active[2 * w + 1];

    // Ap = M^T M p and dot(p, Ap), rows of active systems only
    zero_part(sh, B);
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int s = row / L;
      if (!sh.active[s]) continue;
      const float* ps = a.p + s * plane;
      const float loc = mtm_row<float>(walker_tables(a, s >> 1), ps, a.Ap + (size_t)row * N,
                                       row % L, rowA, rowX, rowY, a.p + (size_t)row * N);
      const double t = block_sum((double)loc, sh.red);
      if (tid == 0) sh.part[s] += t;
    }
    flush_part(a, sh, kPartPAp);
    grid.sync();
    reduce_parts(a, sh, kPartPAp);
    for (int s = tid; s < B; s += blockDim.x) {
      const float pAp = (float)sh.sum[s];
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
      const double t = block_sum(loc, sh.red);
      if (tid == 0) sh.part[s] += t;
    }
    flush_part(a, sh, kPartRR);
    grid.sync();
    reduce_parts(a, sh, kPartRR);
    for (int s = tid; s < B; s += blockDim.x) {
      if (sh.active[s]) sh.eps[s] = (float)sqrt(sh.sum[s]);
      sh.on[s] = sh.active[s] && sh.eps[s] >= tolc[s];
    }
    __syncthreads();

    precond(a, grid, sh, sg, rsrc, a.r, [] {}, [](int) {});
    reduce_parts(a, sh, kPartRZ);
    for (int s = tid; s < B; s += blockDim.x) {
      const float nrz = (float)sh.sum[s];
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

  // the force epilogue on the solution: one (walker, tau) row per CTA step
  for (int row = blockIdx.x; row < nw * L; row += gridDim.x) {
    const int w = row / L;
    force_row(walker_tables(a, w), a.x + 2 * w * plane, a.Lam + w * plane, row % L,
              a.want_p2 != 0, rowA, a.P1 + (size_t)row * N, a.P2 + (size_t)row * N);
  }

  if (blockIdx.x == 0) {
    for (int s = tid; s < B; s += blockDim.x) a.eps_out[s] = sh.eps[s] / fmaxf(normb[s], kTiny);
    for (int w = tid; w < nw; w += blockDim.x) a.iters_out[w] = wit[w];
  }
}

size_t pcg_force_smem_bytes(int N) {
  const size_t row = (size_t)kForceRows * N * sizeof(float);  // >= the matvec's 3 N
  return kGemmSmem > row ? kGemmSmem : row;
}

int pcg_force_grid(int N, int* grid_out) {
  return cooperative_grid(pcg_force_kernel, pcg_force_smem_bytes(N), grid_out);
}

}  // namespace

// CTAs of the cooperative launch for N sites (or a negative cudaError_t). The
// partial array must hold 3 * smoqy_pcg_max_grid() * B doubles.
extern "C" int smoqy_pcg_force_grid(int N) {
  int g = 0;
  const int e = pcg_force_grid(N, &g);
  return e ? -e : g;
}

extern "C" int smoqy_pcg_force(const float* b, const float* x0, const float* Lam, float* x,
                               float* P1, float* P2, float* eps, int* iters, const float* C,
                               const float* S, const int* partner, const float* expV,
                               const void* W, const void* Wt, const void* Q, const void* Qt,
                               const float* filt, float* work,
                               double* part, int n_walkers, int Ltau, int Lh, int N,
                               int n_colors, int tab_rows, float tol, int maxiter, int want_p2,
                               void* stream) {
  const int B = 2 * n_walkers;
  if (n_walkers < 1 || B > kMaxSystems) return (int)cudaErrorInvalidValue;
  int g = 0;
  int e = pcg_force_grid(N, &g);
  if (e) return e;
  PcgForceArgs a;
  a.b = b;
  a.x0 = x0;
  a.Lam = Lam;
  a.x = x;
  a.P1 = P1;
  a.P2 = P2;
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
  a.tb.symmetric = 1;
  a.W = static_cast<const __nv_bfloat16*>(W);
  a.Wt = static_cast<const __nv_bfloat16*>(Wt);
  a.Q = static_cast<const __nv_bfloat16*>(Q);
  a.Qt = static_cast<const __nv_bfloat16*>(Qt);
  a.filt = filt;
  const size_t plane = (size_t)B * Ltau * N;
  const size_t half = (size_t)B * 2 * Lh * N;  // bf16 elements
  a.r = work;
  a.p = work + plane;
  a.z = work + 2 * plane;
  a.Ap = work + 3 * plane;
  a.U = reinterpret_cast<__nv_bfloat16*>(work + 4 * plane);
  a.Am = a.U + half;
  a.Bm = a.Am + half;
  a.part = part;
  a.B = B;
  a.Ltau = Ltau;
  a.Lh = Lh;
  a.N = N;
  a.tol = tol;
  a.maxiter = maxiter;
  a.want_p2 = want_p2;
  void* args[] = {&a};
  cudaError_t ce = cudaLaunchCooperativeKernel((const void*)pcg_force_kernel, dim3(g),
                                               dim3(kThreads), args, pcg_force_smem_bytes(N),
                                               static_cast<cudaStream_t>(stream));
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
