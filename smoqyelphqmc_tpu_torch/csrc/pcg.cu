// Kernel K2: the whole spectral-preconditioned CG solve in one launch.
//
// Replaces `_pcg_kernel` (the JAX package's ops/pallas_fused.py:495, its
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
// a system's set (~2 MB) stays resident in the 50 MB L2. The grid
// (occupancy x SMs, at most two CTAs per SM) walks every phase of an
// iteration, and cooperative_groups' grid.sync() separates the phases; five
// per iteration:
//
//   p = z + beta p, Ap = M^T M p, dot(p, Ap)
//                           one CTA per (system, tau) row (row_ops.cuh); the
//                           row builds its p rows l-1, l, l+1 on the fly from
//                           z and the previous p and writes row l (p
//                           ping-pongs between two planes)
//   r -= alpha Ap, x += alpha p, |r|^2, U = [Wre; Wim] r
//                           the first product stages r - alpha Ap as its
//                           right operand; the tiles of each system's first
//                           row block write r (ping-pong), x and |r|^2
//   Am = (U Q) * filt       (B 2Lh x N)(N x N)
//   Bm = Am Q^T             (Q^T row-major: Qt)
//   z = [Wre^T Wim^T] Bm, dot(r, z)
//
// The four products run on the tensor cores (mma.sync bf16, f32 sums) with
// U, Am, Bm in bf16 (pcg_common.cuh). Per-system dots are reduced per CTA
// (in double) into a (B, grid) partial array and summed in a fixed order, a
// warp per system, by every CTA after the next grid.sync, so every CTA holds
// the same alpha, beta and active mask without another sync, and a launch
// repeats its bits.
//
// What bounds it on the H100: the chain of dependent phases, each a few us of
// L2 traffic behind a grid-wide barrier; at the headline size (B = 2,
// Ltau = 240, N = 288) the products are ~75 M bf16 multiply-adds an
// iteration, well under a microsecond of tensor-core time, and the matvec
// rows are memory-bound as in K1.
//
// A timed instantiation (kTimed) stamps CTA 0's clock at every phase
// boundary (time_pcg.py reads them); the path's kernel has none.
//
// C interface (bound with ctypes from ops/pcg.py): returns a cudaError_t.

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace {

using namespace smoqy;

struct PcgArgs {
  const float* b;
  float* x;
  float* eps_out;
  int* iters_out;
  CbTables<float> tb;
  const __nv_bfloat16* W;   // (2 Lh, Ltau): antiperiodic DFT rows, real then imaginary
  const __nv_bfloat16* Wt;  // (Ltau, 2 Lh): W transposed
  const __nv_bfloat16* Q;   // (N, N) eigenvectors of Bbar
  const __nv_bfloat16* Qt;  // (N, N): Q transposed
  const float* filt;        // (Lh, N), pair factor folded in
  float* r;                 // (2, B, Ltau, N): ping-pong
  float* p;                 // (2, B, Ltau, N): ping-pong
  float* z;
  float* Ap;
  __nv_bfloat16* U;   // (B, 2 Lh, N)
  __nv_bfloat16* Am;  // (B, 2 Lh, N)
  __nv_bfloat16* Bm;  // (B, 2 Lh, N)
  double* part;       // (3, B, kMaxGrid)
  int B;
  int Ltau;
  int Lh;
  int N;
  float tol;
  int maxiter;
  unsigned long long* stamps;  // timed instantiation: (kStampHead + maxiter kStamps) clocks
};

// The phases of one iteration, in the order of the timed instantiation's
// stamps (smoqy_pcg_phases).
constexpr int kStamps = 14;
constexpr const char* kPhases =
    "mtm,sync_pAp,reduce_pAp,x_r_U,sync_U,reduce_rr,Am,sync_Am,Bm,sync_Bm,z,sync_z,reduce_rz";

template <bool kTimed>
__global__ void __launch_bounds__(smoqy::kThreads, smoqy::kCtasPerSm) pcg_kernel(PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  // the GEMM stages and the matvec row buffers alias: no phase uses both
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* rowA = reinterpret_cast<float*>(smem_raw);
  float* rowX = rowA + a.N;
  float* rowY = rowX + a.N;

  const int B = a.B, L = a.Ltau, N = a.N;
  const size_t plane = (size_t)L * N;
  const size_t planes = (size_t)B * plane;
  const int rows = B * L;
  const int tid = threadIdx.x;
  stamp_clock_pair<kTimed>(a.stamps, 0);

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
  reduce_parts(a, sh, kPartRR);
  for (int s = tid; s < B; s += blockDim.x) {
    sh.eps[s] = (float)sqrt(sh.sum[s]);
    sh.active[s] = sh.eps[s] >= a.tol;
  }
  __syncthreads();
  // z = P^{-1} r; the first iteration's p is z (beta = 0 over p = z)
  precond(a, grid, sh, sg, F32Src(a.r, plane, N, N), a.r, [] {}, [](int) {});
  reduce_parts(a, sh, kPartRZ);
  for (int s = tid; s < B; s += blockDim.x) {
    sh.rdotz[s] = (float)sh.sum[s];
    sh.beta[s] = 0.f;
  }

  int it = 0;
  while (true) {
    __syncthreads();
    int any = 0;
    for (int s = 0; s < B; ++s) any |= sh.active[s];
    if (!any || it >= a.maxiter) break;
    unsigned long long* ts = a.stamps + kStampHead + (size_t)it * kStamps;
    stamp<kTimed>(ts, 0);
    const float* p_prev = it == 0 ? a.z : a.p + (it & 1) * planes;
    float* p_cur = a.p + ((it + 1) & 1) * planes;
    const float* r_cur = a.r + (it & 1) * planes;
    float* r_next = a.r + ((it + 1) & 1) * planes;

    // p = z + beta p, Ap = M^T M p and dot(p, Ap), rows of active systems only
    zero_part(sh, B);
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int s = row / L;
      if (!sh.active[s]) continue;
      const float be = sh.beta[s];
      const float* zs = a.z + s * plane;
      const float* ps = p_prev + s * plane;
      float* prow = p_cur + (size_t)row * N;
      const int l = row % L;
      for (int n = tid; n < N; n += blockDim.x)
        prow[n] = p_next(zs[(size_t)l * N + n], be, ps[(size_t)l * N + n]);
      const float loc = smoqy::mtm_row_from<float>(
          a.tb,
          [=](int j, int n) { return p_next(zs[(size_t)j * N + n], be, ps[(size_t)j * N + n]); },
          a.Ap + (size_t)row * N, l, rowA, rowX, rowY, prow);
      const double t = smoqy::block_sum((double)loc, sh.red);
      if (tid == 0) sh.part[s] += t;
    }
    flush_part(a, sh, kPartPAp);
    stamp<kTimed>(ts, 1);
    grid.sync();
    stamp<kTimed>(ts, 2);
    reduce_parts(a, sh, kPartPAp);
    for (int s = tid; s < B; s += blockDim.x) {
      const float pAp = (float)sh.sum[s];
      sh.alpha[s] = sh.active[s] ? sh.rdotz[s] / (pAp != 0.f ? pAp : 1.f) : 0.f;
    }
    __syncthreads();
    stamp<kTimed>(ts, 3);

    // r -= alpha Ap, x += alpha p, |r|^2 inside the first product; after its
    // sync, eps and the mask of systems that go on
    const ResidualSrc rsrc(r_cur, r_next, a.x, a.Ap, p_cur, sh.alpha, sh.active, plane, N);
    precond(
        a, grid, sh, sg, rsrc, r_next,
        [&] {
          reduce_parts(a, sh, kPartRR);
          for (int s = tid; s < B; s += blockDim.x) {
            if (sh.active[s]) sh.eps[s] = (float)sqrt(sh.sum[s]);
            sh.on[s] = sh.active[s] && sh.eps[s] >= a.tol;
          }
          stamp<kTimed>(ts, 6);
        },
        [&](int k) { stamp<kTimed>(ts, 4 + k + (k >= 2)); });
    reduce_parts(a, sh, kPartRZ);
    for (int s = tid; s < B; s += blockDim.x) {
      const float nrz = (float)sh.sum[s];
      sh.beta[s] = sh.on[s] ? nrz / (sh.rdotz[s] != 0.f ? sh.rdotz[s] : 1.f) : 0.f;
      if (sh.on[s]) sh.rdotz[s] = nrz;
      sh.active[s] = sh.on[s];
    }
    ++it;
    stamp<kTimed>(ts, 13);
  }

  if (blockIdx.x == 0) {
    for (int s = tid; s < B; s += blockDim.x) a.eps_out[s] = sh.eps[s];
    if (tid == 0) *a.iters_out = it;
  }
  stamp_clock_pair<kTimed>(a.stamps, 2);
}

size_t pcg_smem_bytes(int N) {
  const size_t row = 3 * (size_t)N * sizeof(float);
  return kGemmSmem > row ? kGemmSmem : row;
}

int pcg_grid(int N, int* grid_out) {
  return cooperative_grid(pcg_kernel<false>, pcg_smem_bytes(N), grid_out);
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

// The timed instantiation's phase names (comma-separated) and stamps per iteration.
extern "C" const char* smoqy_pcg_phases() { return kPhases; }

extern "C" int smoqy_pcg_stamps_per_iteration() { return kStamps; }

extern "C" int smoqy_pcg(const float* b, float* x, float* eps, int* iters, const float* C,
                         const float* S, const int* partner, const float* expV, const void* W,
                         const void* Wt, const void* Q, const void* Qt, const float* filt,
                         float* work, double* part, int B, int Ltau, int Lh, int N, int n_colors,
                         int tab_rows, int symmetric,
                         float tol, int maxiter, void* stamps, void* stream) {
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
  a.Wt = static_cast<const __nv_bfloat16*>(Wt);
  a.Q = static_cast<const __nv_bfloat16*>(Q);
  a.Qt = static_cast<const __nv_bfloat16*>(Qt);
  a.filt = filt;
  const size_t plane = (size_t)B * Ltau * N;
  const size_t half = (size_t)B * 2 * Lh * N;  // bf16 elements
  a.r = work;
  a.p = work + 2 * plane;
  a.z = work + 4 * plane;
  a.Ap = work + 5 * plane;
  a.U = reinterpret_cast<__nv_bfloat16*>(work + 6 * plane);
  a.Am = a.U + half;
  a.Bm = a.Am + half;
  a.part = part;
  a.B = B;
  a.Ltau = Ltau;
  a.Lh = Lh;
  a.N = N;
  a.tol = tol;
  a.maxiter = maxiter;
  a.stamps = static_cast<unsigned long long*>(stamps);
  // the timed instantiation when stamps are given: the same grid (its
  // occupancy is the untimed one's or the launch is refused)
  const void* fn = stamps ? (const void*)pcg_kernel<true> : (const void*)pcg_kernel<false>;
  if (stamps && pcg_smem_bytes(N) > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(pcg_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)pcg_smem_bytes(N));
    if (e) return e;
  }
  void* args[] = {&a};
  cudaError_t ce = cudaLaunchCooperativeKernel(fn, dim3(g),
                                               dim3(smoqy::kThreads), args, pcg_smem_bytes(N),
                                               static_cast<cudaStream_t>(stream));
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
