// Kernel K3: the whole spectral-preconditioned CG solve with an in-kernel warm
// start, followed by the Holstein force epilogue, for W walkers in one launch.
//
// Replaces `_pcg_force_kernel` (the JAX package's ops/pallas_fused.py:620, its
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
// preconditioner's products on the tensor cores; the x/r update riding on
// the first product) with K2's loop of five grid syncs an iteration:
//
//   p = z + beta p, Ap = M^T M p, dot(p, Ap)
//                  tau blocks (row_ops.cuh:mtm_rows_block): a CTA takes T
//                  consecutive tau rows of one system, builds p rows
//                  l0-1 .. l0+T from z and the previous p as it stages them
//                  (p ping-pongs), writes its T rows of p and Ap
//   r -= alpha Ap, x += alpha p, |r|^2, U = [Wre; Wim] r     (ResidualSrc)
//   Am = (U Q) * filt,  Bm = Am Q^T,  z = [Wre^T Wim^T] Bm, dot(r, z)
//
// Before the loop: |b|^2 and x = x0; r = b - M^T M x0 on the same tau blocks;
// the first preconditioner apply; its p is z (beta = 0). After it, once the
// loop's last grid.sync has published x, every CTA takes (walker, tau) rows
// and runs force_epilogue.cuh on them, recomputing the neighbour rows it
// needs, so the epilogue adds no grid sync and no scratch plane.
//
// What bounds it on the H100: the chain of dependent phases behind grid
// syncs, as in K2. At W = 8 the matvec is 3840 rows: one row a CTA took 26
// barriers and three B applications, each stage 1-2 elements a thread with
// the tables read from L2; a block of T rows takes 2T + 1 B applications, all
// its rows in each stage between one pair of barriers. A thread runs down
// all rows of its sites, so it reads a site's tables once a stage, and every
// read of device memory the block makes (its rows of z and the previous p,
// or of x0, and of expV) is a cp.async issued before its first stage. (A
// thread that took the block's elements in row order spent ~45 instructions
// an element on indices and table reads: MtM and its wait cost ~60 us an
// iteration at W = 8, however the reads were arranged.) The host picks T
// (ops/pcg_force.py:tau_block_rows) so that the blocks make about one round
// of the grid with two CTAs an SM. The products (2 x 37 M bf16 multiply-adds per
// system and iteration at Ltau = 240, N = 288) are eight times K2's tiles at
// W = 8, ~4.5 per CTA. The epilogue is one pass over W Ltau rows.
//
// A timed instantiation (kTimed) stamps CTA 0's clock at every phase
// boundary (time_pcg.py reads them); the path's kernel has none.
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
  float* r;  // (2, B, Ltau, N): ping-pong
  float* p;  // (2, B, Ltau, N): ping-pong
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
  int tau_block;  // T: tau rows a CTA takes in the matvec phases
  float tol;
  int maxiter;
  int want_p2;
  unsigned long long* stamps;  // timed instantiation: kStampHead + kOnce + maxiter kStamps clocks
};

__device__ __forceinline__ CbTables<float> walker_tables(const CbTables<float>& tb, int w) {
  CbTables<float> t = tb;
  t.expV += (size_t)w * t.Ltau * t.N;
  return t;
}

// The timed instantiation's stamps (smoqy_pcg_force_once_phases,
// smoqy_pcg_force_phases): the phases before the loop, the loop, the
// epilogue, each ending at a stamp after the kernel's start; then kStamps a
// loop iteration, from its start.
constexpr int kOnce = 15;
constexpr const char* kOncePhases =
    "b2,warm_mtm,sync_r,reduce_r,U,sync_U,Am,sync_Am,Bm,sync_Bm,z,sync_z,reduce_rz,loop,epilogue";
constexpr int kStamps = 14;
constexpr const char* kPhases =
    "mtm,sync_pAp,reduce_pAp,x_r_U,sync_U,reduce_rr,Am,sync_Am,Bm,sync_Bm,z,sync_z,reduce_rz";

template <bool kTimed>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) pcg_force_kernel(PcgForceArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  __shared__ float tolc[kMaxSystems];
  __shared__ float normb[kMaxSystems];
  __shared__ int wit[kMaxSystems / 2];
  // GEMM stages, tau-block rows and epilogue rows alias: no phase uses two of them
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* rows_buf = reinterpret_cast<float*>(smem_raw);

  const int B = a.B, L = a.Ltau, N = a.N, nw = a.B / 2, T = a.tau_block;
  const size_t plane = (size_t)L * N;
  const size_t planes = (size_t)B * plane;
  const int per_sys = (L + T - 1) / T;
  const int blocks = B * per_sys;
  const int tid = threadIdx.x;
  unsigned long long* once = a.stamps + kStampHead;
  stamp_clock_pair<kTimed>(a.stamps, 0);

  // |b|^2 and x = x0 (partials in the PAp slot) ...
  zero_part(sh, B);
  for (int row = blockIdx.x; row < B * L; row += gridDim.x) {
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
  stamp<kTimed>(once, 0);
  // ... then r = b - M^T M x0 and |r|^2 (RR slot) on tau blocks; both read only b and x0
  zero_part(sh, B);
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int s = blk / per_sys, l0 = (blk % per_sys) * T;
    const float* xs = a.x0 + s * plane;
    const float* bs = a.b + s * plane;
    float* rs = a.r + s * plane;
    const double loc = mtm_rows_block<float>(
        walker_tables(a.tb, s >> 1), xs, nullptr, [](float v, float) { return v; }, l0,
        min(T, L - l0), rows_buf, [=](int j, int n, float o, float) {
          const size_t i = (size_t)j * N + n;
          const float rn = bs[i] - o;
          rs[i] = rn;
          return (double)rn * rn;
        });
    const double t = block_sum(loc, sh.red);
    if (tid == 0) sh.part[s] += t;
  }
  flush_part(a, sh, kPartRR);
  stamp<kTimed>(once, 1);
  grid.sync();
  stamp<kTimed>(once, 2);
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
  stamp<kTimed>(once, 3);
  // z = P^{-1} r; the first iteration's p is z (beta = 0 over p = z)
  precond(a, grid, sh, sg, F32Src(a.r, plane, N, N), a.r, [] {},
          [&](int k) { stamp<kTimed>(once, 4 + k); });
  reduce_parts(a, sh, kPartRZ);
  for (int s = tid; s < B; s += blockDim.x) {
    sh.rdotz[s] = (float)sh.sum[s];
    sh.beta[s] = 0.f;
  }
  stamp<kTimed>(once, 12);

  int it = 0;
  while (true) {
    __syncthreads();
    int any = 0;
    for (int s = 0; s < B; ++s) any |= sh.active[s];
    if (!any || it >= a.maxiter) break;
    for (int w = tid; w < nw; w += blockDim.x) wit[w] += sh.active[2 * w] | sh.active[2 * w + 1];
    unsigned long long* ts = a.stamps + kStampHead + kOnce + (size_t)it * kStamps;
    stamp<kTimed>(ts, 0);
    const float* p_prev = it == 0 ? a.z : a.p + (it & 1) * planes;
    float* p_cur = a.p + ((it + 1) & 1) * planes;
    const float* r_cur = a.r + (it & 1) * planes;
    float* r_next = a.r + ((it + 1) & 1) * planes;

    // p = z + beta p, Ap = M^T M p and dot(p, Ap): tau blocks of active systems
    zero_part(sh, B);
    for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
      const int s = blk / per_sys;
      if (!sh.active[s]) continue;
      const int l0 = (blk % per_sys) * T;
      const float be = sh.beta[s];
      float* pc = p_cur + s * plane;
      float* aps = a.Ap + s * plane;
      const double loc = mtm_rows_block<float>(
          walker_tables(a.tb, s >> 1), a.z + s * plane, p_prev + s * plane,
          [=](float z, float p) { return p_next(z, be, p); }, l0, min(T, L - l0), rows_buf,
          [=](int j, int n, float o, float w) {
            const size_t i = (size_t)j * N + n;
            pc[i] = w;
            aps[i] = o;
            return (double)w * o;
          });
      const double t = block_sum(loc, sh.red);
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
            sh.on[s] = sh.active[s] && sh.eps[s] >= tolc[s];
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
  stamp<kTimed>(once, 13);

  // the force epilogue on the solution: one (walker, tau) row per CTA step
  for (int row = blockIdx.x; row < nw * L; row += gridDim.x) {
    const int w = row / L;
    force_row(walker_tables(a.tb, w), a.x + 2 * w * plane, a.Lam + w * plane, row % L,
              a.want_p2 != 0, rows_buf, a.P1 + (size_t)row * N, a.P2 + (size_t)row * N);
  }
  stamp<kTimed>(once, 14);

  if (blockIdx.x == 0) {
    for (int s = tid; s < B; s += blockDim.x) a.eps_out[s] = sh.eps[s] / fmaxf(normb[s], kTiny);
    for (int w = tid; w < nw; w += blockDim.x) a.iters_out[w] = wit[w];
  }
  stamp_clock_pair<kTimed>(a.stamps, 2);
}

// Dynamic shared memory: the GEMM stages, the epilogue's rows or a tau
// block's rows, whichever is largest (ops/pcg_force.py:smem_bytes mirrors it).
size_t pcg_force_smem_bytes(int N, int T) {
  const int rows = mtm_block_rows(T) > kForceRows ? mtm_block_rows(T) : kForceRows;
  const size_t bytes = (size_t)rows * N * sizeof(float);
  return bytes > kGemmSmem ? bytes : kGemmSmem;
}

int pcg_force_grid(int N, int T, int* grid_out) {
  return cooperative_grid(pcg_force_kernel<false>, pcg_force_smem_bytes(N, T), grid_out);
}

}  // namespace

// CTAs of the cooperative launch for N sites and tau blocks of T rows (or a
// negative cudaError_t). The partial array must hold 3 * smoqy_pcg_max_grid() * B doubles.
extern "C" int smoqy_pcg_force_grid(int N, int tau_block) {
  int g = 0;
  const int e = pcg_force_grid(N, tau_block, &g);
  return e ? -e : g;
}

// The launch's dynamic shared memory in bytes.
extern "C" int smoqy_pcg_force_smem_bytes(int N, int tau_block) {
  return (int)pcg_force_smem_bytes(N, tau_block);
}

// The timed instantiation's phase names (comma-separated) and stamps.
extern "C" const char* smoqy_pcg_force_once_phases() { return kOncePhases; }

extern "C" const char* smoqy_pcg_force_phases() { return kPhases; }

extern "C" int smoqy_pcg_force_stamps_per_iteration() { return kStamps; }

extern "C" int smoqy_pcg_force(const float* b, const float* x0, const float* Lam, float* x,
                               float* P1, float* P2, float* eps, int* iters, const float* C,
                               const float* S, const int* partner, const float* expV,
                               const void* W, const void* Wt, const void* Q, const void* Qt,
                               const float* filt, float* work,
                               double* part, int n_walkers, int Ltau, int Lh, int N,
                               int n_colors, int tab_rows, int tau_block, float tol, int maxiter,
                               int want_p2, void* stamps, void* stream) {
  const int B = 2 * n_walkers;
  if (n_walkers < 1 || B > kMaxSystems || n_colors < 1 || tau_block < 1 || tau_block > Ltau)
    return (int)cudaErrorInvalidValue;
  int g = 0;
  int e = pcg_force_grid(N, tau_block, &g);
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
  a.tau_block = tau_block;
  const size_t smem = pcg_force_smem_bytes(N, tau_block);
  a.tol = tol;
  a.maxiter = maxiter;
  a.want_p2 = want_p2;
  a.stamps = static_cast<unsigned long long*>(stamps);
  // the timed instantiation when stamps are given, on the same grid
  const void* fn = stamps ? (const void*)pcg_force_kernel<true> : (const void*)pcg_force_kernel<false>;
  if (stamps && smem > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(pcg_force_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e) return e;
  }
  void* args[] = {&a};
  cudaError_t ce = cudaLaunchCooperativeKernel(fn, dim3(g), dim3(kThreads), args, smem,
                                               static_cast<cudaStream_t>(stream));
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
