// Kernels K6, K7 and K8: the matrix-free KPM preconditioner apply,
//   y = sum_k c_k(f) T_k(Bbar') u   per frequency row f,  Bbar' = (Bbar - center) / half,
// with Bbar the tau-averaged propagator applied through its checkerboard.
//
// K6 (`kpm_mf_kernel`) replaces `_kpm_mf_kernel`
// (smoqyelphqmc_tpu/ops/pallas_fused.py:1186, its pallas_call at :1450):
// symmetric factorization, real coefficients, the re and im planes of each
// complex vector independent rows. K7 (`kpm_mf_asym_kernel`) replaces
// `_kpm_mf_asym_kernel` (:1243, pallas_call at :1427): asymmetric
// factorization, two passes (conj(c), then c) with the complex coefficient
// acting through the i-rotation (re, im) -> (-im, re), which mixes the two
// rows of one vector.
//
// What bounds them on the H100: the sequential depth, not bytes or
// operations. Device memory sees u once and y once (about 35 MB per apply at
// the L=48 slice, ~11 us at 3.35 TB/s), and the arithmetic is a few hundred
// MFLOP; but a frequency's recurrence is order-many steps, each a full
// Bbar application: 3 (asymmetric) or 6 (symmetric) checkerboard colors,
// each a gather over the whole row, separated by __syncthreads().
//
// What the design does about it:
// - one CTA per (row, frequency) for K6 and per (vector, frequency) for K7,
//   each running to its OWN live order (the TPU kernel bounded a block of
//   frequencies by the block's largest order);
// - CTAs are numbered in descending order of the frequency's order (through
//   the plan's sort permutation), so the long low-frequency recurrences start
//   first and the short ones fill in behind them;
// - t_cur lives in shared memory as a ping-pong pair (the gather needs the
//   whole row); t_prev, t_cur's own sites and y live in the registers of the
//   thread that owns the site, so a step touches device memory only for the
//   tables (L1/L2-resident) and one coefficient;
// - K7 keeps one complex vector in the CTA and runs both passes in-kernel:
//   pass 1's output is pass 2's input without a trip to device memory.
// The checkerboard is row_ops.cuh's `apply_B` on single-row tables
// (tau_stride 0), with expV / half as the diagonal; center / half is
// subtracted in the recurrence step, as the TPU kernels fold the affine map.
//
// K8 (`kpm_mf_cplx_kernel`) replaces `_kpm_mf_cplx_kernel` (:1307, its
// pallas_call at :1403): complex hopping amplitudes. Bbar is then complex and
// its checkerboard MIXES the (re, im) rows of one vector at every color,
//   re' = C re + S re[p] - S_im im[p],   im' = C im + S im[p] + S_im re[p],
// with the sign of S_im flipped on the second site of each pair (conj(s)).
// The symmetric factorization's Bbar = CB expV CB^H (applied as the colors
// reversed, the diagonal, the colors forward) is Hermitian: real
// coefficients, one pass. The asymmetric Bbar = expV CB (the colors forward,
// then the diagonal) takes K7's two conjugate passes with the i-rotation of
// the same row pair. Its design is K7's: one CTA per (vector,
// frequency), both rows ping-ponged in shared memory (each gather reads the
// partner site of BOTH rows), t_prev, t_cur and y of both rows in registers.
// Per site that is six floats per order step, so K8 takes 4, 8 or 16 sites
// per thread (512 threads at most) to keep the register tiles small at
// N = 1152 (288 threads of 4 sites) and refuses N above 16 x 512 = 8192.
// Like K6 and K7 it is bound by its depth, not by bytes: at N = 1152 an apply
// to two vectors moves ~9 MB (~3 us at 3.35 TB/s), while the longest
// symmetric recurrence runs ~60 orders of 6 barrier-separated stages (two
// color sweeps, the diagonal, the recurrence step).
//
// C interface (bound with ctypes from ops/kpm_mf.py): returns cudaGetLastError().

#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace {

constexpr int kK6MaxThreads = 1024;
constexpr int kK7MaxThreads = 512;
constexpr int kK6MaxSites = 16 * kK6MaxThreads;  // PER = 16
constexpr int kK7MaxSites = 16 * kK7MaxThreads;  // PER = 16
constexpr int kK8MaxThreads = 512;
constexpr int kK8MaxSites = 16 * kK8MaxThreads;  // PER = 16

__device__ __forceinline__ int site(int i) { return threadIdx.x + i * blockDim.x; }

// K6: one CTA per (row, frequency). Rows 0..B-1 are u_re's, B..2B-1 u_im's;
// blockIdx.x = rank * 2B + row, rank in the descending-order sort.
template <int PER>
__global__ void __launch_bounds__(kK6MaxThreads)
kpm_mf_kernel(const float* __restrict__ ure, const float* __restrict__ uim, float* __restrict__ yre,
              float* __restrict__ yim, smoqy::CbTables<float> tb, const float* __restrict__ coefs,
              const int* __restrict__ orders, const int* __restrict__ perm, float cih, int B, int F,
              int C_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* X = reinterpret_cast<float*>(smem_raw);
  float* Y = X + tb.N;
  const int N = tb.N;
  const int R = 2 * B;
  const int f = perm[blockIdx.x / R];
  const int row = blockIdx.x % R;
  const size_t off = ((size_t)(row % B) * F + f) * N;
  const float* u = (row < B ? ure : uim) + off;
  float* out = (row < B ? yre : yim) + off;
  const float* c = coefs + (size_t)f * C_pad;
  const int n_ord = orders[f];

  float tc[PER], tp[PER], y[PER];
  const float c0 = c[0];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    tc[i] = (n < N) ? u[n] : 0.f;
    tp[i] = 0.f;
    y[i] = c0 * tc[i];
    if (n < N) X[n] = tc[i];
  }
  __syncthreads();
  float* cur = X;
  for (int k = 1; k < n_ord; ++k) {
    // t_k = a Bbar' t_{k-1} - b t_{k-2}: (a, b) = (1, 0) at k = 1, else (2, 1)
    float* r = smoqy::apply_B(tb, 0, cur, smoqy::other_buf(cur, X, Y));
    const float a = (k == 1) ? 1.f : 2.f;
    const float b = (k == 1) ? 0.f : 1.f;
    const float ck = c[k];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = site(i);
      if (n < N) {
        const float tn = a * (r[n] - cih * tc[i]) - b * tp[i];
        tp[i] = tc[i];
        tc[i] = tn;
        r[n] = tn;
        y[i] += ck * tn;
      }
    }
    __syncthreads();
    cur = r;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    if (n < N) out[n] = y[i];
  }
}

// K7: one CTA per (vector, frequency); blockIdx.x = rank * B + vector.
template <int PER>
__global__ void __launch_bounds__(kK7MaxThreads)
kpm_mf_asym_kernel(const float* __restrict__ ure, const float* __restrict__ uim, float* __restrict__ yre,
                   float* __restrict__ yim, smoqy::CbTables<float> tb, const float* __restrict__ cre_tab,
                   const float* __restrict__ cim_tab, const int* __restrict__ orders,
                   const int* __restrict__ perm, float cih, int B, int F, int C_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xr = reinterpret_cast<float*>(smem_raw);
  float* Yr = Xr + tb.N;
  float* Xi = Yr + tb.N;
  float* Yi = Xi + tb.N;
  const int N = tb.N;
  const int f = perm[blockIdx.x / B];
  const size_t off = ((size_t)(blockIdx.x % B) * F + f) * N;
  const float* cr = cre_tab + (size_t)f * C_pad;
  const float* ci = cim_tab + (size_t)f * C_pad;
  const int n_ord = orders[f];

  float tcr[PER], tci[PER], tpr[PER], tpi[PER], yr[PER], yi[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    yr[i] = (n < N) ? ure[off + n] : 0.f;
    yi[i] = (n < N) ? uim[off + n] : 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0 applies conj(c), pass 1 applies c to pass 0's output (in y)
    const float s = pass == 0 ? -1.f : 1.f;
    const float c0r = cr[0], c0i = s * ci[0];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = site(i);
      tcr[i] = yr[i];
      tci[i] = yi[i];
      tpr[i] = 0.f;
      tpi[i] = 0.f;
      // y = c t + s c_im i t, i t = (-t_im, t_re)
      yr[i] = c0r * tcr[i] - c0i * tci[i];
      yi[i] = c0r * tci[i] + c0i * tcr[i];
      if (n < N) {
        Xr[n] = tcr[i];
        Xi[n] = tci[i];
      }
    }
    __syncthreads();
    float* cur_r = Xr;
    float* cur_i = Xi;
    for (int k = 1; k < n_ord; ++k) {
      float* rr = smoqy::apply_B(tb, 0, cur_r, smoqy::other_buf(cur_r, Xr, Yr));
      float* ri = smoqy::apply_B(tb, 0, cur_i, smoqy::other_buf(cur_i, Xi, Yi));
      const float a = (k == 1) ? 1.f : 2.f;
      const float b = (k == 1) ? 0.f : 1.f;
      const float ckr = cr[k], cki = s * ci[k];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int n = site(i);
        if (n < N) {
          const float nr = a * (rr[n] - cih * tcr[i]) - b * tpr[i];
          const float ni = a * (ri[n] - cih * tci[i]) - b * tpi[i];
          tpr[i] = tcr[i];
          tpi[i] = tci[i];
          tcr[i] = nr;
          tci[i] = ni;
          rr[n] = nr;
          ri[n] = ni;
          yr[i] += ckr * nr - cki * ni;
          yi[i] += ckr * ni + cki * nr;
        }
      }
      __syncthreads();
      cur_r = rr;
      cur_i = ri;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    if (n < N) {
      yre[off + n] = yr[i];
      yim[off + n] = yi[i];
    }
  }
}

// K8's single-row tables: the checkerboard planes with S_im, and expV / half.
struct PairTables {
  const float* C;        // (n_colors, N)
  const float* S;        // (n_colors, N)
  const float* S_im;     // (n_colors, N), the pair's side sign folded in
  const int* partner;    // (n_colors, N)
  const float* expVih;   // (N,) expV / half
  int N;
  int n_colors;
};

// One sweep of the channel-mixing checkerboard over the row pair (xr, xi)
// in shared memory, colors in order or reversed (the adjoint). On return
// (xr, xi) point at the result and (yr, yi) at the scratch rows;
// synchronised.
__device__ __forceinline__ void pair_sweep(const PairTables& tb, float*& xr, float*& xi, float*& yr, float*& yi,
                                           bool reverse) {
  for (int i = 0; i < tb.n_colors; ++i) {
    const int c = reverse ? tb.n_colors - 1 - i : i;
    const float* Cc = tb.C + (size_t)c * tb.N;
    const float* Sc = tb.S + (size_t)c * tb.N;
    const float* Ic = tb.S_im + (size_t)c * tb.N;
    const int* pc = tb.partner + (size_t)c * tb.N;
    for (int n = threadIdx.x; n < tb.N; n += blockDim.x) {
      const int p = pc[n];
      const float pr = xr[p], pi = xi[p];
      yr[n] = Cc[n] * xr[n] + Sc[n] * pr - Ic[n] * pi;
      yi[n] = Cc[n] * xi[n] + Sc[n] * pi + Ic[n] * pr;
    }
    __syncthreads();
    float* t = xr;
    xr = yr;
    yr = t;
    t = xi;
    xi = yi;
    yi = t;
  }
}

// (xr, xi) <- (Bbar / half)(xr, xi): CB (expV / half) CB^H (kSym: the colors
// reversed, the diagonal, the colors forward) or (expV / half) CB (the colors
// forward, the diagonal); the input must be complete in shared memory.
template <bool kSym>
__device__ __forceinline__ void apply_bbar_pair(const PairTables& tb, float*& xr, float*& xi, float*& yr,
                                                float*& yi) {
  pair_sweep(tb, xr, xi, yr, yi, /*reverse=*/kSym);
  for (int n = threadIdx.x; n < tb.N; n += blockDim.x) {
    xr[n] *= tb.expVih[n];
    xi[n] *= tb.expVih[n];
  }
  __syncthreads();
  if (kSym) pair_sweep(tb, xr, xi, yr, yi, false);
}

// K8: one CTA per (complex vector, frequency); blockIdx.x = rank * B + vector.
template <int PER, bool kSym>
__global__ void __launch_bounds__(kK8MaxThreads)
kpm_mf_cplx_kernel(const float* __restrict__ ure, const float* __restrict__ uim, float* __restrict__ yre,
                   float* __restrict__ yim, PairTables tb, const float* __restrict__ cre_tab,
                   const float* __restrict__ cim_tab, const int* __restrict__ orders,
                   const int* __restrict__ perm, float cih, int B, int F, int C_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = tb.N;
  float* Xr = reinterpret_cast<float*>(smem_raw);
  float* Yr = Xr + N;
  float* Xi = Yr + N;
  float* Yi = Xi + N;
  const int f = perm[blockIdx.x / B];
  const size_t off = ((size_t)(blockIdx.x % B) * F + f) * N;
  const float* cr = cre_tab + (size_t)f * C_pad;
  const float* ci = cim_tab + (size_t)f * C_pad;
  const int n_ord = orders[f];

  float tcr[PER], tci[PER], tpr[PER], tpi[PER], yr[PER], yi[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    yr[i] = (n < N) ? ure[off + n] : 0.f;
    yi[i] = (n < N) ? uim[off + n] : 0.f;
  }
  // symmetric: one pass with real coefficients; asymmetric: conj(c), then c
  // applied to the first pass's output (in y)
  for (int pass = 0; pass < (kSym ? 1 : 2); ++pass) {
    const float s = kSym ? 0.f : (pass == 0 ? -1.f : 1.f);
    const float c0r = cr[0], c0i = s * ci[0];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = site(i);
      tcr[i] = yr[i];
      tci[i] = yi[i];
      tpr[i] = 0.f;
      tpi[i] = 0.f;
      // y = c t + s c_im i t, i t = (-t_im, t_re)
      yr[i] = c0r * tcr[i] - c0i * tci[i];
      yi[i] = c0r * tci[i] + c0i * tcr[i];
      if (n < N) {
        Xr[n] = tcr[i];
        Xi[n] = tci[i];
      }
    }
    __syncthreads();
    float* xr = Xr;
    float* xi = Xi;
    float* sr = Yr;
    float* si = Yi;
    for (int k = 1; k < n_ord; ++k) {
      apply_bbar_pair<kSym>(tb, xr, xi, sr, si);
      const float a = (k == 1) ? 1.f : 2.f;
      const float b = (k == 1) ? 0.f : 1.f;
      const float ckr = cr[k], cki = s * ci[k];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int n = site(i);
        if (n < N) {
          const float nr = a * (xr[n] - cih * tcr[i]) - b * tpr[i];
          const float ni = a * (xi[n] - cih * tci[i]) - b * tpi[i];
          tpr[i] = tcr[i];
          tpi[i] = tci[i];
          tcr[i] = nr;
          tci[i] = ni;
          xr[n] = nr;
          xi[n] = ni;
          yr[i] += ckr * nr - cki * ni;
          yi[i] += ckr * ni + cki * nr;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = site(i);
    if (n < N) {
      yre[off + n] = yr[i];
      yim[off + n] = yi[i];
    }
  }
}

smoqy::CbTables<float> single_row_tables(const float* C, const float* S, const int* partner,
                                         const float* expVih, int N, int n_colors, int symmetric) {
  smoqy::CbTables<float> tb;
  tb.C = C;
  tb.S = S;
  tb.partner = partner;
  tb.expV = expVih;
  tb.N = N;
  tb.Ltau = 1;
  tb.n_colors = n_colors;
  tb.tau_stride = 0;
  tb.color_stride = N;
  tb.symmetric = symmetric;
  return tb;
}

int threads_for(int N, int per) {
  const int t = (N + per - 1) / per;
  return ((t + 31) / 32) * 32;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int PER>
int launch_k6(const float* ure, const float* uim, float* yre, float* yim, smoqy::CbTables<float> tb,
              const float* coefs, const int* orders, const int* perm, float cih, int B, int F, int C_pad,
              cudaStream_t stream) {
  const size_t smem = 2 * (size_t)tb.N * sizeof(float);
  cudaError_t e = allow_smem(kpm_mf_kernel<PER>, smem);
  if (e != cudaSuccess) return (int)e;
  kpm_mf_kernel<PER><<<F * 2 * B, threads_for(tb.N, PER), smem, stream>>>(ure, uim, yre, yim, tb, coefs, orders,
                                                                           perm, cih, B, F, C_pad);
  return (int)cudaGetLastError();
}

template <int PER, bool kSym>
int launch_k8(const float* ure, const float* uim, float* yre, float* yim, const PairTables& tb, const float* cre,
              const float* cim, const int* orders, const int* perm, float cih, int B, int F, int C_pad,
              cudaStream_t stream) {
  const size_t smem = 4 * (size_t)tb.N * sizeof(float);
  cudaError_t e = allow_smem(kpm_mf_cplx_kernel<PER, kSym>, smem);
  if (e != cudaSuccess) return (int)e;
  kpm_mf_cplx_kernel<PER, kSym><<<F * B, threads_for(tb.N, PER), smem, stream>>>(ure, uim, yre, yim, tb, cre, cim,
                                                                               orders, perm, cih, B, F, C_pad);
  return (int)cudaGetLastError();
}

template <bool kSym>
int dispatch_k8(const float* ure, const float* uim, float* yre, float* yim, const PairTables& tb, const float* cre,
                const float* cim, const int* orders, const int* perm, float cih, int B, int F, int C_pad,
                cudaStream_t st) {
  if (tb.N <= 4 * kK8MaxThreads)
    return launch_k8<4, kSym>(ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad, st);
  if (tb.N <= 8 * kK8MaxThreads)
    return launch_k8<8, kSym>(ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad, st);
  if (tb.N <= kK8MaxSites)
    return launch_k8<16, kSym>(ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int smoqy_kpm_mf_max_sites(int symmetric) { return symmetric ? kK6MaxSites : kK7MaxSites; }

extern "C" int smoqy_kpm_mf(const float* ure, const float* uim, float* yre, float* yim, const float* C,
                            const float* S, const int* partner, const float* expVih, const float* coefs,
                            const int* orders, const int* perm, float cih, int B, int F, int N, int n_colors,
                            int C_pad, void* stream) {
  const smoqy::CbTables<float> tb = single_row_tables(C, S, partner, expVih, N, n_colors, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 8 * kK6MaxThreads) return launch_k6<8>(ure, uim, yre, yim, tb, coefs, orders, perm, cih, B, F, C_pad, st);
  if (N <= kK6MaxSites) return launch_k6<16>(ure, uim, yre, yim, tb, coefs, orders, perm, cih, B, F, C_pad, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int smoqy_kpm_mf_asym(const float* ure, const float* uim, float* yre, float* yim, const float* C,
                                 const float* S, const int* partner, const float* expVih, const float* cre,
                                 const float* cim, const int* orders, const int* perm, float cih, int B, int F,
                                 int N, int n_colors, int C_pad, void* stream) {
  if (N > kK7MaxSites) return (int)cudaErrorInvalidValue;
  const smoqy::CbTables<float> tb = single_row_tables(C, S, partner, expVih, N, n_colors, 0);
  const size_t smem = 4 * (size_t)N * sizeof(float);
  cudaError_t e = allow_smem(kpm_mf_asym_kernel<16>, smem);
  if (e != cudaSuccess) return (int)e;
  kpm_mf_asym_kernel<16><<<F * B, threads_for(N, 16), smem, static_cast<cudaStream_t>(stream)>>>(
      ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad);
  return (int)cudaGetLastError();
}

extern "C" int smoqy_kpm_mf_cplx_max_sites() { return kK8MaxSites; }

extern "C" int smoqy_kpm_mf_cplx(const float* ure, const float* uim, float* yre, float* yim, const float* C,
                                 const float* S, const float* S_im, const int* partner, const float* expVih,
                                 const float* cre, const float* cim, const int* orders, const int* perm, float cih,
                                 int symmetric, int B, int F, int N, int n_colors, int C_pad, void* stream) {
  const PairTables tb{C, S, S_im, partner, expVih, N, n_colors};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (symmetric) return dispatch_k8<true>(ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad, st);
  return dispatch_k8<false>(ure, uim, yre, yim, tb, cre, cim, orders, perm, cih, B, F, C_pad, st);
}
