// Kernel K1: the M^T M matvec of the fermion determinant matrix, f32 and f64.
//
// Replaces `_mtm_kernel_roll` (the JAX package's ops/pallas_fused.py:121, its
// pallas_call at :250) and, through the same code, `_mtm_kernel_mm` (:165):
// the TPU kernels decomposed the checkerboard gather into lane rolls or
// permutation matmuls; here any partner table is read as a list of pairs.
//
// M^T M v, row l:  m_l = v_l + sgn1_l B_l v_{l-1},
//                  out_l = m_l + sgnL_l B_{l+1}^T m_{l+1},
// sgn1 = +1 at tau 0 and sgnL = +1 at tau Ltau-1 (-1 elsewhere).
//
// What bounds it on the H100: memory (v in, out once, expV; ~1/3 of a
// microsecond at the headline, ~7 us at L=48 in f32), then shared memory: a
// B application is 2 n_colors (symmetric) or n_colors (asymmetric) color
// stages, each a gather of every site's partner, separated by barriers, and
// a row taken alone needs three B applications and its tables read again
// in every stage. The design:
//
// - tau blocks: a CTA takes T consecutive tau rows l0 .. l0+nr-1 of one
//   system and applies B to the nr+1 rows v_{l0-1} .. v_{l0+nr-1} and B^T to
//   the nr rows m_{l0+1} .. m_{l0+nr}: 2T+1 B applications where one row at a
//   time takes 3T, and every stage of the block behind one barrier. T is
//   chosen on the host (ops/mtm.py:tau_block_rows).
// - pairs, in place: a checkerboard color is a matching (each bond's two
//   sites share one cosh and one sinh), so a thread takes whole pairs (a, b),
//   reads u[a], u[b] and writes both back: no second row buffer, and a
//   block of T rows needs 2T+2 rows of shared memory (X: v, then B v, then m;
//   Y: v, then m_{j+1}, then B^T m_{j+1}). Sites a color leaves alone are
//   pairs (n, n) with cosh 1, sinh 0, so the expV scaling rides on a color
//   stage.
// The pair stages, the register and memory forms and the stamps are in
// pair_ops.cuh, shared with K4.
//
// - tables resident: a thread keeps the same pairs through every stage and
//   every row of its block. With tau-independent hoppings, up to 3 colors and
//   K <= 5 pairs a thread a color, their sites and (cosh, sinh) live in
//   registers for the whole launch (the register form, K a template
//   argument and each stage's color a compile-time index), read once from
//   device memory. Tau-dependent hoppings, more colors or more pairs take the
//   memory form (K = 0): a thread reads its pairs' sites and (cosh, sinh)
//   once a stage for all rows of the block (once a row where they depend on
//   tau). Pair tables are padded to K pairs a thread with pairs (N, N) on a
//   spare site of each row, so no stage tests a slot.
// - X = v_{l0-1} .. v_{l0+nr-1} and Y = v_{l0} .. v_{l0+nr} are staged by
//   cp.async (Y arrives while B runs; its rows are L2 hits), expV is read at
//   the pairs' sites in the stage that scales.
//
// A timed instantiation (kTimed) stamps clock64() after every phase of its
// block (the staging, each color stage, the m pass, the output pass) on CTA 0
// and on the last CTA to finish (ops/mtm.py:phase_names gives their names).
//
// C interface (bound with ctypes from ops/mtm.py): returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_ops.cuh"
#include "row_ops.cuh"

namespace {

using namespace smoqy::pairs;

constexpr int kMaxThreads = 512;

// xi <- yi + s1 xi on a row, and ym <- the same where given; the loads of 4
// elements first.
template <typename T>
__device__ __forceinline__ void m_row(T* xi, const T* yi, T* ym, T s1, int N) {
  for (int n0 = threadIdx.x; n0 < N; n0 += 4 * blockDim.x) {
    T vv[4], xv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = min(n0 + j * (int)blockDim.x, N - 1);
      vv[j] = yi[n];
      xv[j] = xi[n];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j * blockDim.x;
      if (n < N) {
        const T m = vv[j] + s1 * xv[j];
        xi[n] = m;
        if (ym != nullptr) ym[n] = m;
      }
    }
  }
}

// Rows first, first + 1, ... (mod L) of an (L, N) plane into dst, rows of ld.
template <typename T>
__device__ void stage_rows(T* dst, int ld, const T* plane, int first, int rows, int L, int N) {
  for (int i = 0, j = first; i < rows; ++i, j = j + 1 == L ? 0 : j + 1)
    smoqy::copy_async(dst + (size_t)i * ld, plane + (size_t)j * N, N);
}

// One CTA a tau block: system blockIdx.x / nblk, rows l0 .. l0+nr-1 with
// l0 = (blockIdx.x % nblk) * tau_rows.
template <typename T, int K, bool kTimed>
__global__ void __launch_bounds__(kMaxThreads)
mtm_kernel(const T* __restrict__ v, T* __restrict__ out, PairTabs<T> tb, int tau_rows, int nblk,
           unsigned long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long st_sh[kTimed ? kMaxStamps : 1];
  Stamps<kTimed> st;
  if constexpr (kTimed) st.sh = st_sh;
  st.start();
  const int N = tb.N, L = tb.Ltau, ld = tb.ld;
  const int sys = blockIdx.x / nblk;
  const int l0 = (blockIdx.x % nblk) * tau_rows;
  const int nr = min(tau_rows, L - l0);
  const T* vs = v + (size_t)sys * L * N;
  T* X = reinterpret_cast<T*>(smem_raw);  // nr + 1 rows of ld
  T* Y = X + (size_t)(nr + 1) * ld;       // nr + 1 rows of ld

  // X = v_{l0-1} .. v_{l0+nr-1} (waited for first), Y = v_{l0} .. v_{l0+nr}
  // (the m pass's v, arriving while B runs)
  stage_rows(X, ld, vs, smoqy::wrap_row(l0 + L - 1, L), nr + 1, L, N);
  smoqy::cp_async_commit();
  stage_rows(Y, ld, vs, l0, nr + 1, L, N);
  smoqy::cp_async_commit();
  RegTabs<T, K> r;
  if constexpr (K > 0) load_regs(tb, r);  // while the rows arrive
  smoqy::cp_async_wait<1>();
  __syncthreads();
  st.mark();

  apply_B(tb, r, X, nr + 1, l0, st);  // X[i] = B_{l0+i} v_{l0+i-1}
  smoqy::cp_async_wait<0>();
  __syncthreads();

  // X[i] = m_{l0+i} = v_{l0+i} + sgn1 X[i] and Y[i-1] = m_{l0+i}, Y[i]
  // holding v_{l0+i} (an element stays with its thread, so Y[i] is read
  // before it is overwritten)
  for (int i = 0; i <= nr; ++i) {
    const T s1 = (l0 + i == 0 || l0 + i == L) ? T(1) : T(-1);  // tau 0 (l0 + i <= L)
    m_row<T>(X + (size_t)i * ld, Y + (size_t)i * ld, i > 0 ? Y + (size_t)(i - 1) * ld : nullptr, s1, N);
  }
  __syncthreads();
  st.mark();

  apply_Bt(tb, r, Y, nr, l0 + 1, st);  // Y[i] = B_{l0+i+1}^T m_{l0+i+1}

  T* os = out + ((size_t)sys * L + l0) * N;
  for (int i = 0; i < nr; ++i) {
    const T sL = l0 + i == L - 1 ? T(1) : T(-1);
    const T* xi = X + (size_t)i * ld;
    const T* yi = Y + (size_t)i * ld;
    T* oi = os + (size_t)i * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) oi[n] = xi[n] + sL * yi[n];
  }
  st.mark();
  st.finish(stamps);
}

template <typename T>
size_t smem_bytes(int N, int tau_rows) {
  return (size_t)(2 * tau_rows + 2) * row_ld<T>(N) * sizeof(T);
}

template <typename T, bool kTimed>
const void* kernel_for(int K) {
  switch (K) {
    case 0: return (const void*)mtm_kernel<T, 0, kTimed>;
    case 1: return (const void*)mtm_kernel<T, 1, kTimed>;
    case 2: return (const void*)mtm_kernel<T, 2, kTimed>;
    case 3: return (const void*)mtm_kernel<T, 3, kTimed>;
    case 4: return (const void*)mtm_kernel<T, 4, kTimed>;
    case 5: return (const void*)mtm_kernel<T, 5, kTimed>;
    default: return nullptr;
  }
}

// K: the register form's pairs a thread a color (1 .. kMaxK), or 0 for the
// memory form; P pair slots a color, a multiple of threads.
template <typename T>
int launch_mtm(const T* v, T* out, const unsigned* ab, const T* C, const T* S, const T* expV,
               int n_sys, int Ltau, int N, int n_colors, int P, int tau_tabs, int symmetric,
               int tau_rows, int threads, int K, unsigned long long* stamps, cudaStream_t stream) {
  if (tau_rows < 1 || tau_rows > Ltau || threads < 32 || threads > kMaxThreads || threads % 32 ||
      P < threads || P % threads || N >= 0xffff ||
      (K > 0 && (tau_tabs || n_colors > kRegColors || K != P / threads)))
    return (int)cudaErrorInvalidValue;
  const void* fn = stamps ? kernel_for<T, true>(K) : kernel_for<T, false>(K);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  PairTabs<T> tb;
  tb.ab = ab;
  tb.C = C;
  tb.S = S;
  tb.expV = expV;
  tb.N = N;
  tb.ld = row_ld<T>(N);
  tb.Ltau = Ltau;
  tb.n_colors = n_colors;
  tb.P = P;
  tb.tau_tabs = tau_tabs;
  tb.symmetric = symmetric;
  const size_t smem = smem_bytes<T>(N, tau_rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nblk = (Ltau + tau_rows - 1) / tau_rows;
  void* args[] = {(void*)&v, (void*)&out, (void*)&tb, (void*)&tau_rows, (void*)&nblk, (void*)&stamps};
  cudaError_t e = cudaLaunchKernel(fn, dim3(n_sys * nblk), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int resident(int K, int threads, int smem) {
  const void* fn = kernel_for<T, false>(K);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

}  // namespace

extern "C" int smoqy_mtm_stamp_slots() { return kStampBase + 2 * kMaxStamps; }

extern "C" int smoqy_mtm_row_ld(int N, int f64) { return f64 ? row_ld<double>(N) : row_ld<float>(N); }

extern "C" int smoqy_mtm_smem_bytes(int N, int tau_rows, int f64) {
  return (int)(f64 ? smem_bytes<double>(N, tau_rows) : smem_bytes<float>(N, tau_rows));
}

// CTAs of K1 resident on the card at once for a launch of this form (the
// occupancy API times the SM count); negative: a CUDA error.
extern "C" int smoqy_mtm_resident(int f64, int K, int threads, int smem) {
  return f64 ? resident<double>(K, threads, smem) : resident<float>(K, threads, smem);
}

extern "C" int smoqy_mtm_f32(const float* v, float* out, const unsigned* ab, const float* C,
                             const float* S, const float* expV, int n_sys, int Ltau, int N,
                             int n_colors, int P, int tau_tabs, int symmetric, int tau_rows,
                             int threads, int K, void* stamps, void* stream) {
  return launch_mtm<float>(v, out, ab, C, S, expV, n_sys, Ltau, N, n_colors, P, tau_tabs,
                           symmetric, tau_rows, threads, K,
                           static_cast<unsigned long long*>(stamps),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int smoqy_mtm_f64(const double* v, double* out, const unsigned* ab, const double* C,
                             const double* S, const double* expV, int n_sys, int Ltau, int N,
                             int n_colors, int P, int tau_tabs, int symmetric, int tau_rows,
                             int threads, int K, void* stamps, void* stream) {
  return launch_mtm<double>(v, out, ab, C, S, expV, n_sys, Ltau, N, n_colors, P, tau_tabs,
                            symmetric, tau_rows, threads, K,
                            static_cast<unsigned long long*>(stamps),
                            static_cast<cudaStream_t>(stream));
}
