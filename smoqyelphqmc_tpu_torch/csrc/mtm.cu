// Kernel K1: the M^T M matvec of the fermion determinant matrix, f32 and f64.
//
// Replaces `_mtm_kernel_roll` (smoqyelphqmc_tpu/ops/pallas_fused.py:121, its
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

#include "row_ops.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRegColors = 3;  // colors whose tables the register form holds
constexpr int kMaxK = 5;       // pairs a thread a color in the register form

template <typename T>
struct PairTabs {
  const unsigned* ab;  // (n_colors, P): sites a | b << 16 of each pair; padding a = b = N
  const T* C;          // (n_colors, rows, P) cosh of the pair's bond
  const T* S;          // (n_colors, rows, P) sinh
  const T* expV;       // (Ltau, ld) exp(-dtau V), 1 in the padding columns
  int N;
  int ld;  // row stride in shared memory and of expV: > N (site N is the padding's)
  int Ltau;
  int n_colors;
  int P;         // pair slots a color: K * blockDim.x
  int tau_tabs;  // 1: rows == Ltau (tau-dependent hoppings), 0: rows == 1
  int symmetric;  // 1: B = CB^T D CB (applied CB^T first); 0: B = D CB, B^T = CB^T D
};

// ---- the timed instantiation's stamps ---------------------------------------
//
// pcg_common.cuh's stamps write CTA 0's clocks straight to memory; K1's grid
// can run in more than one round (f64 at L=48), so it also records the last
// CTA to finish, which keeps its clocks in shared memory until it knows.
// Layout of the int64 stamp buffer (zeroed by the host): slots 0-3 CTA 0's
// globaltimer and clock64 at its start and end, 4-7 the same for the last CTA
// to finish, 8 the finish counter, 9 that CTA's index, then kMaxStamps clocks
// of CTA 0 (one at the end of each phase) and kMaxStamps of the last CTA.
constexpr int kStampBase = 10;
constexpr int kMaxStamps = 64;

template <bool kTimed>
struct Stamps {
  __device__ void start() {}
  __device__ void mark() {}
  __device__ void finish(unsigned long long*) {}
};

template <>
struct Stamps<true> {
  unsigned long long* sh;  // kMaxStamps clocks in shared memory
  int n = 0;
  unsigned long long g0 = 0, c0 = 0;

  __device__ static unsigned long long gtime() {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    return g;
  }
  __device__ void start() {
    __syncthreads();
    if (threadIdx.x == 0) {
      g0 = gtime();
      c0 = clock64();
    }
  }
  __device__ void mark() {
    __syncthreads();
    if (threadIdx.x == 0 && n < kMaxStamps) sh[n] = clock64();
    ++n;
  }
  __device__ void finish(unsigned long long* t) {
    __syncthreads();
    if (threadIdx.x != 0) return;
    const unsigned long long g1 = gtime(), c1 = clock64();
    const unsigned long long head[4] = {g0, c0, g1, c1};
    const unsigned long long done = atomicAdd(reinterpret_cast<unsigned long long*>(t + 8), 1ull);
    const int m = n < kMaxStamps ? n : kMaxStamps;
    if (blockIdx.x == 0) {
      for (int i = 0; i < 4; ++i) t[i] = head[i];
      for (int i = 0; i < m; ++i) t[kStampBase + i] = sh[i];
    }
    if (done == gridDim.x - 1) {
      for (int i = 0; i < 4; ++i) t[4 + i] = head[i];
      t[9] = blockIdx.x;
      for (int i = 0; i < m; ++i) t[kStampBase + kMaxStamps + i] = sh[i];
    }
  }
};

// ---- pair stages --------------------------------------------------------------
//
// A thread owns the pairs q = threadIdx.x + k blockDim.x (k < K) of every
// color. A stage updates (u[a], u[b]) <- the bond's 2x2 block times (u[a],
// u[b]) on each row of the block, all loads of a group of pairs before any
// store (the compiler would not move a load above a store to the same
// buffer). Padding slots update the spare site N of each row, which nothing
// reads. expV rides on a stage: after the block (kAfter) or before it
// (kBefore).

enum Scale { kNone = 0, kAfter = 1, kBefore = 2 };

template <typename T, int G, int SC>
__device__ __forceinline__ void pair_group(T* u, const T* E, const unsigned* ab, const T* cv,
                                           const T* sv) {
  T ua[G], ub[G], ea[G], eb[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int a = ab[j] & 0xffffu, b = ab[j] >> 16;
    ua[j] = u[a];
    ub[j] = u[b];
    if (SC != kNone) {
      ea[j] = __ldg(E + a);
      eb[j] = __ldg(E + b);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int a = ab[j] & 0xffffu, b = ab[j] >> 16;
    T xa = ua[j], xb = ub[j];
    if (SC == kBefore) {
      xa *= ea[j];
      xb *= eb[j];
    }
    T ta = cv[j] * xa + sv[j] * xb;
    T tb = cv[j] * xb + sv[j] * xa;
    if (SC == kAfter) {
      ta *= ea[j];
      tb *= eb[j];
    }
    u[a] = ta;
    u[b] = tb;
  }
}

// The register form's tables: a thread's K pairs of each of the first
// kRegColors colors, read once a launch.
template <typename T, int K>
struct RegTabs {
  unsigned ab[kRegColors][K > 0 ? K : 1];
  T c[kRegColors][K > 0 ? K : 1];
  T s[kRegColors][K > 0 ? K : 1];
};

template <typename T, int K>
__device__ void load_regs(const PairTabs<T>& tb, RegTabs<T, K>& r) {
  const unsigned spare = (unsigned)tb.N | ((unsigned)tb.N << 16);
#pragma unroll
  for (int c = 0; c < kRegColors; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const size_t i = (size_t)c * tb.P + threadIdx.x + k * blockDim.x;
      const bool has = c < tb.n_colors;
      r.ab[c][k] = has ? __ldg(tb.ab + i) : spare;
      r.c[c][k] = has ? __ldg(tb.C + i) : T(0);
      r.s[c][k] = has ? __ldg(tb.S + i) : T(0);
    }
  }
}

// Color CC (compile time, so the tables stay in registers) on nrows rows of
// U, row i at tau (tau0 + i) mod Ltau.
template <typename T, int K, int CC, int SC>
__device__ __forceinline__ void reg_stage(const PairTabs<T>& tb, const RegTabs<T, K>& r, T* U,
                                          int nrows, int tau0) {
  constexpr int G = K <= 3 ? K : (K + 1) / 2;  // pairs whose loads go first
  for (int i = 0; i < nrows; ++i) {
    T* u = U + (size_t)i * tb.ld;
    const T* E = tb.expV + (size_t)smoqy::wrap_row(tau0 + i, tb.Ltau) * tb.ld;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += G) {
      constexpr int kLast = K % G == 0 ? G : K % G;
      if (k0 + G <= K) {
        pair_group<T, G, SC>(u, E, r.ab[CC] + k0, r.c[CC] + k0, r.s[CC] + k0);
      } else {
        pair_group<T, kLast, SC>(u, E, r.ab[CC] + k0, r.c[CC] + k0, r.s[CC] + k0);
      }
    }
  }
}

// The memory form (K = 0): any number of colors, tau-dependent tables; a
// thread reads its pairs' sites and (cosh, sinh) once a stage (once a row
// where they depend on tau), Km pairs of them.
template <typename T>
__device__ void mem_stage(const PairTabs<T>& tb, int c, int scale, T* U, int nrows, int tau0) {
  constexpr int G = 4;
  const int Km = tb.P / blockDim.x;
  const int rows = tb.tau_tabs ? tb.Ltau : 1;
  for (int k0 = 0; k0 < Km; k0 += G) {
    unsigned ab[G];
    T cv[G], sv[G];
    size_t t0[G];
    const int g = Km - k0 < G ? Km - k0 : G;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int q = threadIdx.x + (j < g ? k0 + j : k0) * blockDim.x;
      ab[j] = __ldg(tb.ab + (size_t)c * tb.P + q);
      t0[j] = (size_t)c * rows * tb.P + q;
      cv[j] = __ldg(tb.C + t0[j]);
      sv[j] = __ldg(tb.S + t0[j]);
    }
    for (int i = 0; i < nrows; ++i) {
      const int tau = smoqy::wrap_row(tau0 + i, tb.Ltau);
      if (tb.tau_tabs) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          cv[j] = __ldg(tb.C + t0[j] + (size_t)tau * tb.P);
          sv[j] = __ldg(tb.S + t0[j] + (size_t)tau * tb.P);
        }
      }
      T* u = U + (size_t)i * tb.ld;
      const T* E = tb.expV + (size_t)tau * tb.ld;
      // a short group repeats its first pair: the same values written twice
      if (scale == kAfter) {
        pair_group<T, G, kAfter>(u, E, ab, cv, sv);
      } else if (scale == kBefore) {
        pair_group<T, G, kBefore>(u, E, ab, cv, sv);
      } else {
        pair_group<T, G, kNone>(u, E, ab, cv, sv);
      }
    }
  }
}

// One color stage of either form.
template <typename T, int K>
__device__ __forceinline__ void color_stage(const PairTabs<T>& tb, const RegTabs<T, K>& r, int c,
                                            int scale, T* U, int nrows, int tau0) {
  if constexpr (K > 0) {
    switch (c * 3 + scale) {
      case 0: reg_stage<T, K, 0, kNone>(tb, r, U, nrows, tau0); break;
      case 1: reg_stage<T, K, 0, kAfter>(tb, r, U, nrows, tau0); break;
      case 2: reg_stage<T, K, 0, kBefore>(tb, r, U, nrows, tau0); break;
      case 3: reg_stage<T, K, 1, kNone>(tb, r, U, nrows, tau0); break;
      case 4: reg_stage<T, K, 1, kAfter>(tb, r, U, nrows, tau0); break;
      case 5: reg_stage<T, K, 1, kBefore>(tb, r, U, nrows, tau0); break;
      case 6: reg_stage<T, K, 2, kNone>(tb, r, U, nrows, tau0); break;
      case 7: reg_stage<T, K, 2, kAfter>(tb, r, U, nrows, tau0); break;
      default: reg_stage<T, K, 2, kBefore>(tb, r, U, nrows, tau0); break;
    }
  } else {
    mem_stage(tb, c, scale, U, nrows, tau0);
  }
}

// u <- expV u on nrows rows (a B without hoppings: no color to ride on).
template <typename T>
__device__ void scale_rows(const PairTabs<T>& tb, T* U, int nrows, int tau0) {
  for (int i = 0; i < nrows; ++i) {
    const T* E = tb.expV + (size_t)smoqy::wrap_row(tau0 + i, tb.Ltau) * tb.ld;
    for (int n = threadIdx.x; n < tb.N; n += blockDim.x) U[(size_t)i * tb.ld + n] *= E[n];
  }
}

// B on each of nrows rows of U in place (row i: B at tau tau0 + i); U must be
// complete (synchronised) on entry and is on return.
template <typename T, int K, typename St>
__device__ void apply_B(const PairTabs<T>& tb, const RegTabs<T, K>& r, T* U, int nrows, int tau0,
                        St& st) {
  const int nc = tb.n_colors;
  if (nc == 0) {
    scale_rows(tb, U, nrows, tau0);
    __syncthreads();
    st.mark();
    return;
  }
  if (tb.symmetric) {  // CB^T (colors reversed), expV after color 0, CB
    for (int c = nc - 1; c >= 0; --c) {
      color_stage(tb, r, c, c == 0 ? kAfter : kNone, U, nrows, tau0);
      __syncthreads();
      st.mark();
    }
    for (int c = 0; c < nc; ++c) {
      color_stage(tb, r, c, kNone, U, nrows, tau0);
      __syncthreads();
      st.mark();
    }
  } else {  // CB, expV after its last color
    for (int c = 0; c < nc; ++c) {
      color_stage(tb, r, c, c == nc - 1 ? kAfter : kNone, U, nrows, tau0);
      __syncthreads();
      st.mark();
    }
  }
}

// B^T likewise (symmetric: B itself; asymmetric: expV, then CB^T).
template <typename T, int K, typename St>
__device__ void apply_Bt(const PairTabs<T>& tb, const RegTabs<T, K>& r, T* U, int nrows, int tau0,
                         St& st) {
  const int nc = tb.n_colors;
  if (tb.symmetric || nc == 0) {
    apply_B(tb, r, U, nrows, tau0, st);
    return;
  }
  for (int c = nc - 1; c >= 0; --c) {
    color_stage(tb, r, c, c == nc - 1 ? kBefore : kNone, U, nrows, tau0);
    __syncthreads();
    st.mark();
  }
}

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

// Row stride in shared memory: N + 1 sites (the padding's spare one) rounded
// up to 16 bytes.
template <typename T>
int row_ld(int N) {
  constexpr int per = 16 / sizeof(T);
  return (N + 1 + per - 1) / per * per;
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
