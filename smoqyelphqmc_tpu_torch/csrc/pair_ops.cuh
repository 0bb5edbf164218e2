// Pair stages of the checkerboard propagator on tau blocks, shared by K1
// (mtm.cu) and K4 (force.cu).
//
// A checkerboard color is a matching (each bond's two sites share one cosh
// and one sinh), so a thread takes whole pairs (a, b), reads u[a], u[b] and
// writes both back: B updates a block's rows in place, no second row buffer.
// Sites a color leaves alone are pairs (n, n) with cosh 1, sinh 0; pair
// tables are padded to K pairs a thread with pairs (N, N) on a spare site N
// of each row, which nothing reads, so no stage tests a slot, and the expV
// scaling rides on a color stage. With tau-independent hoppings, up to 3
// colors and K <= 5 pairs a thread a color, a thread's pairs (their sites and
// cosh, sinh) live in registers for the whole launch (the register form, K a
// template argument and each stage's color a compile-time index); otherwise
// the memory form (K = 0) reads them once a stage for all rows of the block.
//
// The value a site holds on a row is V: one T (K1), or f2, two channels side
// by side (K4), so one 8-byte access and one table entry serve both.
//
// A timed instantiation (kTimed) stamps clock64() after every phase of its
// block on CTA 0 and on the last CTA to finish (Stamps<true>).
#pragma once

#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace smoqy {
namespace pairs {

template <typename T>
struct PairTabs {
  const unsigned* ab;  // (n_colors, P): sites a | b << 16 of each pair; padding a = b = N
  const T* C;          // (n_colors, rows, P) cosh of the pair's bond
  const T* S;          // (n_colors, rows, P) sinh
  const T* expV;       // (Ltau, ld) exp(-dtau V), 1 in the padding columns
  int N;
  int ld;  // row stride in shared memory (in values V) and of expV: > N (site N is the padding's)
  int Ltau;
  int n_colors;
  int P;         // pair slots a color: K * blockDim.x
  int tau_tabs;  // 1: rows == Ltau (tau-dependent hoppings), 0: rows == 1
  int symmetric;  // 1: B = CB^T D CB (applied CB^T first); 0: B = D CB, B^T = CB^T D
};

// Two channels of one site (K4's rows hold both channels of a tau row).
struct alignas(8) f2 {
  float x, y;
};
__device__ __forceinline__ f2 operator*(float a, f2 v) { return {a * v.x, a * v.y}; }
__device__ __forceinline__ f2 operator+(f2 a, f2 b) { return {a.x + b.x, a.y + b.y}; }

// a x + y with the product fused: the stages' one rounding pattern, written
// out so that every instantiation rounds alike (fma(cv, xa, s xb)).
__device__ __forceinline__ float madd(float a, float x, float y) { return __fmaf_rn(a, x, y); }
__device__ __forceinline__ double madd(double a, double x, double y) { return __fma_rn(a, x, y); }
__device__ __forceinline__ f2 madd(float a, f2 x, f2 y) { return {__fmaf_rn(a, x.x, y.x), __fmaf_rn(a, x.y, y.y)}; }
__device__ __forceinline__ f2& operator*=(f2& v, float a) {
  v.x *= a;
  v.y *= a;
  return v;
}

// ---- the timed instantiation's stamps ---------------------------------------
//
// A grid can run in more than one round, so the last CTA to finish is
// recorded beside CTA 0; it keeps its clocks in shared memory until it knows.
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
// buffer). expV rides on a stage: after the block (kAfter) or before it
// (kBefore). kNeg negates the sinh: the color's inverse.

enum Scale { kNone = 0, kAfter = 1, kBefore = 2 };

template <typename T, typename V, int G, int SC, bool kNeg>
__device__ __forceinline__ void pair_group(V* u, const T* E, const unsigned* ab, const T* cv, const T* sv) {
  V ua[G], ub[G];
  T ea[G], eb[G];
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
    const T s = kNeg ? -sv[j] : sv[j];
    V xa = ua[j], xb = ub[j];
    if (SC == kBefore) {
      xa *= ea[j];
      xb *= eb[j];
    }
    V ta = madd(cv[j], xa, s * xb);
    V tb = madd(cv[j], xb, s * xa);
    if (SC == kAfter) {
      ta *= ea[j];
      tb *= eb[j];
    }
    u[a] = ta;
    u[b] = tb;
  }
}

constexpr int kRegColors = 3;  // colors whose tables the register form holds
constexpr int kMaxK = 5;       // pairs a thread a color in the register form

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
template <typename T, typename V, int K, int CC, int SC, bool kNeg>
__device__ __forceinline__ void reg_stage(const PairTabs<T>& tb, const RegTabs<T, K>& r, V* U, int nrows,
                                          int tau0) {
  constexpr int G = K <= 3 ? K : (K + 1) / 2;  // pairs whose loads go first
  for (int i = 0; i < nrows; ++i) {
    V* u = U + (size_t)i * tb.ld;
    const T* E = tb.expV + (size_t)smoqy::wrap_row(tau0 + i, tb.Ltau) * tb.ld;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += G) {
      constexpr int kLast = K % G == 0 ? G : K % G;
      if (k0 + G <= K) {
        pair_group<T, V, G, SC, kNeg>(u, E, r.ab[CC] + k0, r.c[CC] + k0, r.s[CC] + k0);
      } else {
        pair_group<T, V, kLast, SC, kNeg>(u, E, r.ab[CC] + k0, r.c[CC] + k0, r.s[CC] + k0);
      }
    }
  }
}

// The memory form (K = 0): any number of colors, tau-dependent tables; a
// thread reads its pairs' sites and (cosh, sinh) once a stage (once a row
// where they depend on tau), Km pairs of them.
template <typename T, typename V, bool kNeg>
__device__ void mem_stage(const PairTabs<T>& tb, int c, int scale, V* U, int nrows, int tau0) {
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
      V* u = U + (size_t)i * tb.ld;
      const T* E = tb.expV + (size_t)tau * tb.ld;
      // a short group repeats its first pair: the same values written twice
      if (scale == kAfter) {
        pair_group<T, V, G, kAfter, kNeg>(u, E, ab, cv, sv);
      } else if (scale == kBefore) {
        pair_group<T, V, G, kBefore, kNeg>(u, E, ab, cv, sv);
      } else {
        pair_group<T, V, G, kNone, kNeg>(u, E, ab, cv, sv);
      }
    }
  }
}

// One color stage of either form.
template <typename T, int K, typename V, bool kNeg = false>
__device__ __forceinline__ void color_stage(const PairTabs<T>& tb, const RegTabs<T, K>& r, int c, int scale, V* U,
                                            int nrows, int tau0) {
  if constexpr (K > 0) {
    switch (c * 3 + scale) {
      case 0: reg_stage<T, V, K, 0, kNone, kNeg>(tb, r, U, nrows, tau0); break;
      case 1: reg_stage<T, V, K, 0, kAfter, kNeg>(tb, r, U, nrows, tau0); break;
      case 2: reg_stage<T, V, K, 0, kBefore, kNeg>(tb, r, U, nrows, tau0); break;
      case 3: reg_stage<T, V, K, 1, kNone, kNeg>(tb, r, U, nrows, tau0); break;
      case 4: reg_stage<T, V, K, 1, kAfter, kNeg>(tb, r, U, nrows, tau0); break;
      case 5: reg_stage<T, V, K, 1, kBefore, kNeg>(tb, r, U, nrows, tau0); break;
      case 6: reg_stage<T, V, K, 2, kNone, kNeg>(tb, r, U, nrows, tau0); break;
      case 7: reg_stage<T, V, K, 2, kAfter, kNeg>(tb, r, U, nrows, tau0); break;
      default: reg_stage<T, V, K, 2, kBefore, kNeg>(tb, r, U, nrows, tau0); break;
    }
  } else {
    mem_stage<T, V, kNeg>(tb, c, scale, U, nrows, tau0);
  }
}

// u <- expV u on nrows rows (a B without hoppings: no color to ride on).
template <typename T, typename V>
__device__ void scale_rows(const PairTabs<T>& tb, V* U, int nrows, int tau0) {
  for (int i = 0; i < nrows; ++i) {
    const T* E = tb.expV + (size_t)smoqy::wrap_row(tau0 + i, tb.Ltau) * tb.ld;
    for (int n = threadIdx.x; n < tb.N; n += blockDim.x) U[(size_t)i * tb.ld + n] *= E[n];
  }
}

// B on each of nrows rows of U in place (row i: B at tau tau0 + i); U must be
// complete (synchronised) on entry and is on return.
template <typename T, int K, typename V, typename St>
__device__ void apply_B(const PairTabs<T>& tb, const RegTabs<T, K>& r, V* U, int nrows, int tau0, St& st) {
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
template <typename T, int K, typename V, typename St>
__device__ void apply_Bt(const PairTabs<T>& tb, const RegTabs<T, K>& r, V* U, int nrows, int tau0, St& st) {
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

// Row stride in shared memory: N + 1 sites (the padding's spare one) rounded
// up to 16 bytes.
template <typename V>
int row_ld(int N) {
  constexpr int per = 16 / sizeof(V);
  return (N + 1 + per - 1) / per * per;
}

}  // namespace pairs
}  // namespace smoqy
