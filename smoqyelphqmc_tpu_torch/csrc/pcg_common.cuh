// The cooperative whole-solve machinery shared by kernels K2 (pcg.cu) and K3
// (pcg_force.cu): per-system dot partials reduced in a fixed order, a warp
// per system; the preconditioner's four bf16 products on the tensor cores
// (mma.sync); the residual update that rides on the first product's staging
// (ResidualSrc); the phase stamps of a timed instantiation; the cooperative
// grid size.
//
// Both kernels' argument structs carry the fields these functions read (the
// Krylov planes r, z, the preconditioner operands W, Wt, Q, Qt, filt, its
// bf16 scratch U, Am, Bm, the partial array and the sizes B, Ltau, Lh, N),
// so the functions are templates on the argument type.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_ops.cuh"

namespace smoqy {

namespace cg = cooperative_groups;

constexpr int kMaxSystems = 256;
constexpr int kMaxGrid = 1024;
constexpr int kCtasPerSm = 2;
enum { kPartPAp = 0, kPartRR = 1, kPartRZ = 2 };

struct Shared {
  double red[kThreads / 32];
  double part[kMaxSystems];
  double sum[kMaxSystems];  // reduce_parts' result
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
    a.part[((size_t)which * a.B + s) * kMaxGrid + blockIdx.x] = sh.part[s];
}

// sh.sum[s] = the sum of system s's CTA partials, for every system, in a
// fixed order, so every CTA holds the same bits: one warp per system (the
// CTA's warps take systems in turn), its lanes read the system's contiguous
// (grid,) partials lane-strided past L1 and sum them in a fixed butterfly.
template <typename Args>
__device__ void reduce_parts(const Args& a, Shared& sh, int which) {
  __syncthreads();  // sh.sum may still be read
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = warp; s < a.B; s += kThreads / 32) {
    const double* p = a.part + ((size_t)which * a.B + s) * kMaxGrid;
    double acc = 0.0;
    for (unsigned g = lane; g < gridDim.x; g += 32) acc += __ldcg(p + g);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) sh.sum[s] = acc;
  }
  __syncthreads();
}

// ---- bf16 tensor-core products (mma.sync m16n8k16, f32 sums) ----------
//
// An output tile is kMmaM x kMmaN: each of the CTA's 8 warps owns one n8
// column slice of it over the whole depth K. The depth is staged kMmaK at a
// time through two shared-memory buffers (cp.async, 16 bytes a thread,
// where the rows allow it), and each warp reads its fragments with
// ldmatrix (A row-major, B row-major through .trans). Rows are padded by 8
// bf16 (16 bytes) so ldmatrix's eight row addresses fall in distinct banks.
constexpr int kMmaM = 16;
constexpr int kMmaN = 8 * (kThreads / 32);  // 64
constexpr int kMmaK = 64;
constexpr int kLdA = kMmaK + 8;
constexpr int kLdB = kMmaN + 8;
constexpr int kStageElems = kMmaM * kLdA + kMmaK * kLdB;
constexpr size_t kGemmSmem = 2 * kStageElems * sizeof(__nv_bfloat16);

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand sources: load(dst, ldd, bt, r0, c0, rows, cols, R, C, m0) stages
// the (rows x cols) block at (r0, c0) of batch entry bt into dst (row stride
// ldd), zeros outside the operand's R x C, and returns this thread's share
// of a per-system dot (m0: the first output row of the tile).

// Four f32 values to bf16 at d (8-byte aligned).
__device__ __forceinline__ void store4_bf16(__nv_bfloat16* d, float4 v) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(d);
  d2[0] = __floats2bfloat162_rn(v.x, v.y);
  d2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// f32 planes are staged four columns a step where rows and batches are
// 4-aligned; a thread issues all its loads of a block before any store.
constexpr int kVec4PerThread = kMmaK * kMmaN / 4 / kThreads;  // right operands only

__device__ __forceinline__ bool f32_vec_ok(const void* p, size_t bs, int ld, int C) {
  return ld % 4 == 0 && C % 4 == 0 && bs % 4 == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}
//
// A bf16 operand (nb, R, C), row-major with row stride ld and batch stride
// bs: cp.async in 16-byte chunks where rows and batches are 8-aligned.
struct Bf16Src {
  static constexpr bool kDot = false;
  const __nv_bfloat16* p;
  size_t bs;
  int ld;
  bool vec;
  __device__ Bf16Src(const __nv_bfloat16* p_, size_t bs_, int ld_, int C)
      : p(p_), bs(bs_), ld(ld_),
        vec(ld_ % 8 == 0 && C % 8 == 0 && bs_ % 8 == 0 &&
            (reinterpret_cast<size_t>(p_) & 15) == 0) {}
  __device__ double load(__nv_bfloat16* dst, int ldd, int bt, int r0, int c0, int rows, int cols,
                         int R, int C, int) const {
    const __nv_bfloat16* base = p + bt * bs;
    if (vec) {
      const int cpr = cols / 8;
      for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
        const int i = e / cpr, j = (e % cpr) * 8;
        const int r = r0 + i, c = c0 + j;
        const bool ok = r < R && c < C;  // C % 8 == 0: a chunk is whole or outside
        cp_async16(dst + i * ldd + j, ok ? base + (size_t)r * ld + c : base, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
        const int i = e / cols, j = e % cols;
        const int r = r0 + i, c = c0 + j;
        dst[i * ldd + j] = (r < R && c < C) ? base[(size_t)r * ld + c] : __float2bfloat16_rn(0.f);
      }
    }
    return 0.0;
  }
};

// An f32 right operand rounded to bf16 as it is staged.
struct F32Src {
  static constexpr bool kDot = false;
  const float* p;
  size_t bs;
  int ld;
  bool vec;
  __device__ F32Src(const float* p_, size_t bs_, int ld_, int C)
      : p(p_), bs(bs_), ld(ld_), vec(f32_vec_ok(p_, bs_, ld_, C)) {}
  __device__ double load(__nv_bfloat16* dst, int ldd, int bt, int r0, int c0, int rows, int cols,
                         int R, int C, int) const {
    const float* base = p + bt * bs;
    if (vec) {
      const int cpr = cols / 4;
      float4 v[kVec4PerThread];
#pragma unroll
      for (int q = 0; q < kVec4PerThread; ++q) {
        const int e = threadIdx.x + q * kThreads, i = e / cpr, j = (e % cpr) * 4;
        const int r = r0 + i, c = c0 + j;
        v[q] = (r < R && c < C) ? *reinterpret_cast<const float4*>(base + (size_t)r * ld + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < kVec4PerThread; ++q) {
        const int e = threadIdx.x + q * kThreads;
        store4_bf16(dst + (e / cpr) * ldd + (e % cpr) * 4, v[q]);
      }
      return 0.0;
    }
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int i = e / cols, j = e % cols;
      const int r = r0 + i, c = c0 + j;
      dst[i * ldd + j] = __float2bfloat16_rn((r < R && c < C) ? base[(size_t)r * ld + c] : 0.f);
    }
    return 0.0;
  }
};

// C[bt](m, n) = sum_k A[bt](m, k) B[bt](k, n) for every batch entry bt
// (M x K times K x Nc), over kMmaM x kMmaN output tiles spread across the
// grid. epi(bt, m, n, value) stores the value and returns this element's
// share of a per-system dot; with kDot the CTA adds the tile's dot (the
// epilogue's and the sources') to sh.part[bt].
template <bool kDot, typename SrcA, typename SrcB, typename Epi>
__device__ void gemm_mma(Shared& sh, __nv_bfloat16* smem, int nb, int M, int Nc, int K,
                         const SrcA& A, const SrcB& Bs, Epi epi) {
  const int tm = (M + kMmaM - 1) / kMmaM;
  const int tn = (Nc + kMmaN - 1) / kMmaN;
  const int n_tiles = nb * tm * tn;
  const int nk = (K + kMmaK - 1) / kMmaK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int bt = tile / (tm * tn);
    const int rem = tile % (tm * tn);
    const int m0 = (rem / tn) * kMmaM;
    const int n0 = (rem % tn) * kMmaN;
    double local = 0.0;
    auto stage = [&](int kc) {
      __nv_bfloat16* sA = smem + (kc & 1) * kStageElems;
      __nv_bfloat16* sB = sA + kMmaM * kLdA;
      const int k0 = kc * kMmaK;
      local += A.load(sA, kLdA, bt, m0, k0, kMmaM, kMmaK, M, K, m0);
      local += Bs.load(sB, kLdB, bt, k0, n0, kMmaK, kMmaN, K, Nc, m0);
      cp_async_commit();
    };
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    stage(0);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        stage(kc + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* sA = smem + (kc & 1) * kStageElems;
      const __nv_bfloat16* sB = sA + kMmaM * kLdA;
#pragma unroll
      for (int kk = 0; kk < kMmaK; kk += 16) {
        unsigned fa[4], fb[2];
        ldmatrix_x4(fa, sA + (lane % 16) * kLdA + kk + (lane / 16) * 8);
        ldmatrix_x2_trans(fb, sB + (kk + lane % 16) * kLdB + warp * 8);
        mma_bf16(acc, fa, fb);
      }
      __syncthreads();  // the buffer is staged again two chunks on
    }
    // accumulator layout: rows lane/4 (+8), columns 2 (lane % 4) (+1)
    const int n = n0 + warp * 8 + 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + lane / 4 + 8 * (q / 2), nq = n + (q % 2);
      if (m < M && nq < Nc) local += (double)epi(bt, m, nq, acc[q]);
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
//   Bm = Am Q^T                (Q^T stored row-major: Qt)
//   z  = [Wre^T Wim^T] Bm      (Ltau x 2Lh)(2Lh x N) per system (Wt)
// U, Am and Bm are stored in bf16, the precision every reader takes them in.
// rsrc stages U's right operand, the residual r that the dot with z reads;
// where it has dots (RSrc::kDot), their per-system sums go to the RR
// partials. first_done() runs after the first grid sync. st(k) marks the end
// of the k-th of its eight phases (product, sync, ...).
template <typename Args, typename RSrc, typename First, typename Stamp>
__device__ void precond(const Args& a, cg::grid_group& grid, Shared& sh, __nv_bfloat16* smem,
                        const RSrc& rsrc, const float* r, First first_done, Stamp st) {
  const int B = a.B, L = a.Ltau, Lh = a.Lh, N = a.N, M2 = 2 * a.Lh;
  const size_t plane = (size_t)L * N;
  __nv_bfloat16* U = a.U;
  __nv_bfloat16* Am = a.Am;
  __nv_bfloat16* Bm = a.Bm;
  float* z = a.z;
  const float* filt = a.filt;

  if (RSrc::kDot) zero_part(sh, B);
  gemm_mma<RSrc::kDot>(sh, smem, B, M2, N, L, Bf16Src(a.W, 0, L, L), rsrc,
                       [=](int bt, int m, int n, float v) {
                         U[((size_t)bt * M2 + m) * N + n] = __float2bfloat16_rn(v);
                         return 0.f;
                       });
  if (RSrc::kDot) flush_part(a, sh, kPartRR);
  st(0);
  grid.sync();
  st(1);
  first_done();
  gemm_mma<false>(sh, smem, 1, B * M2, N, N, Bf16Src(U, 0, N, N), Bf16Src(a.Q, 0, N, N),
                  [=](int, int m, int n, float v) {
                    Am[(size_t)m * N + n] = __float2bfloat16_rn(v * filt[(size_t)(m % Lh) * N + n]);
                    return 0.f;
                  });
  st(2);
  grid.sync();
  st(3);
  gemm_mma<false>(sh, smem, 1, B * M2, N, N, Bf16Src(Am, 0, N, N), Bf16Src(a.Qt, 0, N, N),
                  [=](int, int m, int n, float v) {
                    Bm[(size_t)m * N + n] = __float2bfloat16_rn(v);
                    return 0.f;
                  });
  st(4);
  grid.sync();
  st(5);
  zero_part(sh, B);
  gemm_mma<true>(sh, smem, B, L, N, M2, Bf16Src(a.Wt, 0, M2, M2),
                 Bf16Src(Bm, (size_t)M2 * N, N, N), [=](int bt, int m, int n, float v) {
                   const size_t i = bt * plane + (size_t)m * N + n;
                   z[i] = v;
                   return v * r[i];
                 });
  flush_part(a, sh, kPartRZ);
  st(6);
  grid.sync();
  st(7);
}

// Phase stamps of a timed instantiation (kTimed): once its CTA is done, CTA
// 0's thread 0 records clock64() in slot i; the path's kernel takes none.
// Slots 0-3 hold globaltimer and clock64 at the kernel's start and end, so
// the host converts cycles to nanoseconds.
constexpr int kStampHead = 4;

template <bool kTimed>
__device__ __forceinline__ void stamp(unsigned long long* t, int i) {
  if constexpr (kTimed) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) t[i] = clock64();
  }
}

template <bool kTimed>
__device__ __forceinline__ void stamp_clock_pair(unsigned long long* t, int i) {
  if constexpr (kTimed) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      t[i] = g;
      t[i + 1] = clock64();
    }
  }
}

// p = z + beta p for one element: the one expression every row that builds
// it evaluates, so the rows l-1, l, l+1 of two CTAs agree to the bit.
__device__ __forceinline__ float p_next(float z, float beta, float p) { return fmaf(beta, p, z); }

// U's right operand: r - alpha Ap of the system, rounded to bf16 as it is
// staged. The tile whose output rows are [m0, m0 + kMmaM) also owns those
// rows (tau) of r: it writes them to the next r plane, updates x += alpha p
// there and returns its share of |r|^2 (Ltau <= 2 Lh, so every row has an
// owner, and each (tau, site) one). Inactive systems keep r and x.
__device__ __forceinline__ float4 residual4(float4 r, float4 ap, bool act, float al) {
  if (act) {
    r.x = fmaf(-al, ap.x, r.x);
    r.y = fmaf(-al, ap.y, r.y);
    r.z = fmaf(-al, ap.z, r.z);
    r.w = fmaf(-al, ap.w, r.w);
  }
  return r;
}

struct ResidualSrc {
  static constexpr bool kDot = true;
  const float* r;
  float* r_next;
  float* x;
  const float* Ap;
  const float* p;
  const float* alpha;
  const int* active;
  size_t bs;
  int ld;
  bool vec;
  __device__ ResidualSrc(const float* r_, float* r_next_, float* x_, const float* Ap_,
                         const float* p_, const float* alpha_, const int* active_, size_t bs_,
                         int ld_)
      : r(r_), r_next(r_next_), x(x_), Ap(Ap_), p(p_), alpha(alpha_), active(active_), bs(bs_),
        ld(ld_), vec(f32_vec_ok(r_, bs_, ld_, ld_) && f32_vec_ok(r_next_, bs_, ld_, ld_) &&
                     f32_vec_ok(x_, bs_, ld_, ld_) && f32_vec_ok(Ap_, bs_, ld_, ld_) &&
                     f32_vec_ok(p_, bs_, ld_, ld_)) {}

  __device__ double load(__nv_bfloat16* dst, int ldd, int bt, int r0, int c0, int rows, int cols,
                         int R, int C, int m0) const {
    const bool act = active[bt] != 0;
    const float al = alpha[bt];
    double acc = 0.0;
    if (vec) {
      const int cpr = cols / 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 rv[kVec4PerThread], av[kVec4PerThread];
#pragma unroll
      for (int q = 0; q < kVec4PerThread; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const int k = r0 + e / cpr, c = c0 + (e % cpr) * 4;
        const bool ok = k < R && c < C;
        const size_t o = bt * bs + (size_t)k * ld + c;
        rv[q] = ok ? *reinterpret_cast<const float4*>(r + o) : zero;
        av[q] = ok && act ? *reinterpret_cast<const float4*>(Ap + o) : zero;
      }
#pragma unroll
      for (int q = 0; q < kVec4PerThread; ++q) {
        const int e = threadIdx.x + q * kThreads;
        store4_bf16(dst + (e / cpr) * ldd + (e % cpr) * 4, residual4(rv[q], av[q], act, al));
      }
      // the owned rows, when this block holds them: one float4 a thread
      static_assert(kMmaM * kMmaN / 4 == kThreads, "owned rows: one float4 a thread");
      const int k = m0 + threadIdx.x / cpr, c = c0 + (threadIdx.x % cpr) * 4;
      if (m0 >= r0 && m0 < r0 + rows && k < R && c < C) {
        const size_t o = bt * bs + (size_t)k * ld + c;
        const float4 v = residual4(*reinterpret_cast<const float4*>(r + o),
                                   act ? *reinterpret_cast<const float4*>(Ap + o) : zero, act, al);
        *reinterpret_cast<float4*>(r_next + o) = v;
        if (act) {
          const float4 pv = *reinterpret_cast<const float4*>(p + o);
          const float4 xv = *reinterpret_cast<const float4*>(x + o);
          *reinterpret_cast<float4*>(x + o) =
              make_float4(fmaf(al, pv.x, xv.x), fmaf(al, pv.y, xv.y), fmaf(al, pv.z, xv.z),
                          fmaf(al, pv.w, xv.w));
          acc = (double)v.x * v.x + (double)v.y * v.y + (double)v.z * v.z + (double)v.w * v.w;
        }
      }
      return acc;
    }
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int i = e / cols, j = e % cols;
      const int k = r0 + i, c = c0 + j;
      float v = 0.f;
      if (k < R && c < C) {
        const size_t o = bt * bs + (size_t)k * ld + c;
        v = r[o];
        if (act) v = fmaf(-al, Ap[o], v);
        if (k >= m0 && k < m0 + kMmaM) {
          r_next[o] = v;
          if (act) {
            x[o] = fmaf(al, p[o], x[o]);
            acc += (double)v * v;
          }
        }
      }
      dst[i * ldd + j] = __float2bfloat16_rn(v);
    }
    return acc;
  }
};

// CTAs of a cooperative launch of `kernel` (at most kCtasPerSm per SM, at most
// kMaxGrid), after setting its dynamic shared-memory limit to `smem` bytes.
// The limit is set at every size: the kernels' static arrays (Shared, ~10-13
// KB) count against the 48 KB a CTA gets without it, so a launch whose
// dynamic part is under 48 KB but whose sum is over (K3 at N=162, T=13) needs
// it too.
template <typename Kernel>
int cooperative_grid(Kernel kernel, size_t smem, int* grid_out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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
