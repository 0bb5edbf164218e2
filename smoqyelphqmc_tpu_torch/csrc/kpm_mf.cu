// Kernels K6, K7 and K8: the matrix-free KPM preconditioner apply,
//   y = sum_k c_k(f) T_k(Bbar') u   per frequency row f,  Bbar' = (Bbar - center) / half,
// with Bbar the tau-averaged propagator applied through its checkerboard.
//
// K6 (`kpm_mf_kernel`) replaces `_kpm_mf_kernel`
// (the JAX package's ops/pallas_fused.py:1186, its pallas_call at :1450):
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
// MFLOP; but a frequency's recurrence is order-many steps, each a full Bbar
// application: a chain of gathers over the whole row of N sites, each of
// which needs the one before it complete. The kernel's time is the time of
// the frequency with the most live orders (77 of a sum of 594 over 240
// frequencies at L=48), so what counts is the number of barrier-separated
// stages per order step and the time of one stage.
//
// What the design does about it:
// - Stage tables. The host (ops/kpm_mf.py:build_stage_tables) folds Bbar / half
//   into n_stages gathers  x <- A_s x + B_s x[P_s]  and nothing else: for the
//   asymmetric form the colors in order with the diagonal multiplied into the
//   last one (n_colors stages where the sweep and the diagonal were
//   n_colors + 1 passes for each of the two rows); for the symmetric form the
//   reversed colors, then the middle color, the diagonal and the middle color
//   again as ONE 2x2 block per pair, then the colors forward
//   (2 n_colors - 1 stages for 2 n_colors + 1). The recurrence step and the
//   y += c_k t_k update touch only the thread's own sites, so the last stage
//   does them: an order step is 5 stages (K6) or 3 (K7) at 3 colors, where it
//   was 8 or 9 barrier-separated passes. Partners are 16-bit (N <= 65535).
// - All rows of a frequency together. A CTA carries G = 4 (or 2) rows (K6:
//   any rows; K7: re and im of G / 2 vectors) interleaved site by site, so
//   one table entry and one 16-byte transfer serve them all.
// - The cluster form: the N sites of one frequency are split over the CTAs of
//   a thread-block cluster, each owning a contiguous slice. Its slice of the
//   stage tables and the coefficients stay in its shared memory for the whole
//   recurrence, and the state (t_prev, t_cur, y, and the value moving
//   through the stages) in the registers of the thread that owns the site.
//   Stages are not separated by barriers at all: a stage's input is pushed.
//   P pairs the sites, so the thread that has x[n] stores it into the slot of
//   its partner P[n], in whichever CTA owns that (st.async through
//   distributed shared memory, the slot's shared::cluster address from mapa
//   computed once per table entry), and the store completes bytes on an
//   mbarrier beside the slot, one for every 32 sites; a warp waits only for
//   the 32 slots of its own sites. Partners may lie anywhere.
// - The one-CTA form, for shapes whose slices do not fit the cluster form
//   (chosen by shape alone) and for the plan's tail where the order threshold
//   cuts it: one CTA per (frequency, row group) with the same stages, the
//   tables read through the read-only cache, one row (K6) or one vector (K7)
//   per CTA, __syncthreads() between stages; N up to 16384 (K6), 8192 (K7).
// - CTAs are numbered in descending order of the frequency's live order
//   (the plan's sort); the first n_cluster frequencies take the cluster
//   form, the rest the one-CTA form in a second launch. The cut
//   (ops/kpm_mf.py:ORDER_THRESHOLD) and the cluster size are constants
//   chosen from measurements on the card, written there; a thread takes 1
//   site of its CTA's slice, 2 where the slice has more than 1024.
// - K7 runs both passes in-kernel: pass 1's output is pass 2's input without
//   a trip to device memory.
// center / half is subtracted in the recurrence step, as the TPU kernels fold
// the affine map.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit) with
// smoqyelphqmc_tpu_torch/time_kpm_mf.py at the L=48 shape, u 2 x (2, 240,
// 4608), ms per apply (PERF.md section 6 has the runs): K6 0.92 -> 0.23, K7
// 1.75 -> 0.14. A stage of the longest recurrence costs ~0.6 us (K6: 3.0 us
// per order step of 5 stages; K7: 1.9 us of 3), where a barrier-separated
// pass cost 1.5 us (K6) and 2.6 us (K7). On the way: the stages alone, in the
// one-CTA form, 0.57 (K6) and 0.46 (K7); the cluster form gathering through
// distributed shared memory behind a cluster barrier 0.32 and 0.19, of which
// the barrier's release fence (barrier.cluster.arrive.release) was 0.5 us of
// every 0.9 us stage; pushing with one mbarrier per buffer 0.26 and 0.15; one
// per 32 sites 0.23 and 0.14. The time of a stage grows with the sites a CTA
// owns (cluster size 4: K7 0.24; the non-portable 16: K6 0.20, K7 0.12), and
// every frequency as a cluster in one launch beats any cut of the plan (the
// second launch waits for the first).
//
// K8 (`kpm_mf_cplx_kernel`) replaces `_kpm_mf_cplx_kernel` (:1307, its
// pallas_call at :1403): complex hopping amplitudes. Bbar is then complex and
// its checkerboard MIXES the (re, im) rows of one vector at every color,
//   re' = C re + S re[p] - S_im im[p],   im' = C im + S im[p] + S_im re[p],
// with the sign of S_im flipped on the second site of each pair (conj(s)).
// K8 runs on K6 / K7's bodies with a compile-time complex flag: its stage
// tables (ops/kpm_mf.py:build_stage_tables_pair) carry B's imaginary part Bi
// beside A and B, a stage is the mixing form
//   re' = A re + B re[P] - Bi im[P],   im' = A im + B im[P] + Bi re[P],
// and a CTA carries re and im of one vector (G = 2) or two (G = 4) side by
// side, as K7 does, so the partner's re and im arrive in one push or one
// gather. The symmetric Bbar = CB expV CB^H is Hermitian: one pass with real
// coefficients on 2 n_colors - 1 mirrored stages (the middle block's A is
// real: s_p = conj(s_n)); the asymmetric Bbar = expV CB takes K7's two
// conjugate passes with the i-rotation on n_colors stages. At the complex
// chain's 2 colors that is 3 stages an order step (6 barrier-separated
// passes before) and 2 (4 before). Like K6 and K7 it is bound by its depth,
// not by bytes: at N = 1152 an apply to two vectors moves ~9 MB (~3 us at
// 3.35 TB/s), while the longest symmetric recurrence runs ~60 order steps.
//
// C interface (bound with ctypes from ops/kpm_mf.py): returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kK6MaxSites = 16 * 1024;  // the one-CTA form: 16 sites a thread, one row
constexpr int kK7MaxSites = 16 * 512;   // the one-CTA form: 16 sites a thread, one vector (K7, K8)
constexpr int kMaxClusterSize = 8;      // the portable limit; 16 is taken with the non-portable attribute
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ int site(int i) { return threadIdx.x + i * blockDim.x; }

// Bbar / half as gathers x <- A_t x + B_t x[P_t]: stage s takes table s, or,
// mirrored (the symmetric form), table |s - (n_tables - 1)|: the colors
// n_tables-1 .. 1, the folded middle block (table 0), the colors 1 .. n_tables-1.
// With complex hoppings (K8) B_t is complex, Bc + i Bi, and mixes the (re, im)
// rows of each vector.
struct StageTables {
  const float* A;           // (n_tables, N)
  const float* Bc;          // (n_tables, N)
  const float* Bi;          // (n_tables, N), K8 only
  const unsigned short* P;  // (n_tables, N) partner sites
  int N;
  int n_tables;
  int n_stages;
  int mirror;
};

struct MfArgs {
  const float* ure;  // (B, F, N)
  const float* uim;
  float* yre;
  float* yim;
  StageTables tb;
  const float* cre;  // (F, C_pad)
  const float* cim;  // (F, C_pad), the asymmetric passes only
  const int* orders;  // (F,) live orders
  const int* perm;    // (F,) the plan: frequencies in descending order
  float cih;          // center / half
  int B, F, C_pad;
};

__device__ __forceinline__ uint32_t map_to_rank(uint32_t shared_addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(shared_addr), "r"(rank));
  return out;
}

// mbarrier (shared::cta address) with a transaction count: remote st.async
// stores complete bytes on it; one local arrival arms each phase.
__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_arm(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes) : "memory");
}

// Wait for the phase of this parity; the stores that completed it are
// visible afterwards (acquire at cluster scope). A phase that does not
// complete within seconds is a fault of the launch: trap, not hang.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (!done && (spins & 1023u) == 1023u) {
      if (t0 == 0) t0 = clock64();
      if (clock64() - t0 > 4000000000ll) __trap();
    }
  }
}

// G floats to a shared::cluster address (any CTA of the cluster), completing
// 4 G bytes on the mbarrier beside it (an address in the same CTA).
template <int G>
__device__ __forceinline__ void st_async(uint32_t addr, const float (&x)[G], uint32_t mbar) {
  static_assert(G == 2 || G == 4, "row groups of 2 or 4");
  if constexpr (G == 4) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
                 "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])), "r"(__float_as_uint(x[2])),
                 "r"(__float_as_uint(x[3])), "r"(mbar)
                 : "memory");
  } else {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(addr),
                 "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])), "r"(mbar)
                 : "memory");
  }
}

template <int G>
__device__ __forceinline__ void ld_row(const float* p, float (&x)[G]) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <int G>
__device__ __forceinline__ void st_row(float* p, const float (&x)[G]) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// Row g of row group `group` of frequency f: its offset in the (B, F, N)
// planes, and whether it lies in the im plane. K6's rows 0..B-1 are u_re's
// vectors and B..2B-1 u_im's; K7's and K8's (kPair) rows 2j, 2j+1 are re and
// im of vector j.
template <int G, bool kPair>
__device__ __forceinline__ size_t row_offset(int group, int g, int f, int B, int F, int N, bool& im) {
  if constexpr (kPair) {
    im = g & 1;
    return ((size_t)(group * (G / 2) + g / 2) * F + f) * N;
  } else {
    const int r = group * G + g;
    im = r >= B;
    return ((size_t)(r % B) * F + f) * N;
  }
}

// The sites [lo, lo + len) of this CTA's rows of frequency f, site(i) of
// thread threadIdx.x, between registers and the (B, F, N) planes.
template <int G, int PER, bool kPair>
__device__ __forceinline__ void load_rows(const MfArgs& a, int f, int lo, int len, float (&t)[PER][G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bool im;
    const size_t off = row_offset<G, kPair>(blockIdx.y, g, f, a.B, a.F, a.tb.N, im);
    const float* __restrict__ src = (im ? a.uim : a.ure) + off + lo;
#pragma unroll
    for (int i = 0; i < PER; ++i) t[i][g] = site(i) < len ? src[site(i)] : 0.f;
  }
}

template <int G, int PER, bool kPair>
__device__ __forceinline__ void store_rows(const MfArgs& a, int f, int lo, int len, const float (&y)[PER][G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bool im;
    const size_t off = row_offset<G, kPair>(blockIdx.y, g, f, a.B, a.F, a.tb.N, im);
    float* __restrict__ dst = (im ? a.yim : a.yre) + off + lo;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (site(i) < len) dst[site(i)] = y[i][g];
    }
  }
}

// A pass's start on one site's rows: t_prev = 0, y = c_0 t_cur; the complex
// coefficient acts as c t + c_im i t with i t = (-t_im, t_re) on (re, im) rows.
template <int G, bool kAsym>
__device__ __forceinline__ void first_term(const float (&tc)[G], float (&tp)[G], float (&y)[G], float c0r, float c0i) {
#pragma unroll
  for (int g = 0; g < G; ++g) tp[g] = 0.f;
  if constexpr (kAsym) {
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      y[g] = c0r * tc[g] - c0i * tc[g + 1];
      y[g + 1] = c0r * tc[g + 1] + c0i * tc[g];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] = c0r * tc[g];
  }
}

// w = (Bbar / half) t_cur on entry; t_k = alpha (w - cih t_cur) - beta t_prev
// (alpha, beta = 1, 0 at k = 1, else 2, 1), y += c_k t_k; w = t_k on return.
template <int G, bool kAsym>
__device__ __forceinline__ void recurrence_step(float (&w)[G], float (&tc)[G], float (&tp)[G], float (&y)[G],
                                                float alpha, float beta, float cih, float ckr, float cki) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float tn = alpha * (w[g] - cih * tc[g]) - beta * tp[g];
    tp[g] = tc[g];
    tc[g] = tn;
    w[g] = tn;
  }
  if constexpr (kAsym) {
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      y[g] += ckr * w[g] - cki * w[g + 1];
      y[g + 1] += ckr * w[g + 1] + cki * w[g];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] += ckr * w[g];
  }
}

// One stage on a site's G rows: w <- a w + b x, x the partner's rows; with
// complex hoppings (kCplx) b + i bi acts on each (re, im) row pair.
template <int G, bool kCplx>
__device__ __forceinline__ void stage_combine(float (&w)[G], const float (&x)[G], float a, float b, float bi) {
  if constexpr (kCplx) {
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      const float re = a * w[g] + b * x[g] - bi * x[g + 1];
      w[g + 1] = a * w[g + 1] + b * x[g + 1] + bi * x[g];
      w[g] = re;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) w[g] = a * w[g] + b * x[g];
  }
}

__device__ __forceinline__ int stage_table(const StageTables& tb, int s) {
  return tb.mirror ? abs(s - (tb.n_tables - 1)) : s;
}

// The cluster form. blockIdx.x / cluster size is the frequency's rank in the
// plan, blockIdx.y the row group; the CTA of cluster rank r owns the sites
// [r slice, (r + 1) slice). No stage ends in a barrier: a stage's input is
// PUSHED. Stage q gathers x[P[n]]; P pairs the sites, so the thread that owns
// site n, when it has x[n], stores it into the slot of its partner P[n] in
// the CTA that owns the partner (st.async through distributed shared memory,
// which completes bytes on an mbarrier there, one for every 32 slots), and
// before it computes a stage it waits until the 32 slots of its warp's sites
// are filled: point to point, where a cluster barrier's release fence alone
// cost 0.5 us a stage. A slot buffer and its mbarriers serve the stages
// q mod 2 n_stages, which all take the same table: the slot of site d is
// always written by the same partner a, and a cannot push for stage
// q + 2 n_stages before it has passed stage q + n_stages, for which it
// waited on d's push, made after d read the slot at stage q. The own value
// moves through the stages in registers.
// Shared memory: mbarriers [2 n_stages][slice / 32] | slots
// [2 n_stages][slice][G] | coefficients [2][C_pad] | A, B [T][slice] | Bi
// [T][slice] (kCplx) | slot and mbarrier addresses (shared::cluster)
// [T][slice] each. kAsym: two conjugate passes with complex coefficients;
// kCplx: complex hoppings (rows in (re, im) pairs as with kAsym).
template <int G, int PER, bool kAsym, bool kCplx>
__device__ __forceinline__ void kpm_mf_cluster_body(const MfArgs& a) {
  static_assert(G % 2 == 0, "whole vectors (re and im rows), or row pairs");
  constexpr bool kPair = kAsym || kCplx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int k = (int)cl.num_blocks();
  const int crank = (int)cl.block_rank();
  const StageTables& tb = a.tb;
  const int N = tb.N, T = tb.n_tables, C_pad = a.C_pad;
  const int slice = (N + k - 1) / k;
  const int lo = crank * slice;
  const int len = min(slice, max(N - lo, 0));
  const int f = a.perm[(int)blockIdx.x / k];
  const int n_ord = a.orders[f];
  const float* __restrict__ cr = a.cre + (size_t)f * C_pad;
  const float* __restrict__ ci = kAsym ? a.cim + (size_t)f * C_pad : nullptr;
  const float cih = a.cih;

  const int n_buf = 2 * tb.n_stages;
  const int n_blk = (slice + 31) / 32;  // an mbarrier for every 32 sites of every buffer
  const uint32_t mbar0 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  float* slots = reinterpret_cast<float*>(smem_raw + 16 * ((n_buf * n_blk + 1) / 2));
  float* coef = slots + (size_t)n_buf * slice * G;
  float* sA = coef + 2 * C_pad;
  float* sB = sA + (size_t)T * slice;
  float* sBi = sB + (size_t)T * slice;  // kCplx only
  uint32_t* sSlot = reinterpret_cast<uint32_t*>(sB + (size_t)(kCplx ? 2 : 1) * T * slice);
  uint32_t* sMbar = sSlot + (size_t)T * slice;
  const uint32_t buf_bytes = (uint32_t)slice * G * sizeof(float);
  const uint32_t mbar_buf_bytes = 8u * n_blk;
  auto block_bytes = [&](int blk) { return (uint32_t)min(32, len - 32 * blk) * G * (uint32_t)sizeof(float); };

  float tc[PER][G], tp[PER][G], y[PER][G];
  load_rows<G, PER, kPair>(a, f, lo, len, tc);
  if (n_ord > 1) {
    // every CTA of the cluster takes this branch: they share the frequency
    for (int j = threadIdx.x; j < n_ord; j += blockDim.x) {
      coef[j] = cr[j];
      if (kAsym) coef[C_pad + j] = ci[j];
    }
    const uint32_t slots_addr = (uint32_t)__cvta_generic_to_shared(slots);
    for (int t = 0; t < T; ++t) {
      for (int n = threadIdx.x; n < len; n += blockDim.x) {
        sA[t * slice + n] = tb.A[(size_t)t * N + lo + n];
        sB[t * slice + n] = tb.Bc[(size_t)t * N + lo + n];
        if (kCplx) sBi[t * slice + n] = tb.Bi[(size_t)t * N + lo + n];
        const int p = tb.P[(size_t)t * N + lo + n];
        const int owner = p / slice;
        sSlot[t * slice + n] = map_to_rank(slots_addr + (uint32_t)(p - owner * slice) * G * sizeof(float), owner);
        sMbar[t * slice + n] = map_to_rank(mbar0 + 8u * ((p - owner * slice) / 32), owner);
      }
    }
    for (int m = threadIdx.x; m < n_buf * n_blk; m += blockDim.x) {
      if (32 * (m % n_blk) < len) {
        mbar_init(mbar0 + 8 * m);
        mbar_arm(mbar0 + 8 * m, block_bytes(m % n_blk));
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    cl.sync();
  }

  // The coming stage's table entries, read ahead of the wait before it: its
  // coefficients, and where its input goes (the partner's slot and mbarrier).
  float ca[PER], cb[PER], cbi[PER];
  uint32_t slot[PER], mbar[PER];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (site(i) < len) {
        ca[i] = sA[t * slice + site(i)];
        cb[i] = sB[t * slice + site(i)];
        cbi[i] = kCplx ? sBi[t * slice + site(i)] : 0.f;
        slot[i] = sSlot[t * slice + site(i)];
        mbar[i] = sMbar[t * slice + site(i)];
      }
    }
  };
  // stage q's input pushed to the partners
  auto push = [&](int q, const float(&w)[PER][G]) {
    const int b = q % n_buf;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (site(i) < len) st_async<G>(slot[i] + b * buf_bytes, w[i], mbar[i] + b * mbar_buf_bytes);
    }
  };

  // symmetric: one pass with real coefficients; asymmetric: conj(c), then c
  // applied to the first pass's output (in y)
  int q = 0;  // stages so far
  for (int pass = 0; pass < (kAsym ? 2 : 1); ++pass) {
    const float sgn = pass == 0 ? -1.f : 1.f;
    const float c0r = cr[0];
    const float c0i = kAsym ? sgn * ci[0] : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (pass == 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) tc[i][g] = y[i][g];
      }
      first_term<G, kAsym>(tc[i], tp[i], y[i], c0r, c0i);
    }
    if (n_ord <= 1) continue;
    float w[PER][G];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) w[i][g] = tc[i][g];
    }
    fetch(stage_table(tb, 0));
    push(q, w);
    for (int kk = 1; kk < n_ord; ++kk) {
      const float alpha = (kk == 1) ? 1.f : 2.f;
      const float beta = (kk == 1) ? 0.f : 1.f;
      for (int s = 0; s < tb.n_stages; ++s) {
        const bool last = s == tb.n_stages - 1;
        const bool more = !(last && kk == n_ord - 1);
        const int b = q % n_buf;
        const float* in = slots + (size_t)b * slice * G;
        const float ckr = coef[kk];
        const float cki = kAsym ? sgn * coef[C_pad + kk] : 0.f;
        float pa[PER], pb[PER], pbi[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) pa[i] = ca[i], pb[i] = cb[i], pbi[i] = cbi[i];
        if (more) fetch(stage_table(tb, last ? 0 : s + 1));
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (site(i) < len) {
            // the 32 slots of this warp's sites are filled
            mbar_wait(mbar0 + b * mbar_buf_bytes + 8 * (site(i) / 32), (q / n_buf) & 1);
            float x[G];
            ld_row<G>(in + (size_t)site(i) * G, x);
            stage_combine<G, kCplx>(w[i], x, pa[i], pb[i], pbi[i]);
            if (last) recurrence_step<G, kAsym>(w[i], tc[i], tp[i], y[i], alpha, beta, cih, ckr, cki);
          }
        }
        ++q;
        if (more) push(q, w);
        // the buffer's next use, two Bbar applications on
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (site(i) < len && site(i) % 32 == 0) {
            mbar_arm(mbar0 + b * mbar_buf_bytes + 8 * (site(i) / 32), block_bytes(site(i) / 32));
          }
        }
      }
    }
  }
  store_rows<G, PER, kPair>(a, f, lo, len, y);
  // no CTA leaves while a store to or from it may be in flight
  if (n_ord > 1) cl.sync();
}

// The one-CTA form: the frequency of plan rank rank0 + blockIdx.x, row group
// blockIdx.y; the whole rows ping-pong in shared memory, the tables come
// through the read-only cache, a stage ends in __syncthreads().
// Shared memory: rows [2][N][G] | coefficients [2][C_pad].
template <int G, int PER, bool kAsym, bool kCplx>
__device__ __forceinline__ void kpm_mf_single_body(const MfArgs& a, int rank0) {
  constexpr bool kPair = kAsym || kCplx;
  static_assert(!kPair || G % 2 == 0, "K7 and K8 carry whole vectors (re and im rows)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StageTables& tb = a.tb;
  const int N = tb.N, C_pad = a.C_pad;
  const int f = a.perm[rank0 + (int)blockIdx.x];
  const int n_ord = a.orders[f];
  const float* __restrict__ cr = a.cre + (size_t)f * C_pad;
  const float* __restrict__ ci = kAsym ? a.cim + (size_t)f * C_pad : nullptr;
  const float cih = a.cih;
  float* rows = reinterpret_cast<float*>(smem_raw);
  float* coef = rows + 2 * (size_t)N * G;

  float tc[PER][G], tp[PER][G], y[PER][G];
  load_rows<G, PER, kPair>(a, f, 0, N, tc);
  for (int j = threadIdx.x; j < n_ord && n_ord > 1; j += blockDim.x) {
    coef[j] = cr[j];
    if (kAsym) coef[C_pad + j] = ci[j];
  }
  int cur = 0;
  for (int pass = 0; pass < (kAsym ? 2 : 1); ++pass) {
    const float sgn = pass == 0 ? -1.f : 1.f;
    const float c0r = cr[0];
    const float c0i = kAsym ? sgn * ci[0] : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (pass == 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) tc[i][g] = y[i][g];
      }
      first_term<G, kAsym>(tc[i], tp[i], y[i], c0r, c0i);
    }
    if (n_ord <= 1) continue;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (site(i) < N) st_row<G>(rows + ((size_t)cur * N + site(i)) * G, tc[i]);
    }
    __syncthreads();
    for (int kk = 1; kk < n_ord; ++kk) {
      const float alpha = (kk == 1) ? 1.f : 2.f;
      const float beta = (kk == 1) ? 0.f : 1.f;
      const float ckr = coef[kk];
      const float cki = kAsym ? sgn * coef[C_pad + kk] : 0.f;
      for (int s = 0; s < tb.n_stages; ++s) {
        const size_t t_off = (size_t)stage_table(tb, s) * N;
        const bool last = s == tb.n_stages - 1;
        const float* in = rows + (size_t)cur * N * G;
        float* out = rows + (size_t)(cur ^ 1) * N * G;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int n = site(i);
          if (n < N) {
            float w[G], x[G];
            const float ca = __ldg(tb.A + t_off + n);
            const float cb = __ldg(tb.Bc + t_off + n);
            const float cbi = kCplx ? __ldg(tb.Bi + t_off + n) : 0.f;
            ld_row<G>(in + (size_t)__ldg(tb.P + t_off + n) * G, x);
            ld_row<G>(in + (size_t)n * G, w);
            stage_combine<G, kCplx>(w, x, ca, cb, cbi);
            if (last) recurrence_step<G, kAsym>(w, tc[i], tp[i], y[i], alpha, beta, cih, ckr, cki);
            st_row<G>(out + (size_t)n * G, w);
          }
        }
        __syncthreads();
        cur ^= 1;
      }
    }
  }
  store_rows<G, PER, kPair>(a, f, 0, N, y);
}

// K6: G rows of one frequency per cluster (kCluster) or per CTA.
template <int G, int PER, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads) kpm_mf_kernel(const MfArgs a, int rank0) {
  if constexpr (kCluster) {
    kpm_mf_cluster_body<G, PER, false, false>(a);
  } else {
    kpm_mf_single_body<G, PER, false, false>(a, rank0);
  }
}

// K7: G / 2 complex vectors of one frequency per cluster (kCluster) or per CTA.
template <int G, int PER, bool kCluster>
__global__ void __launch_bounds__(kCluster ? kMaxThreads : 512) kpm_mf_asym_kernel(const MfArgs a, int rank0) {
  if constexpr (kCluster) {
    kpm_mf_cluster_body<G, PER, true, false>(a);
  } else {
    kpm_mf_single_body<G, PER, true, false>(a, rank0);
  }
}

// K8: G / 2 complex vectors of one frequency per cluster (kCluster) or per
// CTA; kSym: one pass with real coefficients, else K7's two passes.
template <int G, int PER, bool kCluster, bool kSym>
__global__ void __launch_bounds__(kCluster ? kMaxThreads : 512) kpm_mf_cplx_kernel(const MfArgs a, int rank0) {
  if constexpr (kCluster) {
    kpm_mf_cluster_body<G, PER, !kSym, true>(a);
  } else {
    kpm_mf_single_body<G, PER, !kSym, true>(a, rank0);
  }
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

// Rows a cluster-form CTA carries: 4 where the 2B rows divide, else 2.
int cluster_rows(int B) { return (2 * B) % 4 == 0 ? 4 : 2; }

// A, B, slot and mbarrier addresses: 16 bytes a site and table; Bi 4 more.
size_t cluster_smem(int N, int n_tables, int n_stages, int C_pad, int G, int k, bool cplx) {
  const size_t slice = (N + k - 1) / k;
  const size_t n_buf = 2 * (size_t)n_stages;
  const size_t n_blk = (slice + 31) / 32;
  return 16 * ((n_buf * n_blk + 1) / 2) + n_buf * slice * G * sizeof(float) + 2 * (size_t)C_pad * sizeof(float) +
         (size_t)n_tables * slice * (cplx ? 20 : 16);
}

// Sites a thread of the cluster form takes at cluster size k: 1 up to 1024
// sites a CTA (the faster), 2 up to 2048; 0 where the form does not take the
// shape: a cluster size the card does not schedule, a slice its threads do
// not cover, or shared memory that does not fit.
int cluster_sites_per_thread(int B, int N, int n_tables, int n_stages, int C_pad, int k, bool cplx) {
  if (k != 1 && k != 2 && k != 4 && k != kMaxClusterSize && k != 16) return 0;
  const int slice = (N + k - 1) / k;
  if (N > 65535 || slice > 2 * kMaxThreads) return 0;
  if (cluster_smem(N, n_tables, n_stages, C_pad, cluster_rows(B), k, cplx) > kMaxSmem) return 0;
  return slice <= kMaxThreads ? 1 : 2;
}

// n_freq frequencies from rank0 of the plan, cluster > 0: as clusters of that
// many CTAs (cudaLaunchKernelEx); else one CTA each.
template <typename Kernel>
cudaError_t launch_mf(Kernel kernel, const MfArgs& a, int rank0, int n_freq, int n_groups, int threads, size_t smem,
                      int cluster, cudaStream_t stream) {
  if (n_freq <= 0) return cudaSuccess;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (cluster > kMaxClusterSize) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_freq * (cluster > 0 ? cluster : 1)), (unsigned)n_groups, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(cluster > 0 ? cluster : 1);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, rank0);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K6 (real, symmetric), K7 (real, asymmetric), K8 (kCplx, either).
template <bool kAsym, bool kCplx, int G, int PER, bool kCluster>
auto mf_kernel() {
  if constexpr (kCplx) {
    return kpm_mf_cplx_kernel<G, PER, kCluster, !kAsym>;
  } else if constexpr (kAsym) {
    return kpm_mf_asym_kernel<G, PER, kCluster>;
  } else {
    return kpm_mf_kernel<G, PER, kCluster>;
  }
}

template <bool kAsym, bool kCplx, int G, int PER>
cudaError_t launch_cluster_form(const MfArgs& a, int n_cluster, int k, cudaStream_t st) {
  const int slice = (a.tb.N + k - 1) / k;
  return launch_mf(mf_kernel<kAsym, kCplx, G, PER, true>(), a, 0, n_cluster, 2 * a.B / G, threads_for(slice, PER),
                   cluster_smem(a.tb.N, a.tb.n_tables, a.tb.n_stages, a.C_pad, G, k, kCplx), k, st);
}

template <bool kAsym, bool kCplx, int G, int PER>
cudaError_t launch_single_form(const MfArgs& a, int rank0, cudaStream_t st) {
  const size_t smem = (2 * (size_t)a.tb.N * G + 2 * (size_t)a.C_pad) * sizeof(float);
  return launch_mf(mf_kernel<kAsym, kCplx, G, PER, false>(), a, rank0, a.F - rank0, 2 * a.B / G,
                   threads_for(a.tb.N, PER), smem, 0, st);
}

int max_sites(bool asym, bool cplx) { return asym || cplx ? kK7MaxSites : kK6MaxSites; }

// The first n_cluster frequencies of the plan in the cluster form (none where
// the shape does not fit it), the others in the one-CTA form.
template <bool kAsym, bool kCplx>
int run_mf(const MfArgs& a, int n_cluster, int k, cudaStream_t st) {
  const int N = a.tb.N;
  if (N > max_sites(kAsym, kCplx) || a.B < 1 || a.F < 1) return (int)cudaErrorInvalidValue;
  const int per = cluster_sites_per_thread(a.B, N, a.tb.n_tables, a.tb.n_stages, a.C_pad, k, kCplx);
  if (per == 0) n_cluster = 0;
  n_cluster = n_cluster < 0 ? 0 : (n_cluster > a.F ? a.F : n_cluster);
  cudaError_t e = cudaSuccess;
  if (n_cluster > 0) {
    const int G = cluster_rows(a.B);
    if (G == 4 && per == 2) e = launch_cluster_form<kAsym, kCplx, 4, 2>(a, n_cluster, k, st);
    if (G == 4 && per == 1) e = launch_cluster_form<kAsym, kCplx, 4, 1>(a, n_cluster, k, st);
    if (G == 2 && per == 2) e = launch_cluster_form<kAsym, kCplx, 2, 2>(a, n_cluster, k, st);
    if (G == 2 && per == 1) e = launch_cluster_form<kAsym, kCplx, 2, 1>(a, n_cluster, k, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_cluster == a.F) return (int)cudaSuccess;
  if constexpr (kAsym || kCplx) {
    if (N <= 4 * 512) return (int)launch_single_form<kAsym, kCplx, 2, 4>(a, n_cluster, st);
    return (int)launch_single_form<kAsym, kCplx, 2, 16>(a, n_cluster, st);
  } else {
    if (N <= 2 * kMaxThreads) return (int)launch_single_form<false, false, 1, 2>(a, n_cluster, st);
    if (N <= 8 * kMaxThreads) return (int)launch_single_form<false, false, 1, 8>(a, n_cluster, st);
    return (int)launch_single_form<false, false, 1, 16>(a, n_cluster, st);
  }
}

}  // namespace

// The largest N the kernel of this factorization and hopping type takes.
extern "C" int smoqy_kpm_mf_max_sites(int symmetric, int cplx) { return max_sites(!symmetric, cplx != 0); }

// The sites a thread takes where the cluster form takes B vectors of N sites
// with these tables at cluster size k, else 0 (every frequency then takes the
// one-CTA form, whatever n_cluster says).
extern "C" int smoqy_kpm_mf_cluster_fits(int symmetric, int cplx, int B, int N, int n_tables, int C_pad, int k) {
  return cluster_sites_per_thread(B, N, n_tables, symmetric ? 2 * n_tables - 1 : n_tables, C_pad, k, cplx != 0);
}

// K6 (real hoppings, Bi null, symmetric: mirrored stages), K7 (real,
// asymmetric: stages in order, cim given) or K8 (complex hoppings, Bi given;
// cim given for the asymmetric passes): the first n_cluster frequencies of the
// plan as clusters of `cluster_size` CTAs, the others one CTA each.
extern "C" int smoqy_kpm_mf(const float* ure, const float* uim, float* yre, float* yim, const float* A,
                            const float* Bc, const float* Bi, const unsigned short* P, const float* cre,
                            const float* cim, const int* orders, const int* perm, float cih, int symmetric, int B,
                            int F, int N, int n_tables, int C_pad, int n_cluster, int cluster_size, void* stream) {
  const bool asym = !symmetric, cplx = Bi != nullptr;
  if (n_tables < 1 || (asym && cim == nullptr)) return (int)cudaErrorInvalidValue;
  MfArgs a;
  a.ure = ure, a.uim = uim, a.yre = yre, a.yim = yim;
  a.tb = StageTables{A, Bc, Bi, P, N, n_tables, asym ? n_tables : 2 * n_tables - 1, asym ? 0 : 1};
  a.cre = cre, a.cim = cim, a.orders = orders, a.perm = perm;
  a.cih = cih, a.B = B, a.F = F, a.C_pad = C_pad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cplx) {
    return asym ? run_mf<true, true>(a, n_cluster, cluster_size, st)
                : run_mf<false, true>(a, n_cluster, cluster_size, st);
  }
  return asym ? run_mf<true, false>(a, n_cluster, cluster_size, st)
              : run_mf<false, false>(a, n_cluster, cluster_size, st);
}
