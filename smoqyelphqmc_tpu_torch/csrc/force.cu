// Kernel K4: the Holstein force planes P1 and P2 from a given psi_raw, and in
// its SSH form the hop plane H of the SSH couplings.
//
// Replaces `_force_kernel` (the JAX package's ops/pallas_fused.py:934, its
// pallas_call in FusedForce.__call__ at :1004). For one walker's channel pair
// x = psi_raw (2, Ltau, N) and its shift matrix Lam (Ltau, N), symmetric
// factorization (B = CB^T D CB = B^T):
//
//   lam_psi_j = Lam_{j+1} (x_j / Lam_{j+1})          (the TPU kernels' op order)
//   w_l = B_l lam_psi_{l-1},  sw_l = sgn1_l w_l,  A_l = lam_psi_l + sw_l
//   P1_l = sum_ch (CB^T A_l) (CB^{-1} sw_l)
//   P2_l = sum_ch (A_{l-1} + sgnL_{l-1} B_l^T A_l) (x_{l-1} / Lam_l)   (want_p2)
//
// with sgn1 = +1 at tau 0 and sgnL = +1 at tau Ltau-1 (-1 elsewhere). K3
// (pcg_force.cu) runs the same function after its solve, one row at a time
// (force_epilogue.cuh:force_row).
//
// The SSH form (kSSH) adds the hop plane of the two color walks of the
// hopping derivative (ops/derivatives.py:add_M_derivative_force, symmetric
// factorization, both walks at dtau/2): with U = A_l and V = sw_l,
//
//   reverse walk, c = nc-1 .. 0:  h_c += sum_ch (U_b V_a + U_a V_b) over the
//                                 pairs (a, b) of color c; U <- K_c U, V <- K_c^{-1} V
//   (then U = CB^T A_l, V = CB^{-1} sw_l: P1)
//   U <- expV_l U,  V <- V / expV_l
//   forward walk, c = 0 .. nc-1:  h_c += the same products; U <- K_c U, V <- K_c^{-1} V
//
// H (Ltau, nc, P) a walker holds h_c at the color's pair slot q, 0 at the
// slots of self pairs (sites the color leaves alone, the padding);
// derivatives.ssh_force_from_hops contracts it with the couplings. The
// products ride on the half sweeps' stages, which load both buffers' pair
// values anyway, and the forward walk's U is P2's B_l A_l (expV before color
// 0, the colors forward), so the SSH form adds nc stages a block and no shared
// memory: H goes to device memory, and the forward walk adds to the reverse
// walk's value, which the same thread stored. SSH couplings make the hop
// tables tau-dependent, so the SSH form is the memory form alone.
//
// What bounds it on the H100: the depth of its color stages, not device
// memory (each input is read about once: ~0.5 us of bytes at the headline).
// Taken one row at a time (the earlier design, K3's epilogue), a row costs
// three B applications and two half sweeps per channel, each color stage
// behind a barrier with its tables read from L2 again: ~54 barrier stages a
// row. The design (K1's, csrc/mtm.cu, on this recipe):
//
// - tau blocks: a CTA takes T consecutive rows l0 .. l0+nr-1 of one walker.
//   It applies B to the nr+1 rows lam_psi_{l0-2} .. (w_{l0-1} .. w_{l0+nr-1}),
//   then CB^T to the nr rows A_{l0} .. and CB^{-1} to the nr rows sw_{l0} ..
//   in the same stages, and for P2 carries CB^T A_l on through expV and CB:
//   B_l^T A_l = B_l A_l = CB (D_l (CB^T A_l)), so the half sweep of P1 is the
//   first half of P2's B. One row at a time took 3 B and 2 half sweeps a
//   row; a block takes T+1 B and 3 half sweeps of T rows: 4 n_colors barrier
//   stages a block (12 at the honeycomb's 3 colors).
// - both channels in one stage: a site's two channels sit side by side as
//   one 8-byte value (pair_ops.cuh:f2), so one table entry and one access
//   serve both, and the stages of the two channels share their barriers.
// - K1's pair stages (pair_ops.cuh): pairs updated in place, the pair tables
//   in registers for the launch (the register form) or read once a stage
//   (the memory form, tau-dependent tables), padding pairs (N, N) on a spare
//   site, expV riding on a color stage.
// - rows in shared memory: Wb (lam_psi, then w, sw and CB^{-1} sw), Ab (A
//   for P2) and Ub (A, then CB^T A and B A), 3T+1 rows of two-channel
//   values. Where they fit beside them (the staged form), the block's rows
//   of x and Lam are staged by cp.async (3T+6 rows of floats) and lam_psi
//   and P2's x_{l-1} / Lam_l read them there; otherwise (N above ~3300 at
//   T = 1) from device memory, so the form takes N up to ~7200, as the
//   row-at-a-time design did.
// - the half sweeps take both buffers' pairs in one pass: a stage's loads
//   of CB^T A and CB^{-1} sw before its stores.
//
// T is chosen on the host (ops/force.py:tau_block_rows), as K1's is. A
// timed instantiation (kTimed) stamps each phase (ops/force.py:phase_names).
//
// C interface (bound with ctypes from ops/force.py): returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_ops.cuh"

namespace {

using namespace smoqy::pairs;

constexpr int kMaxThreads = 512;

struct ForceArgs {
  const float* x;    // (W, 2, Ltau, N) psi_raw
  const float* Lam;  // (W, Ltau, N)
  float* P1;         // (W, Ltau, N)
  float* P2;         // (W, Ltau, N)
  float* H;          // (W, Ltau, n_colors, P): the SSH form's hop plane
  int tau_rows;      // T
  int nblk;          // tau blocks a walker
  int want_p2;
};

__device__ __forceinline__ int mod_tau(int l, int L) { return ((l % L) + L) % L; }

// One color of the half sweeps in one pass over the pairs: U <- K_c U and
// V <- K_c^{-1} V (the sinh negated) on nrows rows each, every load of a
// pair's four values before its stores. The register form's color CC.
template <int K, int CC>
__device__ __forceinline__ void reg_half_stage(const PairTabs<float>& tb, const RegTabs<float, K>& r, f2* U, f2* V,
                                               int nrows) {
  for (int i = 0; i < nrows; ++i) {
    f2* u = U + (size_t)i * tb.ld;
    f2* v = V + (size_t)i * tb.ld;
    f2 ua[K], ub[K], va[K], vb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = r.ab[CC][k] & 0xffffu, b = r.ab[CC][k] >> 16;
      ua[k] = u[a];
      ub[k] = u[b];
      va[k] = v[a];
      vb[k] = v[b];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = r.ab[CC][k] & 0xffffu, b = r.ab[CC][k] >> 16;
      const float c = r.c[CC][k], sn = r.s[CC][k];
      u[a] = madd(c, ua[k], sn * ub[k]);
      u[b] = madd(c, ub[k], sn * ua[k]);
      v[a] = madd(c, va[k], (-sn) * vb[k]);
      v[b] = madd(c, vb[k], (-sn) * va[k]);
    }
  }
}

// The half sweeps' color c on U (CB^T) and V (CB^{-1}) behind one barrier:
// the register form in one pass, the memory form as two color stages.
template <int K>
__device__ __forceinline__ void half_stage(const PairTabs<float>& tb, const RegTabs<float, K>& r, int c, f2* U,
                                           f2* V, int nrows, int tau0) {
  if constexpr (K > 0) {
    if (c == 0) reg_half_stage<K, 0>(tb, r, U, V, nrows);
    else if (c == 1) reg_half_stage<K, 1>(tb, r, U, V, nrows);
    else reg_half_stage<K, 2>(tb, r, U, V, nrows);
  } else {
    color_stage<float, 0, f2, false>(tb, r, c, kNone, U, nrows, tau0);
    color_stage<float, 0, f2, true>(tb, r, c, kNone, V, nrows, tau0);
  }
}

// The SSH form's color c of either walk on nrows rows, in one pass over the
// pairs (the memory form's tables): for each pair (a, b), its product
// sum_ch (U_b V_a + U_a V_b) (0 for a self pair) into the hop plane H (row i
// at H + i nc P, slot q of color c), stored or, with kAdd, added to what this
// thread stored there; then U <- K_c U and V <- K_c^{-1} V. kScale first
// takes U <- expV U and V <- V / expV (the forward walk's color 0).
template <bool kAdd, bool kScale>
__device__ void ssh_stage(const PairTabs<float>& tb, int c, f2* U, f2* V, float* H, int nrows, int tau0) {
  constexpr int G = 4;
  const int Km = tb.P / blockDim.x;
  const int rows = tb.tau_tabs ? tb.Ltau : 1;
  for (int k0 = 0; k0 < Km; k0 += G) {
    const int g = Km - k0 < G ? Km - k0 : G;
    unsigned ab[G];
    int q[G];
    float cv[G], sv[G];
    size_t t0[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {  // a short group repeats its first pair: the same values written twice
      q[j] = threadIdx.x + (j < g ? k0 + j : k0) * blockDim.x;
      ab[j] = __ldg(tb.ab + (size_t)c * tb.P + q[j]);
      t0[j] = (size_t)c * rows * tb.P + q[j];
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
      f2* u = U + (size_t)i * tb.ld;
      f2* v = V + (size_t)i * tb.ld;
      float* h = H + ((size_t)i * tb.n_colors + c) * tb.P;
      const float* E = tb.expV + (size_t)tau * tb.ld;
      f2 ua[G], ub[G], va[G], vb[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int a = ab[j] & 0xffffu, b = ab[j] >> 16;
        ua[j] = u[a];
        ub[j] = u[b];
        va[j] = v[a];
        vb[j] = v[b];
        if (kScale) {
          const float ea = __ldg(E + a), eb = __ldg(E + b);
          ua[j] *= ea;
          ub[j] *= eb;
          va[j] = {va[j].x / ea, va[j].y / ea};
          vb[j] = {vb[j].x / eb, vb[j].y / eb};
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j >= g) break;
        const int a = ab[j] & 0xffffu, b = ab[j] >> 16;
        const float hv = a == b ? 0.f
                                : ub[j].x * va[j].x + ub[j].y * va[j].y + ua[j].x * vb[j].x + ua[j].y * vb[j].y;
        h[q[j]] = kAdd ? h[q[j]] + hv : hv;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int a = ab[j] & 0xffffu, b = ab[j] >> 16;
        const float cs = cv[j], sn = sv[j];
        u[a] = madd(cs, ua[j], sn * ub[j]);
        u[b] = madd(cs, ub[j], sn * ua[j]);
        v[a] = madd(cs, va[j], (-sn) * vb[j]);
        v[b] = madd(cs, vb[j], (-sn) * va[j]);
      }
    }
  }
}

// The block's reads of x and Lam: from the rows staged in shared memory
// (kStaged: x_{l0-2} .. x_{l0+nr-1} of both channels and Lam_{l0-1} ..
// Lam_{l0+nr}, by cp.async) or from device memory. Row i of either is
// x_{l0-2+i} and Lam_{l0-1+i}, the Lam that lam_psi_{l0-2+i} divides by.
template <bool kStaged>
struct BlockRows {
  const float* x0;  // channel 0; channel 1 at x1
  const float* x1;
  const float* lam;
  int l0, L, N;

  __device__ const float* x(int ch, int i) const {
    const float* p = ch ? x1 : x0;
    return kStaged ? p + (size_t)i * N : p + (size_t)mod_tau(l0 - 2 + i, L) * N;
  }
  __device__ const float* la(int i) const {
    return kStaged ? lam + (size_t)i * N : lam + (size_t)mod_tau(l0 - 1 + i, L) * N;
  }
  // lam_psi_{l0-2+i} = Lam_{l0-1+i} (x_{l0-2+i} / Lam_{l0-1+i}) at site n
  __device__ f2 lam_psi(int i, int n) const {
    const float l1 = la(i)[n];
    return {l1 * (x(0, i)[n] / l1), l1 * (x(1, i)[n] / l1)};
  }
};

// One CTA a tau block: walker blockIdx.x / nblk, rows l0 .. l0+nr-1 with
// l0 = (blockIdx.x % nblk) * tau_rows. tb.expV holds every walker's (Ltau, ld)
// rows one after the other.
template <int K, bool kTimed, bool kStaged, bool kSSH>
__global__ void __launch_bounds__(kMaxThreads)
force_kernel(const ForceArgs a, PairTabs<float> tb, unsigned long long* stamps) {
  static_assert(!kSSH || K == 0, "the SSH form is the memory form");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long st_sh[kTimed ? kMaxStamps : 1];
  Stamps<kTimed> st;
  if constexpr (kTimed) st.sh = st_sh;
  st.start();
  const int N = tb.N, L = tb.Ltau, ld = tb.ld, nc = tb.n_colors;
  const int walker = blockIdx.x / a.nblk;
  const int l0 = (blockIdx.x % a.nblk) * a.tau_rows;
  const int nr = min(a.tau_rows, L - l0);
  const size_t plane = (size_t)L * N;
  tb.expV += (size_t)walker * L * ld;
  float* H = nullptr;  // the SSH form: the block's rows of the hop plane
  if constexpr (kSSH) H = a.H + ((size_t)walker * L + l0) * nc * tb.P;
  const float* x0 = a.x + 2 * walker * plane;  // channel 1 one plane on
  const float* lam = a.Lam + walker * plane;
  f2* Wb = reinterpret_cast<f2*>(smem_raw);  // nr + 1 rows: lam_psi, w, sw, CB^{-1} sw
  f2* Ab = Wb + (size_t)(nr + 1) * ld;       // nr rows: A_{l0-1} .. A_{l0+nr-2}
  f2* Ub = Ab + (size_t)nr * ld;             // nr rows: A_{l0} .., CB^T A, B A
  BlockRows<kStaged> rows{x0, x0 + plane, lam, l0, L, N};
  if constexpr (kStaged) {
    float* X0 = reinterpret_cast<float*>(Ub + (size_t)nr * ld);
    float* X1 = X0 + (size_t)(nr + 2) * N;
    float* LA = X1 + (size_t)(nr + 2) * N;
    smoqy::stage_rows_async(X0, x0, mod_tau(l0 - 2, L), nr + 2, L, N);
    smoqy::stage_rows_async(X1, x0 + plane, mod_tau(l0 - 2, L), nr + 2, L, N);
    smoqy::stage_rows_async(LA, lam, mod_tau(l0 - 1, L), nr + 2, L, N);
    smoqy::cp_async_commit();
    rows = BlockRows<kStaged>{X0, X1, LA, l0, L, N};
  }
  RegTabs<float, K> r;
  if constexpr (K > 0) load_regs(tb, r);  // while the rows arrive
  if constexpr (kStaged) smoqy::cp_async_wait<0>();
  __syncthreads();

  // Wb[i] = lam_psi_{l0-2+i}, i = 0 .. nr
  for (int i = 0; i <= nr; ++i)
    for (int n = threadIdx.x; n < N; n += blockDim.x) Wb[(size_t)i * ld + n] = rows.lam_psi(i, n);
  __syncthreads();
  st.mark();

  // Wb[i] = w_{l0-1+i} = B_{l0-1+i} lam_psi_{l0-2+i}
  apply_B(tb, r, Wb, nr + 1, mod_tau(l0 - 1, L), st);

  // with l = l0-1+i: Wb[i] = sw_l, A_l = lam_psi_l + sw_l into Ab[i] (l <
  // l0+nr-1, for P2) and Ub[i-1] (l >= l0, for the half sweeps)
  for (int i = 0; i <= nr; ++i) {
    const float s1 = mod_tau(l0 - 1 + i, L) == 0 ? 1.f : -1.f;
    f2* w = Wb + (size_t)i * ld;
    f2* A = i < nr ? Ab + (size_t)i * ld : nullptr;
    f2* U = i > 0 ? Ub + (size_t)(i - 1) * ld : nullptr;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const f2 sw = s1 * w[n];
      const f2 v = rows.lam_psi(i + 1, n) + sw;
      w[n] = sw;
      if (A != nullptr) A[n] = v;
      if (U != nullptr) U[n] = v;
    }
  }
  __syncthreads();
  st.mark();

  // Ub = CB^T A_l and Wb[1..] = CB^{-1} sw_l: the colors reversed, the inverse
  // with the sinh negated, in the same stages
  // (the SSH form: each color's hop products first, the reverse walk)
  for (int c = nc - 1; c >= 0; --c) {
    if constexpr (kSSH) ssh_stage<false, false>(tb, c, Ub, Wb + ld, H, nr, l0);
    else half_stage<K>(tb, r, c, Ub, Wb + ld, nr, l0);
    __syncthreads();
    st.mark();
  }

  float* P1 = a.P1 + walker * plane + (size_t)l0 * N;
  for (int i = 0; i < nr; ++i) {
    const f2* u = Ub + (size_t)i * ld;
    const f2* v = Wb + (size_t)(i + 1) * ld;
    for (int n = threadIdx.x; n < N; n += blockDim.x) P1[(size_t)i * N + n] = u[n].x * v[n].x + u[n].y * v[n].y;
  }
  float* P2 = a.P2 + walker * plane + (size_t)l0 * N;
  if constexpr (kSSH) {
    // the forward walk: Ub = B_l A_l as below, Wb[1..] carried through
    // expV^{-1} and the inverse colors, each color's hop products added
    __syncthreads();
    st.mark();
    for (int c = 0; c < nc; ++c) {
      if (c == 0) ssh_stage<true, true>(tb, c, Ub, Wb + ld, H, nr, l0);
      else ssh_stage<true, false>(tb, c, Ub, Wb + ld, H, nr, l0);
      __syncthreads();
      st.mark();
    }
  }
  if (!a.want_p2) {
    for (int i = 0; i < nr; ++i)
      for (int n = threadIdx.x; n < N; n += blockDim.x) P2[(size_t)i * N + n] = 0.f;
    st.mark();
    st.finish(stamps);
    return;
  }
  if constexpr (!kSSH) {
    __syncthreads();
    st.mark();

    // Ub = B_l A_l = CB (expV_l (CB^T A_l)): expV before color 0, the colors forward
    if (nc == 0) {
      scale_rows(tb, Ub, nr, l0);
      __syncthreads();
      st.mark();
    }
    for (int c = 0; c < nc; ++c) {
      color_stage<float, K, f2, false>(tb, r, c, c == 0 ? kBefore : kNone, Ub, nr, l0);
      __syncthreads();
      st.mark();
    }
  }

  // P2_l = sum_ch (A_{l-1} + sgnL_{l-1} B_l A_l) x_{l-1} / Lam_l, l = l0 + i:
  // x_{l-1} and Lam_l are the block's row i + 1
  for (int i = 0; i < nr; ++i) {
    const float sL = mod_tau(l0 + i - 1, L) == L - 1 ? 1.f : -1.f;
    const f2* A = Ab + (size_t)i * ld;
    const f2* u = Ub + (size_t)i * ld;
    const float* xa = rows.x(0, i + 1);
    const float* xb = rows.x(1, i + 1);
    const float* la = rows.la(i + 1);
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float m0 = A[n].x + sL * u[n].x, m1 = A[n].y + sL * u[n].y;
      P2[(size_t)i * N + n] = m0 * (xa[n] / la[n]) + m1 * (xb[n] / la[n]);
    }
  }
  st.mark();
  st.finish(stamps);
}

// Wb, Ab, Ub: 3T + 1 rows of ld two-channel values; staged, also x (both
// channels) and Lam: 3T + 6 rows of N floats.
size_t smem_bytes(int N, int tau_rows, bool staged) {
  return (size_t)(3 * tau_rows + 1) * row_ld<f2>(N) * sizeof(f2) +
         (staged ? (size_t)(3 * tau_rows + 6) * N * sizeof(float) : 0);
}

template <bool kTimed, bool kStaged>
const void* kernel_for(int K, bool ssh) {
  if (ssh) return K == 0 ? (const void*)force_kernel<0, kTimed, kStaged, true> : nullptr;
  switch (K) {
    case 0: return (const void*)force_kernel<0, kTimed, kStaged, false>;
    case 1: return (const void*)force_kernel<1, kTimed, kStaged, false>;
    case 2: return (const void*)force_kernel<2, kTimed, kStaged, false>;
    case 3: return (const void*)force_kernel<3, kTimed, kStaged, false>;
    case 4: return (const void*)force_kernel<4, kTimed, kStaged, false>;
    case 5: return (const void*)force_kernel<5, kTimed, kStaged, false>;
    default: return nullptr;
  }
}

const void* kernel_for(int K, bool timed, bool staged, bool ssh) {
  if (timed) return staged ? kernel_for<true, true>(K, ssh) : kernel_for<true, false>(K, ssh);
  return staged ? kernel_for<false, true>(K, ssh) : kernel_for<false, false>(K, ssh);
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int smoqy_force_row_ld(int N) { return row_ld<f2>(N); }

extern "C" int smoqy_force_smem_bytes(int N, int tau_rows, int staged) {
  return (int)smem_bytes(N, tau_rows, staged != 0);
}

// CTAs of K4 resident on the card at once for a launch of this form (the
// occupancy API times the SM count); negative: a CUDA error.
extern "C" int smoqy_force_resident(int K, int staged, int ssh, int threads, int smem) {
  const void* fn = kernel_for(K, false, staged != 0, ssh != 0);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// x: (W, 2, Ltau, N); Lam, P1, P2: (W, Ltau, N); ab, C, S: K1's pair tables
// (pair sites, cosh, sinh: (n_colors, [rows,] P)); expV: (W, Ltau, ld) with 1
// in the padding columns. K: pairs a thread a color of the register form, 0
// the memory form; staged: x and Lam staged in shared memory; ssh: the SSH
// form, H (W, Ltau, n_colors, P) its hop plane (the memory form, at least one
// color). stamps: null, or the timed instantiation's buffer.
extern "C" int smoqy_force(const float* x, const float* Lam, float* P1, float* P2, float* H, const unsigned* ab,
                           const float* C, const float* S, const float* expV, int n_walkers, int Ltau, int N,
                           int n_colors, int P, int tau_tabs, int tau_rows, int threads, int K,
                           int staged, int want_p2, int ssh, void* stamps, void* stream) {
  if (n_walkers < 1 || tau_rows < 1 || tau_rows > Ltau || threads < 32 || threads > kMaxThreads || threads % 32 ||
      P < threads || P % threads || N >= 0xffff ||
      (K > 0 && (tau_tabs || n_colors > kRegColors || K != P / threads)) ||
      (ssh && (K != 0 || n_colors < 1 || H == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(K, stamps != nullptr, staged != 0, ssh != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  PairTabs<float> tb;
  tb.ab = ab;
  tb.C = C;
  tb.S = S;
  tb.expV = expV;
  tb.N = N;
  tb.ld = row_ld<f2>(N);
  tb.Ltau = Ltau;
  tb.n_colors = n_colors;
  tb.P = P;
  tb.tau_tabs = tau_tabs;
  tb.symmetric = 1;
  ForceArgs a{x, Lam, P1, P2, H, tau_rows, (Ltau + tau_rows - 1) / tau_rows, want_p2};
  const size_t smem = smem_bytes(N, tau_rows, staged != 0);
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* st = static_cast<unsigned long long*>(stamps);
  void* args[] = {(void*)&a, (void*)&tb, (void*)&st};
  e = cudaLaunchKernel(fn, dim3(n_walkers * a.nblk), dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
