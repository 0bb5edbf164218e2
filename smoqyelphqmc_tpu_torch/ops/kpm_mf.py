"""Kernels K6, K7 and K8: the matrix-free KPM apply, with its plain PyTorch versions.

y = sum_k c_k(f) T_k(Bbar') u for every frequency row f of complex
frequency-space vectors u = (u_re, u_im) of shape (..., F, N), with
Bbar' = (Bbar - center) / half applied through the tau-averaged checkerboard
and each frequency's recurrence running to its own live order (coefficients
beyond it are zero). The port's counterpart of the KPM part of
the JAX package's ops/pallas_fused.py (:1468-1651):

- symmetric factorization: real coefficients, one pass; the re and im planes
  are independent rows (K6, `csrc/kpm_mf.cu:kpm_mf_kernel`, replacing
  `_kpm_mf_kernel`);
- asymmetric factorization: two passes, conj(c) then c, the complex
  coefficients acting through the i-rotation (re, im) -> (-im, re) of one
  vector (K7, `csrc/kpm_mf.cu:kpm_mf_asym_kernel`, replacing
  `_kpm_mf_asym_kernel`);
- complex hoppings (`complex_pair`): (u_re, u_im) is the channel pair the
  checkerboard mixes, re' = C re + S re[p] - S_im im[p] and
  im' = C im + S im[p] + S_im re[p]; one pass with real coefficients
  (symmetric) or the two conjugate passes through the i-rotation of the same
  pair (asymmetric) (K8, `csrc/kpm_mf.cu:kpm_mf_cplx_kernel`, replacing
  `_kpm_mf_cplx_kernel`): K6 / K7's bodies with the stages' mixing form.

`kpm_mf_apply(ops, u_re, u_im)` is the dispatcher: a CPU tensor takes the
plain version (`kpm_mf_plain` / `kpm_mf_asym_plain`, the `_mf_cheb`
recurrence of the JAX package's ops/kpm.py:611-656, or `kpm_mf_cplx_plain`,
its `_mf_cheb_pair` at :659-700), a CUDA tensor launches the kernel or
raises. The static plan is the frequency order sorted by
descending order (`build_kpm_mf_plan`): the kernels start the longest
recurrences first.

The kernels apply Bbar / half as stage tables (`build_stage_tables`; for
complex hoppings `build_stage_tables_pair`, whose B is complex): a few
gathers x <- A x + B x[P] with the diagonal, the map's 1 / half and, for the
symmetric form, the middle color on both sides of the diagonal folded into
the coefficients. The plan's head, the frequencies with more than
ORDER_THRESHOLD live orders, runs as thread-block clusters of CLUSTER_SIZE
CTAs (fewer on small lattices, `cluster_size_for`) that split the sites
(`split_plan`), the others one CTA each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..tracing import KernelCounter
from .kpm import AveragedPropagator

KPM_MF = KernelCounter("kpm_mf")
KPM_MF_ASYM = KernelCounter("kpm_mf_asym")
KPM_MF_CPLX = KernelCounter("kpm_mf_cplx")

# K6 / K7's launch constants, chosen on an NVIDIA H100 80GB HBM3 (700 W) at
# the L=48 shape (u 2 x (2, 240, 4608)) with time_kpm_mf.py --grid; the
# measurements are in PERF.md. Frequencies with more live orders than
# ORDER_THRESHOLD take the cluster form, CLUSTER_SIZE CTAs each owning
# N / CLUSTER_SIZE sites; the others the one-CTA form in a second launch.
# Threshold 0 (every frequency a cluster, one launch) measured fastest: K6
# 0.225 ms against 0.26 and 0.35 at thresholds 4 and 16, K7 0.14 against 0.20
# and 0.30; cluster size 8 beat 4 (K7 0.14 against 0.26; at 4 a slice takes 2
# sites a thread); the non-portable 16 came 11-15% faster and is not taken
# (a card may refuse it). A stage costs least at ~300-600 sites a CTA: at
# N=1152 (same Ltau) a cluster of 4 beat 8 (K6 0.187 against 0.240 ms, K7
# 0.110 against 0.142), so the cluster halves while a slice would fall below
# MIN_SLICE_SITES.
ORDER_THRESHOLD = 0
CLUSTER_SIZE = 8
MIN_SLICE_SITES = 256


def build_kpm_mf_plan(phi: np.ndarray) -> np.ndarray:
    """The static plan: the frequencies (F,) int32 in descending order, the
    sort of `build_kpm_mf_plan` (pallas_fused.py:1516-1517) taken by
    ascending phi_eff = min(phi, 2 pi - phi). The static caps and the live
    orders both grow with 1 / phi_eff, so this sorts both (the JAX package
    sorts by the caps alone, whose ties hide live orders that differ). The
    kernels index each frequency's own row, so no inverse is needed."""
    phi = np.asarray(phi)
    return np.argsort(np.minimum(phi, 2 * np.pi - phi), kind="stable").astype(np.int32)


@dataclasses.dataclass
class KPMMFOperands:
    """One refresh's operands of the matrix-free apply, in float32.

    bbar: Bbar in float32 (the plain versions apply it); center and inv_half
    the affine map to Bbar' (f32 values); cih = center * inv_half, folded
    into the kernels' recurrence as the TPU kernels fold it; coefs_re /
    coefs_im (F, C_pad); orders (F,) int32 live orders (host copy
    `orders_host`); perm (F,) int32 the plan's sort; S_im (n_colors, N)
    Bbar's S_im for complex hoppings (complex_pair; None otherwise); stage_A,
    stage_B (n_tables, N) float32 and stage_P (n_tables, N) 16-bit partners,
    the kernels' stage tables of Bbar / half (`build_stage_tables`, or
    `build_stage_tables_pair` with stage_B_im, B's imaginary part, for
    complex hoppings; None above 65535 sites); perm_host the plan's host
    copy; launch_plans the `cluster_plan`s made so far (an apply runs
    thousands of times per refresh)."""

    bbar: AveragedPropagator
    center: float
    inv_half: float
    cih: float
    coefs_re: torch.Tensor
    coefs_im: torch.Tensor
    orders: torch.Tensor
    orders_host: np.ndarray
    perm: torch.Tensor
    symmetric: bool
    S_im: Optional[torch.Tensor] = None
    stage_A: Optional[torch.Tensor] = None
    stage_B: Optional[torch.Tensor] = None
    stage_B_im: Optional[torch.Tensor] = None
    stage_P: Optional[torch.Tensor] = None
    perm_host: Optional[np.ndarray] = None
    launch_plans: dict = dataclasses.field(default_factory=dict)

    @property
    def n_sites(self) -> int:
        return self.bbar.expV.shape[0]

    @property
    def complex_pair(self) -> bool:
        return self.S_im is not None


def pack_partner16(partner: torch.Tensor) -> torch.Tensor:
    """Site indices 0..65535 as 16-bit words (an int16 tensor holding the
    unsigned values' bits: torch has no arithmetic on uint16); refuses more
    than 65535 sites."""
    if partner.shape[-1] > 65535:
        raise ValueError(f"16-bit partners take at most 65535 sites, got {partner.shape[-1]}")
    p = partner.to(torch.int32)
    return torch.where(p >= 32768, p - 65536, p).to(torch.int16).contiguous()


def unpack_partner16(packed: torch.Tensor) -> torch.Tensor:
    """The site indices of `pack_partner16`, int64."""
    return packed.to(torch.int64) & 0xFFFF


def _fold_stage_tables(bbar: AveragedPropagator, inv_half: float):
    """(A, B, B_im, P, stages) of `build_stage_tables` (B_im None) or
    `build_stage_tables_pair`."""
    cb = bbar.cb
    e = bbar.expV * inv_half
    sites = torch.arange(e.shape[0], device=e.device)
    cplx = cb.S_im is not None
    if cb.n_colors == 0:
        z = torch.zeros_like(e)[None]
        return e[None].clone(), z, z.clone() if cplx else None, sites[None], [0]
    A, B, P = cb.C.clone(), cb.S.clone(), cb.partner.clone()
    B_im = cb.S_im.clone() if cplx else None
    if not torch.equal(P.gather(1, P), sites.expand_as(P)):
        raise ValueError("a checkerboard color's partner table does not pair the sites")
    if not bbar.symmetric:
        A[-1] *= e
        B[-1] *= e
        if cplx:
            B_im[-1] *= e
        return A, B, B_im, P, list(range(cb.n_colors))
    C0, S0, p0 = cb.C[0], cb.S[0], cb.partner[0]
    stages = [abs(s - (cb.n_colors - 1)) for s in range(2 * cb.n_colors - 1)]
    if not cplx:
        A[0] = C0 * C0 * e + S0 * S0[p0] * e[p0]
        B[0] = C0 * S0 * e + S0 * C0[p0] * e[p0]
        return A, B, None, P, stages
    # s_n s_p = (S_n S_p - I_n I_p) + i (S_n I_p + I_n S_p), I the signed S_im
    I0 = cb.S_im[0]
    A[0] = C0 * C0 * e + (S0 * S0[p0] - I0 * I0[p0]) * e[p0]
    A_im = (S0 * I0[p0] + I0 * S0[p0]) * e[p0]
    if bool((A_im != 0).any()):
        raise ValueError("complex stage tables: the middle block's diagonal is not real (a pair's S_im sides "
                         "are not conjugate)")
    B[0] = C0 * S0 * e + S0 * C0[p0] * e[p0]
    B_im[0] = C0 * I0 * e + I0 * C0[p0] * e[p0]
    return A, B, B_im, P, stages


def build_stage_tables(bbar: AveragedPropagator, inv_half: float):
    """Bbar / half (real hoppings) as gathers x <- A_t x + B_t x[P_t]:
    (A, B, P, stages) with A, B (n_tables, N) in Bbar's dtype, P (n_tables, N)
    int64 and `stages` the order in which an application takes the tables.

    Asymmetric (Bbar = expV CB): the colors in order, expV / half multiplied
    into the last. Symmetric (Bbar = CB expV CB^T, the transpose being the
    colors reversed with the same C and S): table 0 is the middle block
    K_0 (expV / half) K_0 of color 0, whose pairs (n, p) close on themselves,

        a[n] = C0[n]^2 e[n] + S0[n] S0[p] e[p],
        b[n] = C0[n] S0[n] e[n] + S0[n] C0[p] e[p],

    and an application takes the colors n-1 .. 1, table 0, the colors
    1 .. n-1: 2 n - 1 gathers. Every table must pair the sites (P[P[n]] = n):
    the fold and the kernels' exchange of sites between CTAs rest on it."""
    if bbar.cb.S_im is not None:
        raise ValueError("build_stage_tables: real hoppings only; complex hoppings take build_stage_tables_pair")
    A, B, _, P, stages = _fold_stage_tables(bbar, inv_half)
    return A, B, P, stages


def build_stage_tables_pair(bbar: AveragedPropagator, inv_half: float):
    """Bbar / half for complex hoppings (K8) as gathers of the channel pair
    z = re + i im, z <- A_t z + (B_t + i B_im_t) z[P_t]: (A, B, B_im, P,
    stages), a color's s = S + i S_im carrying S_im's sign per pair side.

    Asymmetric (Bbar = expV CB): the colors in order, expV / half multiplied
    into the last. Symmetric (Bbar = CB expV CB^H, the adjoint being the
    colors reversed with the same tables, each 2x2 block Hermitian): table 0
    is the middle block K_0 e K_0 of color 0,

        a[n] = C0[n]^2 e[n] + s[n] s[p] e[p],
        b[n] = s[n] (C0[n] e[n] + C0[p] e[p]),

    where s[p] = conj(s[n]) makes a real (checked: a complex a raises), and the
    stages are the real form's. Every table must pair the sites."""
    if bbar.cb.S_im is None:
        raise ValueError("build_stage_tables_pair: complex hoppings only; real hoppings take build_stage_tables")
    return _fold_stage_tables(bbar, inv_half)


def apply_stage_tables(A, B, P, stages, u: torch.Tensor, B_im=None) -> torch.Tensor:
    """The stage tables applied to u (..., N) in plain PyTorch ops: what one
    Bbar / half application of the kernels computes. With B_im (complex
    hoppings) u is a channel pair (..., 2, R, N), re and im at axis -3."""
    for t in stages:
        up = u.index_select(-1, P[t])
        if B_im is None:
            u = A[t] * u + B[t] * up
            continue
        re, im, pr, pi = u[..., 0, :, :], u[..., 1, :, :], up[..., 0, :, :], up[..., 1, :, :]
        u = torch.stack([A[t] * re + B[t] * pr - B_im[t] * pi, A[t] * im + B[t] * pi + B_im[t] * pr], dim=-3)
    return u


def split_plan(perm: np.ndarray, orders: np.ndarray, threshold: int):
    """The plan cut in two: (cluster part, one-CTA part), a prefix and the
    rest of `perm`. The prefix ends at the last frequency with more than
    `threshold` live orders, so every such frequency is in it."""
    above = np.flatnonzero(np.asarray(orders)[perm] > threshold)
    n = int(above[-1]) + 1 if above.size else 0
    return perm[:n], perm[n:]


def cluster_size_for(n_sites: int) -> int:
    """CLUSTER_SIZE, halved while a CTA's slice would fall below MIN_SLICE_SITES."""
    k = CLUSTER_SIZE
    while k > 1 and n_sites < k * MIN_SLICE_SITES:
        k //= 2
    return k


def build_operands(pre) -> KPMMFOperands:
    """The operands of a matrix-free KPMPreconditioner's current refresh."""
    f32 = torch.float32
    dev = pre.bbar.expV.device
    center = float(np.float32(pre.center))
    inv_half = float(np.float32(1.0 / max(pre.half, 1e-12)))
    bbar = pre.bbar.to_dtype(f32)
    stage = dict(stage_A=None, stage_B=None, stage_B_im=None, stage_P=None)
    if bbar.expV.shape[0] <= 65535:
        A, B, B_im, P, _ = _fold_stage_tables(bbar, inv_half)
        stage = dict(stage_A=A.contiguous(), stage_B=B.contiguous(),
                     stage_B_im=None if B_im is None else B_im.contiguous(), stage_P=pack_partner16(P))
    perm = build_kpm_mf_plan(pre.phi)
    return KPMMFOperands(
        bbar=bbar,
        center=center,
        inv_half=inv_half,
        cih=float(np.float32(center) * np.float32(inv_half)),
        coefs_re=pre.coefs_re.to(f32).contiguous(),
        coefs_im=pre.coefs_im.to(f32).contiguous(),
        orders=torch.as_tensor(pre.orders, dtype=torch.int32, device=dev),
        orders_host=np.asarray(pre.orders, dtype=np.int32),
        perm=torch.as_tensor(perm, device=dev),
        symmetric=pre.symmetric,
        S_im=None if bbar.cb.S_im is None else bbar.cb.S_im.contiguous(),
        perm_host=perm,
        **stage,
    )


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------


def _mf_cheb(ops: KPMMFOperands, u_re, u_im, cre, cim):
    """One Chebyshev pass y = sum_k c_k T_k(Bbar') u, the real and imaginary
    planes stacked as one recurrence state at axis -3 (the channel pair Bbar
    mixes when ops.complex_pair); cim None means real coefficients. Runs to
    the largest live order: the coefficients beyond it are zero."""
    n_orders = int(ops.orders_host.max())

    def applyBp(t):
        return (ops.bbar.apply(t) - ops.center * t) * ops.inv_half

    def rot(t):  # i (re, im) = (-im, re)
        return torch.stack([-t[..., 1, :, :], t[..., 0, :, :]], dim=-3)

    def term(k, t):
        out = cre[:, k][:, None] * t
        return out if cim is None else out + cim[:, k][:, None] * rot(t)

    t_prev = torch.stack([u_re, u_im], dim=-3)
    y = term(0, t_prev)
    if n_orders > 1:
        t_cur = applyBp(t_prev)
        for k in range(1, n_orders):
            y = y + term(k, t_cur)
            if k + 1 < n_orders:
                t_prev, t_cur = t_cur, 2.0 * applyBp(t_cur) - t_prev
    return y[..., 0, :, :], y[..., 1, :, :]


def _require_real(ops: KPMMFOperands, what: str) -> None:
    if ops.complex_pair:
        raise ValueError(f"{what}: real hoppings only; complex hoppings take K8 (kpm_mf_cplx)")


def kpm_mf_plain(ops: KPMMFOperands, u_re, u_im):
    """K6's function in plain PyTorch ops (symmetric factorization)."""
    _require_real(ops, "kpm_mf (K6)")
    KPM_MF.plain_calls += 1
    return _mf_cheb(ops, u_re, u_im, ops.coefs_re, None)


def _two_passes(ops: KPMMFOperands, u_re, u_im):
    """conj(c), then c: the asymmetric factorization's two passes."""
    y_re, y_im = _mf_cheb(ops, u_re, u_im, ops.coefs_re, -ops.coefs_im)
    return _mf_cheb(ops, y_re, y_im, ops.coefs_re, ops.coefs_im)


def kpm_mf_asym_plain(ops: KPMMFOperands, u_re, u_im):
    """K7's function in plain PyTorch ops: conj(c), then c."""
    _require_real(ops, "kpm_mf_asym (K7)")
    KPM_MF_ASYM.plain_calls += 1
    return _two_passes(ops, u_re, u_im)


def kpm_mf_cplx_plain(ops: KPMMFOperands, u_re, u_im):
    """K8's function in plain PyTorch ops: (u_re, u_im) is the channel pair of
    complex hoppings; one pass with real coefficients (symmetric) or
    conj(c), then c (asymmetric)."""
    if not ops.complex_pair:
        raise ValueError("kpm_mf_cplx (K8): complex hoppings only")
    KPM_MF_CPLX.plain_calls += 1
    if ops.symmetric:
        return _mf_cheb(ops, u_re, u_im, ops.coefs_re, None)
    return _two_passes(ops, u_re, u_im)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------


def max_sites(symmetric: bool, complex_pair: bool = False) -> int:
    """The largest N a kernel takes (the one-CTA form's register tiles and
    shared memory): K6 16384, K7 and K8 8192."""
    return int(_build.load_library().smoqy_kpm_mf_max_sites(int(symmetric), int(complex_pair)))


def _tag(ops: KPMMFOperands) -> str:
    return "K8" if ops.complex_pair else ("K6" if ops.symmetric else "K7")


def _launch_operands(ops: KPMMFOperands, u_re: torch.Tensor, u_im: torch.Tensor, tag: str):
    """Check u_re, u_im (..., F, N) float32 CUDA tensors against the operands;
    returns them as contiguous (B, F, N) planes, the outputs and the stream."""
    F, N = ops.coefs_re.shape[0], ops.n_sites
    if u_re.dtype != torch.float32 or u_im.dtype != torch.float32:
        raise TypeError(f"kpm_mf kernel: u is {u_re.dtype} / {u_im.dtype}, expected float32")
    if u_re.shape != u_im.shape or u_re.shape[-2:] != (F, N):
        raise ValueError(f"kpm_mf kernel: u planes {tuple(u_re.shape)} / {tuple(u_im.shape)}, "
                         f"expected (..., {F}, {N})")
    if not (u_re.device == u_im.device == ops.bbar.expV.device):
        raise ValueError("kpm_mf kernel: operands on different devices")
    limit = max_sites(ops.symmetric, ops.complex_pair)
    if N > limit:
        raise ValueError(f"kpm_mf kernel: N = {N} sites exceeds the kernel's {limit} "
                         f"({tag} shared-memory rows and register tiles)")
    ure = u_re.reshape(-1, F, N).contiguous()
    uim = u_im.reshape(-1, F, N).contiguous()
    return ure, uim, torch.empty_like(ure), torch.empty_like(uim), torch.cuda.current_stream(u_re.device).cuda_stream


def cluster_plan(ops: KPMMFOperands, n_vectors: int, order_threshold: Optional[int] = None,
                 cluster_size: Optional[int] = None) -> dict:
    """How K6 / K7 / K8 launch on these operands with `n_vectors` complex
    vectors: {"cluster_size", "order_threshold", "sites_per_thread" (of the
    cluster form: 1 or 2 by the slice's size, 0 where the shape does not fit
    it), "n_cluster" (the frequencies that take the cluster form), "stages"
    (per order step)}. The library decides the fit, by shape alone."""
    threshold = ORDER_THRESHOLD if order_threshold is None else int(order_threshold)
    k = cluster_size_for(ops.n_sites) if cluster_size is None else int(cluster_size)
    key = (n_vectors, threshold, k)
    if key not in ops.launch_plans:
        n_tables = ops.stage_A.shape[0]
        per = _build.load_library().smoqy_kpm_mf_cluster_fits(int(ops.symmetric), int(ops.complex_pair), n_vectors,
                                                              ops.n_sites, n_tables, ops.coefs_re.shape[1], k)
        head, _ = split_plan(ops.perm_host, ops.orders_host, threshold)
        ops.launch_plans[key] = dict(cluster_size=k, order_threshold=threshold, sites_per_thread=per,
                                     n_cluster=len(head) if per else 0,
                                     stages=2 * n_tables - 1 if ops.symmetric else n_tables)
    return ops.launch_plans[key]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(ops: KPMMFOperands, u_re: torch.Tensor, u_im: torch.Tensor, order_threshold, cluster_size):
    """One launch of the library's kpm_mf entry, K6, K7 or K8 by the
    operands; returns (y_re, y_im) shaped as u."""
    tag = _tag(ops)
    ure, uim, yre, yim, stream = _launch_operands(ops, u_re, u_im, tag)
    B, F, N = ure.shape
    plan = cluster_plan(ops, B, order_threshold, cluster_size)
    rc = _build.load_library().smoqy_kpm_mf(
        ure.data_ptr(), uim.data_ptr(), yre.data_ptr(), yim.data_ptr(), _ptr(ops.stage_A), _ptr(ops.stage_B),
        _ptr(ops.stage_B_im), _ptr(ops.stage_P), ops.coefs_re.data_ptr(),
        None if ops.symmetric else ops.coefs_im.data_ptr(), ops.orders.data_ptr(), ops.perm.data_ptr(), ops.cih,
        int(ops.symmetric), B, F, N, ops.stage_A.shape[0], ops.coefs_re.shape[1], plan["n_cluster"],
        plan["cluster_size"], stream)
    _build.check(rc, f"kpm_mf kernel launch ({tag})")
    return yre.reshape(u_re.shape), yim.reshape(u_im.shape)


def kpm_mf_cuda(ops: KPMMFOperands, u_re: torch.Tensor, u_im: torch.Tensor, order_threshold: Optional[int] = None,
                cluster_size: Optional[int] = None):
    """Launch K6 (symmetric) or K7 (asymmetric) on CUDA tensors u_re, u_im
    (..., F, N) float32; real hoppings only. `order_threshold` and
    `cluster_size` override the module's constants (tests and measurements)."""
    _require_real(ops, f"kpm_mf kernel ({_tag(ops)})")
    out = _launch(ops, u_re, u_im, order_threshold, cluster_size)
    (KPM_MF if ops.symmetric else KPM_MF_ASYM).launches += 1
    return out


def kpm_mf_cplx_cuda(ops: KPMMFOperands, u_re: torch.Tensor, u_im: torch.Tensor,
                     order_threshold: Optional[int] = None, cluster_size: Optional[int] = None):
    """Launch K8 on the channel pair (u_re, u_im), CUDA tensors (..., F, N)
    float32, of complex hoppings (both factorizations); the overrides as for
    `kpm_mf_cuda`."""
    if not ops.complex_pair:
        raise ValueError("kpm_mf_cplx kernel (K8): complex hoppings only")
    out = _launch(ops, u_re, u_im, order_threshold, cluster_size)
    KPM_MF_CPLX.launches += 1
    return out


def kpm_mf_apply(ops: KPMMFOperands, u_re: torch.Tensor, u_im: torch.Tensor):
    """K6 / K7 / K8 dispatcher: plain versions for CPU tensors, the kernels for
    CUDA tensors. Returns (y_re, y_im)."""
    if u_re.device.type == "cpu":
        if ops.complex_pair:
            return kpm_mf_cplx_plain(ops, u_re, u_im)
        return (kpm_mf_plain if ops.symmetric else kpm_mf_asym_plain)(ops, u_re, u_im)
    if u_re.device.type == "cuda":
        return (kpm_mf_cplx_cuda if ops.complex_pair else kpm_mf_cuda)(ops, u_re, u_im)
    raise RuntimeError(f"kpm_mf_apply: no kernel for device {u_re.device}")
