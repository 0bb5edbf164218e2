"""KPM (Chebyshev) preconditioner for the M^T M solves (port of
the JAX package's ops/kpm.py).

P^{-1} = [Mbar^T Mbar]^{-1}, where Mbar replaces every propagator by the
tau-averaged Bbar. In the antiperiodic frequency basis Mbar is block diagonal
and the per-frequency inverse is a scalar function of Bbar:

  symmetric:  f(b; phi) = 1 / (b^2 - 2 b cos(phi) + 1)         (real coefficients)
  asymmetric: g(b; phi) = 1 / (1 - e^{-i phi} b), applied twice (complex coefficients)

with phi_w = 2 pi (w + 1/2) / Ltau, expanded in Chebyshev polynomials of
Bbar' = (Bbar - center) / half on Lanczos bounds [lo, hi]. Each frequency
keeps its own live order floor(width (a1 / phi_eff + a2)), clipped to the
static caps; coefficients beyond it are zero. The preconditioner
self-deactivates (applies the identity) when the buffered bounds leave
(0, 1) u (1, 2) or, for the symmetric factorization, when the truncated fit
is not positive on the spectrum.

Two applies, as in the JAX package: the dense blocked recurrence
(`_block_cheb`, plain matmuls, N <= 1024 by default) and the matrix-free
checkerboard recurrence (`ops/kpm_mf.py`: kernel K6 for the symmetric
factorization, K7 for the asymmetric one, K8 for complex hoppings) above 1024
sites.

Complex hoppings (`complex_pair`): Bbar is complex (Hermitian for the
symmetric factorization) and acts on the (re, im) channel pair. Lanczos runs
on the real 2N-dimensional embedding [[B_re, -B_im], [B_im, B_re]] (its
spectrum is Bbar's, doubled), so the start vector has length 2N; the dense
apply runs the blocked recurrence in that doubled basis (`_block_cheb_pair`)
and the matrix-free one runs the channel-mixing checkerboard (K8). Complex
frequency coefficients act through the i-rotation (re, im) -> (-im, re).

Differences of form from the JAX package: the Lanczos start vector is an
argument (the caller draws it), the refresh's scalars (bounds, activation,
orders) and the coefficient fit are computed on the host in float64 (the
fit's matrices are (Ltau, C)), and there is one frequency bucket with the
identity permutation, which is all the JAX plan ever builds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .checkerboard import CheckerboardOp, build_checkerboard_op
from .fourier import TauFourier

# the JAX package's defaults, which its single call site keeps: the bounds'
# relative buffer, the Lanczos steps, the order law width (A1 / phi_eff + A2)
# (A1 doubles for the symmetric propagator), and the apply dtype
RBUF = 0.10
N_LANCZOS = 20
A1 = 1.0
A2 = 1.0
APPLY_DTYPE = torch.float32


# ----------------------------------------------------------------------
# Bbar: tau-averaged single-slice propagator
# ----------------------------------------------------------------------


@dataclasses.dataclass
class AveragedPropagator:
    """Bbar from tau-averaged checkerboard and diagonal factors."""

    cb: CheckerboardOp  # single-slice factors (n_colors, N)
    expV: torch.Tensor  # (N,)
    symmetric: bool

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.symmetric:
            u = self.cb.apply(u, transpose=True)
            u = self.expV * u
            return self.cb.apply(u)
        u = self.cb.apply(u)
        return self.expV * u

    def apply_T(self, u: torch.Tensor) -> torch.Tensor:
        if self.symmetric:
            return self.apply(u)
        u = self.expV * u
        return self.cb.apply(u, transpose=True)

    def to_dtype(self, dtype: torch.dtype) -> "AveragedPropagator":
        return AveragedPropagator(cb=self.cb.to_dtype(dtype), expV=self.expV.to(dtype), symmetric=self.symmetric)


def averaged_propagator(fdm) -> AveragedPropagator:
    expV_bar, cosh_bar, sinh_bar, sinh_bar_im = fdm.averaged_factors()
    cb = build_checkerboard_op(fdm.structure, cosh_bar, sinh_bar, sinh_bar_im)
    return AveragedPropagator(cb=cb, expV=expV_bar, symmetric=fdm.symmetric)


# ----------------------------------------------------------------------
# Lanczos eigenvalue bounds
# ----------------------------------------------------------------------


def lanczos_bounds(apply_A, v0: torch.Tensor, n_steps: int = 20) -> Tuple[float, float]:
    """(eig_min, eig_max) of a symmetric operator from n_steps Lanczos steps
    started at v0 and a dense tridiagonal eigensolve. The steps stay on v0's
    device; the (n_steps, n_steps) eigensolve runs on the host in float64."""
    v = v0 / torch.linalg.vector_norm(v0)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v.dtype, device=v.device)
    one = torch.ones((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(n_steps):
        w = apply_A(v) - beta_prev * v_prev
        alpha = torch.dot(w, v)
        w = w - alpha * v
        beta = torch.linalg.vector_norm(w)
        v_prev, v = v, w / torch.where(beta > 1e-300, beta, one)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas).to("cpu", torch.float64)
    b = torch.stack(betas).to("cpu", torch.float64)[:-1]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    evals = torch.linalg.eigvalsh(T)
    return float(evals[0]), float(evals[-1])


# ----------------------------------------------------------------------
# Static plan and Chebyshev fit matrices (host NumPy, as in the JAX package)
# ----------------------------------------------------------------------

# above this many sites `build` picks the matrix-free apply
MATRIX_FREE_MIN_SITES = 1024


def _static_plan(Ltau: int, a1_eff: float, a2: float, cap_delta_eps: float, cap_max=None):
    """Per-frequency static order caps and the blocked recurrence's grid:
    (phi, caps, block_size, n_blocks); the coefficient planes are
    (Ltau, block_size * n_blocks)."""
    w = np.arange(Ltau)
    phi = 2.0 * np.pi * (w + 0.5) / Ltau
    phi_eff = np.minimum(phi, 2.0 * np.pi - phi)
    caps = np.maximum(1, np.floor(cap_delta_eps * (a1_eff / phi_eff + a2)).astype(np.int64))
    if cap_max is not None:
        caps = np.minimum(caps, cap_max)
    C = int(max(caps.max(), 1))
    block_size = max(1, int(np.ceil(np.sqrt(C))))
    n_blocks = int(np.ceil(C / block_size))
    return phi, caps, block_size, n_blocks


def _cheb_nodes_and_cosmat(C: int):
    """Chebyshev nodes x_j and the coefficient cosine matrix for a C-term fit:
    coefs[k] = sum_j cosmat[k, j] f(x_j)."""
    j = np.arange(C)
    theta = np.pi * (j + 0.5) / C
    nodes = np.cos(theta)
    k = np.arange(C)[:, None]
    cosmat = np.cos(k * theta[None, :]) * (2.0 / C)
    cosmat[0, :] *= 0.5
    return nodes, cosmat


_FIT_GRID = 257  # evaluation grid of the truncation-positivity guard


def _fit_eval_mat(C: int, G: int = _FIT_GRID) -> np.ndarray:
    """(C, G) matrix evaluating a C-term Chebyshev series on G angles; finer
    than any fit order, since a too-short fit turns non-positive between its
    nodes."""
    theta = np.pi * (np.arange(G) + 0.5) / G
    return np.cos(np.arange(C)[:, None] * theta[None, :])


def live_orders(lo: float, hi: float, phi: np.ndarray, a1: float, a2: float, caps: np.ndarray):
    """Per-frequency orders of bounds [lo, hi], clipped to the caps, and the
    number of frequencies the caps clipped."""
    phi_eff = np.minimum(phi, 2 * np.pi - phi)
    raw = np.maximum(1, np.floor((hi - lo) * (a1 / phi_eff + a2)).astype(np.int32))
    caps32 = caps.astype(np.int32)
    return np.minimum(raw, caps32), int(np.sum(raw > caps32))


# ----------------------------------------------------------------------
# Preconditioner state
# ----------------------------------------------------------------------


@dataclasses.dataclass
class KPMPreconditioner:
    """Refresh state and static plan of the KPM preconditioner.

    lo / hi are the buffered bounds (0.5 / 1.5 when inactive), `orders` the
    live per-frequency orders, coefs_re / coefs_im the (Ltau, C_pad)
    coefficient planes in APPLY_DTYPE (coefs_im all zero for the symmetric
    factorization), BpT / TsT the dense scaled propagator and stride matrix
    (None when matrix-free; 2N x 2N in the doubled basis when complex_pair)."""

    bbar: AveragedPropagator
    lo: float
    hi: float
    active: bool
    coefs_re: torch.Tensor
    coefs_im: torch.Tensor
    orders: np.ndarray
    order_clip_count: int
    fft: TauFourier
    BpT: Optional[torch.Tensor]
    TsT: Optional[torch.Tensor]
    symmetric: bool
    Ltau: int
    n_sites: int
    phi: np.ndarray
    caps: np.ndarray
    block_size: int
    n_blocks: int
    matrix_free: bool = False
    _mf_operands: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def complex_pair(self) -> bool:
        """Complex hoppings: the doubled basis, channel pairs through the apply."""
        return self.bbar.cb.S_im is not None

    @property
    def center(self) -> float:
        return 0.5 * (self.hi + self.lo)

    @property
    def half(self) -> float:
        return 0.5 * (self.hi - self.lo)

    @property
    def a1(self) -> float:
        """The order law's A1 for this factorization."""
        return 2.0 * A1 if self.symmetric else A1

    @staticmethod
    def build(fdm, v0: torch.Tensor, cap_delta_eps: float = 1.0, cap_max=None,
              matrix_free: Optional[bool] = None) -> "KPMPreconditioner":
        """Construct and refresh from the fermion matrix, with the Lanczos
        start vector v0 (N,), or (2N,) for complex hoppings. matrix_free=None
        picks the checkerboard recurrence above MATRIX_FREE_MIN_SITES."""
        Ltau, N = fdm.Ltau, fdm.n_sites
        if matrix_free is None:
            matrix_free = N > MATRIX_FREE_MIN_SITES
        a1_eff = 2.0 * A1 if fdm.symmetric else A1
        phi, caps, block_size, n_blocks = _static_plan(Ltau, a1_eff, A2, cap_delta_eps, cap_max)
        C_pad = block_size * n_blocks
        zeros = torch.zeros((Ltau, C_pad), dtype=APPLY_DTYPE, device=fdm.device)
        pre = KPMPreconditioner(
            bbar=averaged_propagator(fdm), lo=0.0, hi=0.0, active=False, coefs_re=zeros, coefs_im=zeros,
            orders=np.ones(Ltau, np.int32), order_clip_count=0,
            fft=TauFourier(Ltau, dtype=APPLY_DTYPE, device=fdm.device), BpT=None, TsT=None,
            symmetric=fdm.symmetric, Ltau=Ltau, n_sites=N, phi=phi, caps=caps, block_size=block_size,
            n_blocks=n_blocks, matrix_free=bool(matrix_free),
        )
        return kpm_update(pre, fdm, v0)

    def as_operator(self):
        """z = P^{-1} r, for cg_solve."""
        return lambda r: kpm_apply(self, r)

    def mf_operands(self):
        """The matrix-free apply's f32 operands for this refresh (cached)."""
        if self._mf_operands is None:
            from .kpm_mf import build_operands

            self._mf_operands = build_operands(self)
        return self._mf_operands


# ----------------------------------------------------------------------
# Refresh: Bbar, bounds, activation, coefficients
# ----------------------------------------------------------------------


def _coefficients(pre: KPMPreconditioner, lo: float, hi: float, orders: np.ndarray):
    """Masked (Ltau, C_pad) float64 coefficient planes of the per-frequency
    fit on [lo, hi]."""
    C = pre.block_size * pre.n_blocks
    nodes, cosmat = _cheb_nodes_and_cosmat(C)
    center, half = (hi + lo) / 2.0, (hi - lo) / 2.0
    m = center + half * nodes
    phi = pre.phi[:, None]
    if pre.symmetric:
        f = 1.0 / (m[None, :] ** 2 - 2.0 * m[None, :] * np.cos(phi) + 1.0)
        cre = f @ cosmat.T
        cim = np.zeros_like(cre)
    else:
        mc = m[None, :] * np.cos(phi)
        ms = m[None, :] * np.sin(phi)
        denom = (1.0 - mc) ** 2 + ms**2
        cre = ((1.0 - mc) / denom) @ cosmat.T
        cim = (-ms / denom) @ cosmat.T
    mask = np.arange(C)[None, :] < orders[:, None]
    return np.where(mask, cre, 0.0), np.where(mask, cim, 0.0)


def kpm_update(pre: KPMPreconditioner, fdm, v0: torch.Tensor) -> KPMPreconditioner:
    """A refreshed copy of the preconditioner for the current fermion matrix;
    v0 (N,), or (2N,) for complex hoppings, starts the Lanczos iteration."""
    bbar = averaged_propagator(fdm)
    N = pre.n_sites
    dim = 2 * N if pre.complex_pair else N
    if tuple(v0.shape) != (dim,):
        raise ValueError(f"the Lanczos start vector has shape {tuple(v0.shape)}, expected ({dim},)")
    v0 = v0.to(fdm.device, bbar.expV.dtype)
    BbarT = None
    if pre.matrix_free and pre.complex_pair:
        # the doubled vector's halves are the channel pair the checkerboard mixes
        apply_B = lambda w: bbar.apply(w.reshape(2, 1, N)).reshape(-1)  # noqa: E731
        apply_Bt = lambda w: bbar.apply_T(w.reshape(2, 1, N)).reshape(-1)  # noqa: E731
    elif pre.matrix_free:
        apply_B, apply_Bt = bbar.apply, bbar.apply_T
    else:
        # row k of BbarT is Bbar e_k: v @ BbarT applies Bbar to row vectors
        eye = torch.eye(N, dtype=bbar.expV.dtype, device=fdm.device)
        if pre.complex_pair:
            # the doubled embedding from channel-paired unit vectors (2N, 2, 1, N)
            zero = torch.zeros_like(eye)
            basis = torch.cat([torch.stack([eye, zero], dim=1), torch.stack([zero, eye], dim=1)])[:, :, None, :]
            out = bbar.apply(basis)
            BbarT = torch.cat([out[:, 0, 0, :], out[:, 1, 0, :]], dim=-1)
        else:
            BbarT = bbar.apply(eye)
        apply_B = lambda v: v @ BbarT  # noqa: E731
        apply_Bt = lambda v: v @ BbarT.T  # noqa: E731
    if pre.symmetric:
        lo_raw, hi_raw = lanczos_bounds(apply_B, v0, N_LANCZOS)
    else:
        lo2, hi2 = lanczos_bounds(lambda v: apply_Bt(apply_B(v)), v0, N_LANCZOS)
        lo_raw, hi_raw = float(np.sqrt(max(lo2, 0.0))), float(np.sqrt(max(hi2, 0.0)))
    lo = (1.0 - RBUF) * lo_raw
    hi = (1.0 + RBUF) * hi_raw
    active = 0.0 < lo < 1.0 and 1.0 < hi < 2.0
    if not active:  # safe bounds keep the coefficient arithmetic finite
        lo, hi = 0.5, 1.5
    orders, clip_count = live_orders(lo, hi, pre.phi, pre.a1, A2, pre.caps)
    cre, cim = _coefficients(pre, lo, hi, orders)
    cre, cim = cre.astype(np.float32), cim.astype(np.float32)
    if pre.symmetric:
        # truncation-positivity guard: the symmetric factorization's masked fit
        # must be positive on the whole interval, or P^{-1} is indefinite. The
        # asymmetric two passes give |p|^2 >= 0 and are exempt.
        active = active and float(np.min(cre @ _fit_eval_mat(cre.shape[1]).astype(np.float32))) > 0.0
    dt = APPLY_DTYPE
    BpT = TsT = None
    if not pre.matrix_free:
        half_safe = max((hi - lo) / 2.0, 1e-12)
        eye = torch.eye(dim, dtype=BbarT.dtype, device=BbarT.device)
        BpT = ((BbarT - (hi + lo) / 2.0 * eye) / half_safe).to(dt)
        # TsT = T_s(Bbar')^T by the dense Chebyshev matrix recurrence
        TsT = BpT
        if pre.block_size > 1:
            m_prev, m_cur = torch.eye(dim, dtype=dt, device=BpT.device), BpT
            for _ in range(pre.block_size - 1):
                m_prev, m_cur = m_cur, 2.0 * (BpT @ m_cur) - m_prev
            TsT = m_cur
    dev = fdm.device
    return dataclasses.replace(
        pre, bbar=bbar, lo=lo, hi=hi, active=bool(active),
        coefs_re=torch.as_tensor(cre, device=dev), coefs_im=torch.as_tensor(cim, device=dev),
        orders=orders, order_clip_count=clip_count, BpT=BpT, TsT=TsT, _mf_operands=None,
    )


# ----------------------------------------------------------------------
# Apply: z = P^{-1} r
# ----------------------------------------------------------------------


def _block_cheb(pre: KPMPreconditioner, u_re, u_im, cre, cim):
    """y = sum_k c_k T_k(B') u for complex coefficient planes (F, C_pad) and a
    complex pair u (..., F, N), s orders per dense step:
    Block_{b+1} = 2 Block_b @ TsT - Block_{b-1} (T_{m+s} = 2 T_s T_m - T_{m-s})."""
    s, nb = pre.block_size, pre.n_blocks
    BpT, TsT = pre.BpT, pre.TsT
    F = cre.shape[0]
    cre_b = cre.T.reshape(nb, s, F)
    cim_b = cim.T.reshape(nb, s, F)

    def acc(y_re, y_im, B_re, B_im, cb_re, cb_im):
        y_re = y_re + torch.einsum("jf,j...fn->...fn", cb_re, B_re) - torch.einsum("jf,j...fn->...fn", cb_im, B_im)
        y_im = y_im + torch.einsum("jf,j...fn->...fn", cb_re, B_im) + torch.einsum("jf,j...fn->...fn", cb_im, B_re)
        return y_re, y_im

    ts_re, ts_im = [u_re], [u_im]
    if s > 1:
        ts_re.append(u_re @ BpT)
        ts_im.append(u_im @ BpT)
        for _ in range(s - 2):
            ts_re.append(2.0 * (ts_re[-1] @ BpT) - ts_re[-2])
            ts_im.append(2.0 * (ts_im[-1] @ BpT) - ts_im[-2])
    B0_re, B0_im = torch.stack(ts_re), torch.stack(ts_im)
    y_re, y_im = acc(torch.zeros_like(u_re), torch.zeros_like(u_im), B0_re, B0_im, cre_b[0], cim_b[0])
    if nb == 1:
        return y_re, y_im
    # block -1 is [T_{s-j} u]_{j<s}: T_s u, then block 0 reversed from index s-1 to 1
    Bp_re = torch.cat([(u_re @ TsT)[None], B0_re[1:].flip(0)])
    Bp_im = torch.cat([(u_im @ TsT)[None], B0_im[1:].flip(0)])
    Bc_re, Bc_im = B0_re, B0_im
    for b in range(1, nb):
        Bn_re = 2.0 * (Bc_re @ TsT) - Bp_re
        Bn_im = 2.0 * (Bc_im @ TsT) - Bp_im
        y_re, y_im = acc(y_re, y_im, Bn_re, Bn_im, cre_b[b], cim_b[b])
        Bp_re, Bp_im, Bc_re, Bc_im = Bc_re, Bc_im, Bn_re, Bn_im
    return y_re, y_im


def _rot_i(pre: KPMPreconditioner, w: torch.Tensor) -> torch.Tensor:
    """i times w in the doubled (re, im)-site basis: [a, b] -> [-b, a]."""
    N = pre.n_sites
    return torch.cat([-w[..., N:], w[..., :N]], dim=-1)


def _block_cheb_pair(pre: KPMPreconditioner, w, cre, cim):
    """y = sum_k c_k T_k(E') w in the doubled real site basis (complex
    hoppings): w (..., F, 2N) holds the (re, im) halves of the complex
    frequency-space vector, E' the scaled 2N x 2N embedding, and the complex
    coefficient acts as cre + cim rot_i (cim unused for the symmetric
    factorization, whose coefficients are real). The recurrence of
    `_block_cheb` on one doubled channel."""
    s, nb = pre.block_size, pre.n_blocks
    BpT, TsT = pre.BpT, pre.TsT
    F = cre.shape[0]
    cre_b = cre.T.reshape(nb, s, F)
    cim_b = cim.T.reshape(nb, s, F)

    def acc(y, B, cb_re, cb_im):
        y = y + torch.einsum("jf,j...fn->...fn", cb_re, B)
        if not pre.symmetric:
            y = y + _rot_i(pre, torch.einsum("jf,j...fn->...fn", cb_im, B))
        return y

    ts = [w]
    if s > 1:
        ts.append(w @ BpT)
        for _ in range(s - 2):
            ts.append(2.0 * (ts[-1] @ BpT) - ts[-2])
    B0 = torch.stack(ts)
    y = acc(torch.zeros_like(w), B0, cre_b[0], cim_b[0])
    if nb == 1:
        return y
    Bp = torch.cat([(w @ TsT)[None], B0[1:].flip(0)])
    Bc = B0
    for b in range(1, nb):
        Bn = 2.0 * (Bc @ TsT) - Bp
        y = acc(y, Bn, cre_b[b], cim_b[b])
        Bp, Bc = Bc, Bn
    return y


def _apply_pair(pre: KPMPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """Complex hoppings: the channel pair r (..., 2, Ltau, N) through the
    complex tau-FFT, the recurrence on the pair (K8, or the doubled-basis
    dense recurrence) and the inverse FFT back to (..., 2, Ltau, N)."""
    ure, uim = pre.fft.forward(r[..., 0, :, :], r[..., 1, :, :])
    cre, cim = pre.coefs_re, pre.coefs_im
    if pre.matrix_free:
        from .kpm_mf import kpm_mf_apply

        yre, yim = kpm_mf_apply(pre.mf_operands(), ure, uim)
    else:
        N = pre.n_sites
        w = torch.cat([ure, uim], dim=-1)
        if pre.symmetric:
            w = _block_cheb_pair(pre, w, cre, cim)
        else:
            # two passes: conj(coefs), then coefs
            w = _block_cheb_pair(pre, _block_cheb_pair(pre, w, cre, -cim), cre, cim)
        yre, yim = w[..., :N], w[..., N:]
    zre, zim = pre.fft.inverse(yre, yim)
    return torch.stack([zre, zim], dim=-3)


def kpm_apply(pre: KPMPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """z = P^{-1} r for real r (..., Ltau, N), or the channel pair
    (..., 2, Ltau, N) of complex hoppings: tau-FFT, Chebyshev expansion,
    inverse FFT (the real part for real hoppings); in APPLY_DTYPE, returned
    in r's dtype. The identity when the preconditioner is inactive."""
    if not pre.active:
        return r
    in_dtype = r.dtype
    r = r.to(APPLY_DTYPE)
    if pre.complex_pair:
        return _apply_pair(pre, r).to(in_dtype)
    ure, uim = pre.fft.forward(r)
    if pre.matrix_free:
        from .kpm_mf import kpm_mf_apply

        yre, yim = kpm_mf_apply(pre.mf_operands(), ure, uim)
    else:
        cre, cim = pre.coefs_re, pre.coefs_im
        if pre.symmetric:
            yre, yim = _block_cheb(pre, ure, uim, cre, cim)
        else:
            # two passes: conj(coefs), then coefs
            yre, yim = _block_cheb(pre, ure, uim, cre, -cim)
            yre, yim = _block_cheb(pre, yre, yim, cre, cim)
    zre, _ = pre.fft.inverse(yre, yim)
    return zre.to(in_dtype)
