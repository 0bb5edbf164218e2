"""Stochastic Green's-function estimator and its FFT contraction engine.

Port of the JAX package's measure/greens_estimator.py. The estimator holds Nrv
unit-phase random vectors R and GR = M^{-1} R, (Nrv, 2, Ltau, N) with the
JAX package's (re, im) channel axis, from one batched solve of
[M^T M] x = M^T R over all (vector, channel) systems: with f32 measurement
solves that is one launch of kernel K2 on 2 Nrv systems.

The contractions work on complex tensors (complex64 for float32 estimators,
complex128 for float64): `orbital_fields` returns GR and conj(R) of one
orbital as complex (Nrv, Ltau, *L) fields, and every `measure_*` function
here returns a complex tensor where the JAX package returns an (re, im)
pair. Correlation outputs have shape (Ltau + 1, *L), displacement
tau = 0..beta.

The translational average S[r] = (1/Nvol) sum_i a[i + r] b[i] over (tau, *L)
is IDFT(DFT(a) . IDFT(b)) (`xcorr_accumulate`), on torch.fft
(ops/fourier.space_time_dft). `cache` dicts share transformed fields across
correlation kinds within one measurement pass, under the JAX package's keys.

The random phases theta (Nrv, Ltau, N) ~ U(0, 2 pi) come in as an argument of
`update_greens_estimator` (the JAX package draws them inside).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fermion_det import FermionDetMatrix, solve_MtM
from ..ops.fourier import space_time_dft

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}

# a hopping-weight field: (re, im-or-None) real tensors of shape (Ltau, *L)
Weight = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _cached(cache: Optional[dict], key, fn):
    """Transform cache of one measurement pass: repeated contraction terms
    across correlation kinds share one transformed field. key=None bypasses."""
    if cache is None or key is None:
        return fn()
    if key not in cache:
        cache[key] = fn()
    return cache[key]


@dataclasses.dataclass
class GreensEstimator:
    """R and GR = M^{-1} R, (Nrv, 2, Ltau, N) in the measurement dtype."""

    R: torch.Tensor
    GR: torch.Tensor
    Nrv: int
    Ltau: int
    n_orb: int
    L: Tuple[int, ...]
    dtype: str = "float64"

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.L))

    @property
    def n_sites(self) -> int:
        return self.n_cells * self.n_orb

    @property
    def D(self) -> int:
        return len(self.L)

    @property
    def complex_dtype(self) -> torch.dtype:
        return _COMPLEX[_DTYPES[self.dtype]]

    def shaped(self, arr: torch.Tensor) -> torch.Tensor:
        """(.., Ltau, N) -> (.., Ltau, *L, n_orb)."""
        return arr.reshape(arr.shape[:-1] + self.L + (self.n_orb,))

    def orbital_fields(self, orb: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(GR, conj(R)) of one orbital as complex (Nrv, Ltau, *L) fields."""
        GR = self.shaped(self.GR)[..., orb]
        R = self.shaped(self.R)[..., orb]
        return torch.complex(GR[:, 0], GR[:, 1]), torch.complex(R[:, 0], -R[:, 1])

    def xt(self, z: torch.Tensor, inverse: bool) -> torch.Tensor:
        """DFT over the trailing (tau, *L) axes; the inverse carries 1/n."""
        return space_time_dft(z, 1 + self.D, inverse)

    def xcorr_accumulate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """S[r] = (1/Nvol) sum_i a[i + r] b[i] over (tau, *L), summed over
        every leading batch axis."""
        p = self.xt(a, inverse=False) * self.xt(b, inverse=True)
        extra = p.dim() - (1 + self.D)
        if extra > 0:
            p = p.sum(dim=tuple(range(extra)))
        return self.xt(p, inverse=True)


class EstimatorUpdate(NamedTuple):
    estimator: GreensEstimator
    iters: torch.Tensor
    converged: torch.Tensor


def build_greens_estimator(Ltau: int, n_orb: int, L: Sequence[int], Nrv: int = 10, dtype: str = "float64",
                           device="cuda") -> GreensEstimator:
    """An estimator of zeros on `device` (the card unless the caller asks for
    the CPU); `update_greens_estimator` fills it."""
    L = tuple(int(v) for v in L)
    zeros = torch.zeros((Nrv, 2, Ltau, int(np.prod(L)) * n_orb), dtype=_DTYPES[dtype], device=device)
    return GreensEstimator(R=zeros, GR=zeros, Nrv=Nrv, Ltau=Ltau, n_orb=n_orb, L=L, dtype=dtype)


def draw_theta(gen: torch.Generator, est: GreensEstimator, device) -> torch.Tensor:
    """The phases of one refresh, (Nrv, Ltau, N) ~ U(0, 2 pi) in float64."""
    theta = torch.rand((est.Nrv, est.Ltau, est.n_sites), generator=gen, dtype=torch.float64)
    return (2.0 * math.pi * theta).to(device)


def update_greens_estimator(
    est: GreensEstimator,
    fdm: FermionDetMatrix,
    theta: torch.Tensor,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 10_000,
    mixed: bool = False,
    solve_dtype: Optional[str] = None,
) -> EstimatorUpdate:
    """R = e^{i theta} and GR = M^{-1} R from one batched solve
    (update_greens_estimator, greens_estimator.py:194-234).

    solve_dtype='float32' runs the 2 Nrv systems in f32 at tol >= 2e-5 (f32
    resolution), without defect correction: with the spectral
    preconditioner that is one launch of K2. Otherwise the rhs keeps theta's
    float64 and `mixed` selects the defect-correction solve (inner K2, f64
    residuals through K1)."""
    R = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)  # (Nrv, 2, Ltau, N)
    if solve_dtype is not None and _DTYPES[solve_dtype] == torch.float32:
        fdm = fdm.astype(torch.float32)
        R_s = R.to(torch.float32)
        tol = max(tol, 2e-5)
        mixed = False
    else:
        R_s = R
    GR, stats = solve_MtM(fdm, fdm.mul_Mt(R_s), precond=precond, tol=tol, maxiter=maxiter, mixed=mixed)
    dt = _DTYPES[est.dtype]
    est = dataclasses.replace(est, R=R.to(dt), GR=GR.to(dt))
    return EstimatorUpdate(estimator=est, iters=stats.iters, converged=stats.converged)


# ----------------------------------------------------------------------
# Single-particle Green's function
# ----------------------------------------------------------------------


def measure_G(est: GreensEstimator, orbitals: Tuple[int, int], cache: Optional[dict] = None) -> torch.Tensor:
    """G_ab(r, tau) for tau = 0..beta, complex (Ltau+1, *L) (measure_G,
    greens_estimator.py:237-270): the aperiodic sign extension along tau and
    the boundary G(r, beta) = delta_ab delta(r) - G(r, 0)."""
    a, b = orbitals

    def mkF():
        GA, _ = est.orbital_fields(a)
        return est.xt(torch.cat([GA, -GA], dim=1), inverse=False)

    def mkH():
        _, RB = est.orbital_fields(b)
        return est.xt(torch.cat([RB, -RB], dim=1), inverse=True)

    F = _cached(cache, ("G2", "G", a), mkF)
    H = _cached(cache, ("G2", "R", b), mkH)
    S = est.xt((F * H).sum(dim=0), inverse=True) / est.Nrv
    Gb = -S[0]
    if a == b:
        Gb[(0,) * est.D] += 1.0
    return torch.cat([S[: est.Ltau], Gb[None]], dim=0)


# ----------------------------------------------------------------------
# Pairwise four-fermion contractions
# ----------------------------------------------------------------------


def _pair_indices(Nrv: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    n, m = np.triu_indices(Nrv, k=1)
    return torch.as_tensor(n, device=device), torch.as_tensor(m, device=device)


def _roll_cells(est: GreensEstimator, arr: torch.Tensor, r: Sequence[int], sign: int) -> torch.Tensor:
    """Roll the trailing D cell axes by sign*r (arr trailing dims (*L,) or (tau, *L))."""
    r = tuple(int(v) for v in r)
    if all(v == 0 for v in r):
        return arr
    return torch.roll(arr, tuple(sign * v for v in r), tuple(range(arr.dim() - est.D, arr.dim())))


def _weight(est: GreensEstimator, t_field: Weight, conj_t: bool, shift=None, dtype=None) -> torch.Tensor:
    """A hopping-weight field as a complex (Ltau, *L) tensor, rolled by
    `shift` and conjugated on request."""
    tr, ti = t_field
    if shift is not None:
        tr = _roll_cells(est, tr, shift, +1)
        ti = None if ti is None else _roll_cells(est, ti, shift, +1)
    w = torch.complex(tr, torch.zeros_like(tr) if ti is None else ti)
    if conj_t:
        w = w.conj()
    return w if dtype is None else w.to(dtype)


def _apply_weight(est, p: torch.Tensor, t_field: Optional[Weight], conj_t: bool, shift=None) -> torch.Tensor:
    """Multiply a (.., Ltau, *L) field by a hopping-weight field, in the
    field's dtype."""
    if t_field is None:
        return p
    return p * _weight(est, t_field, conj_t, shift, dtype=p.dtype)


def _four_point(
    est: GreensEstimator,
    fields: Tuple,  # ((X1, X2), (Y1, Y2)): delta-side and zero-side factors
    tD: Optional[Weight],
    t0: Optional[Weight],
    conj_tD: bool,
    conj_t0: bool,
    cache: Optional[dict] = None,
    keyP=None,
    keyQ=None,
) -> torch.Tensor:
    """Sum over the pairs n < m of random vectors:
    xcorr(tD (.) X1_n (.) X2_m, t0 (.) Y1_n (.) Y2_m) / Npairs. The two
    per-pair-field transforms are cached under keyP / keyQ; weighted sides
    bypass the cache."""
    (X1, X2), (Y1, Y2) = fields
    pn, pm = _pair_indices(est.Nrv, X1.device)

    def mkP():
        return est.xt(_apply_weight(est, X1[pn] * X2[pm], tD, conj_tD), inverse=False)

    def mkQ():
        return est.xt(_apply_weight(est, Y1[pn] * Y2[pm], t0, conj_t0), inverse=True)

    F = _cached(cache, keyP if tD is None else None, mkP)
    H = _cached(cache, keyQ if t0 is None else None, mkQ)
    return est.xt((F * H).sum(dim=0), inverse=True) / pn.shape[0]


def _extend_beta(S: torch.Tensor) -> torch.Tensor:
    """(Ltau, *L) -> (Ltau+1, *L) with the beta row equal to the tau = 0 row
    (periodic product of two antiperiodic factors)."""
    return torch.cat([S, S[:1]], dim=0)


def _site_sum_correction(
    est: GreensEstimator,
    GX: torch.Tensor,
    RY: torch.Tensor,
    shift: Sequence[int],
    tD: Optional[Weight],
    t0: Optional[Weight],
    conj_tD: bool,
    conj_t0: bool,
    t_shift: Sequence[int],
) -> torch.Tensor:
    """(1/(Nrv Nvol)) sum_rv sum_i [t-weights] GX[i + shift] RY[i]: the
    building block of the tau = 0 / beta delta-corrections."""
    p = _roll_cells(est, GX, shift, +1) * RY  # (Nrv, Ltau, *L)
    if tD is not None:
        p = p * _weight(est, tD, conj_tD, shift=t_shift, dtype=p.dtype)
    if t0 is not None:
        p = p * _weight(est, t0, conj_t0, dtype=p.dtype)
    return p.sum() / (est.Nrv * est.Ltau * est.n_cells)


def _delta_cell(est: GreensEstimator, r: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(v) % l for v, l in zip(r, est.L))


def _four_fields(est: GreensEstimator, orbitals):
    """GR of orbitals a and c, conj(R) of orbitals b and d."""
    a, b, c, d = orbitals
    return est.orbital_fields(a)[0], est.orbital_fields(b)[1], est.orbital_fields(c)[0], est.orbital_fields(d)[1]


def measure_GD0_GD0(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Weight] = None,
    t0: Optional[Weight] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> torch.Tensor:
    """G(D,0).G(D,0) contraction with its two tau = beta boundary corrections
    and the double-delta term (measure_GD0_GD0, greens_estimator.py:401-472)."""
    a, b, c, d = orbitals
    GA, RB, GC, RD = _four_fields(est, orbitals)
    D = est.D

    def sh(arr, r):  # view at i + r
        return _roll_cells(est, arr, r, -1)

    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))
    C = _extend_beta(_four_point(
        est, ((sh(GA, r1), sh(GC, r3)), (sh(RB, r2), sh(RD, r4))), tD, t0, conj_tD, conj_t0, cache,
        keyP=("GD0P", "G", a, r1t, "G", c, r3t),
        keyQ=("GD0Q", "R", b, r2t, "R", d, r4t),
    ))

    # tau = beta corrections
    if a == b:
        shift = tuple(r1[k] - r2[k] - r3[k] + r4[k] for k in range(D))
        v = _site_sum_correction(est, GC, RD, shift, tD, t0, conj_tD, conj_t0,
                                 t_shift=tuple(r1[k] - r2[k] for k in range(D)))
        C[(est.Ltau,) + _delta_cell(est, tuple(r2[k] - r1[k] for k in range(D)))] -= v
    if c == d:
        shift = tuple(-r1[k] + r2[k] + r3[k] - r4[k] for k in range(D))
        v = _site_sum_correction(est, GA, RB, shift, tD, t0, conj_tD, conj_t0,
                                 t_shift=tuple(r3[k] - r4[k] for k in range(D)))
        C[(est.Ltau,) + _delta_cell(est, tuple(r4[k] - r3[k] for k in range(D)))] -= v
    if a == b and c == d and all((r2[k] - r1[k]) % est.L[k] == (r4[k] - r3[k]) % est.L[k] for k in range(D)):
        cell = (est.Ltau,) + _delta_cell(est, tuple(r2[k] - r1[k] for k in range(D)))
        if tD is None and t0 is None:
            C[cell] += 1.0
        else:
            # mean of the weight product over the lattice, in the weights' dtype
            w = 1.0
            if tD is not None:
                w = w * _weight(est, tD, conj_tD, shift=tuple(r1[k] - r2[k] for k in range(D)))
            if t0 is not None:
                w = w * _weight(est, t0, conj_t0)
            C[cell] += w.sum() / (est.Ltau * est.n_cells)
    return coef * C


def measure_GDD_G00(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Weight] = None,
    t0: Optional[Weight] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> torch.Tensor:
    """G(D,D).G(0,0) contraction (measure_GDD_G00, greens_estimator.py:475-524),
    no boundary corrections. The pair sum factorizes over all ordered pairs
    n != m: (sum_n F_n)(sum_m H_m) - sum_n F_n H_n, so 2 Nrv field transforms
    serve Nrv (Nrv - 1) pairs."""
    a, b, c, d = orbitals
    GA, RB, GC, RD = _four_fields(est, orbitals)

    def sh(arr, r):
        return _roll_cells(est, arr, r, -1)

    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))

    def mkF():
        return est.xt(_apply_weight(est, sh(GA, r1) * sh(RB, r2), tD, conj_tD), inverse=False)

    def mkH():
        return est.xt(_apply_weight(est, sh(GC, r3) * sh(RD, r4), t0, conj_t0), inverse=True)

    F = _cached(cache, ("GDDP", "G", a, r1t, "R", b, r2t) if tD is None else None, mkF)
    H = _cached(cache, ("GDDQ", "G", c, r3t, "R", d, r4t) if t0 is None else None, mkH)
    p = F.sum(dim=0) * H.sum(dim=0) - (F * H).sum(dim=0)
    S = est.xt(p, inverse=True) / (est.Nrv * (est.Nrv - 1))
    return coef * _extend_beta(S)


def measure_G0D_GD0(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Weight] = None,
    t0: Optional[Weight] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> torch.Tensor:
    """G(0,D).G(D,0) contraction with tau = 0 and tau = beta delta-corrections
    (measure_G0D_GD0, greens_estimator.py:527-577)."""
    a, b, c, d = orbitals
    GA, RB, GC, RD = _four_fields(est, orbitals)
    D = est.D

    def sh(arr, r):
        return _roll_cells(est, arr, r, -1)

    # delta side: (Rt_b_r2)_n (.) (GR_c_r3)_m ; zero side: (GR_a_r1)_n (.) (Rt_d_r4)_m
    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))
    C = _extend_beta(_four_point(
        est, ((sh(RB, r2), sh(GC, r3)), (sh(GA, r1), sh(RD, r4))), tD, t0, conj_tD, conj_t0, cache,
        keyP=("G0DP", "R", b, r2t, "G", c, r3t),
        keyQ=("G0DQ", "G", a, r1t, "R", d, r4t),
    ))

    shift = tuple(-r1[k] + r2[k] - r3[k] + r4[k] for k in range(D))
    if a == b:
        v = _site_sum_correction(est, GC, RD, shift, tD, t0, conj_tD, conj_t0,
                                 t_shift=tuple(-r1[k] + r2[k] for k in range(D)))
        C[(0,) + _delta_cell(est, tuple(r1[k] - r2[k] for k in range(D)))] -= v
    if c == d:
        v = _site_sum_correction(est, GA, RB, shift, tD, t0, conj_tD, conj_t0,
                                 t_shift=tuple(-r4[k] + r3[k] for k in range(D)))
        C[(est.Ltau,) + _delta_cell(est, tuple(r4[k] - r3[k] for k in range(D)))] -= v
    return coef * C
