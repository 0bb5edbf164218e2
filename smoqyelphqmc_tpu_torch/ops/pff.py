"""Pseudofermion fields, action and forces (port of smoqyelphqmc_tpu/ops/pff.py).

S_f = Phi^dag [Lambda^dag M^dag M Lambda]^{-1} Phi with Phi a complex field
carried as a (2, Ltau, N) channel pair; one CG solve of
[M^T M] psi = Lambda^{-T} Phi serves both channels. The Gaussian noise R is an
argument: the caller draws it (updates/), so a test can feed the JAX
package's exact draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.electron_phonon import ElectronPhononParameters
from .cg import CGStats
from .derivatives import ForcePlan, add_M_derivative_force
from .fermion_det import FermionDetMatrix, solve_MtM
from .lambda_shift import (
    add_lambda_derivative_force,
    build_lambda,
    ldiv_lambda,
    ldiv_lambda_T,
    mul_lambda,
    mul_lambda_T,
)


class ActionResult(NamedTuple):
    Sf: torch.Tensor
    Sf_imag: torch.Tensor
    psi: torch.Tensor  # (2, Ltau, N) Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi
    psi_raw: torch.Tensor  # the CG solution before Lambda^{-1} (warm starts)
    stats: CGStats


class ForceResult(NamedTuple):
    Sf: torch.Tensor
    force: torch.Tensor  # (n_phonon, Ltau) dS_f/dx, float64
    psi_raw: torch.Tensor
    stats: CGStats


def sample_pseudofermion_fields(
    R: torch.Tensor, elph: ElectronPhononParameters, fdm: FermionDetMatrix, x: torch.Tensor
):
    """Phi = Lambda^T M^T R for R ~ CN(0, 1) given as a (2, Ltau, N) pair of
    N(0, 1/2) fields; returns (Phi, Sf = |R|^2)."""
    Lam = build_lambda(elph, x, fdm.n_sites)
    Sf = torch.sum(R * R)
    return mul_lambda_T(Lam, fdm.mul_Mt(R)), Sf


def fermionic_action(
    Phi: torch.Tensor,
    elph: ElectronPhononParameters,
    fdm: FermionDetMatrix,
    x: torch.Tensor,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    mixed: bool = False,
    warm_start: Optional[torch.Tensor] = None,
) -> ActionResult:
    """S_f = Phi^dag Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi: one CG solve."""
    Lam = build_lambda(elph, x, fdm.n_sites)
    rhs = ldiv_lambda_T(Lam, Phi)
    psi_raw, stats = solve_MtM(fdm, rhs, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed, x0=warm_start)
    psi = ldiv_lambda(Lam, psi_raw)
    Sf = torch.sum(Phi * psi)
    Sf_im = torch.sum(Phi[0] * psi[1] - Phi[1] * psi[0])
    return ActionResult(Sf=Sf, Sf_imag=Sf_im, psi=psi, psi_raw=psi_raw, stats=stats)


def fermionic_action_and_force(
    Phi: torch.Tensor,
    elph: ElectronPhononParameters,
    fdm: FermionDetMatrix,
    x: torch.Tensor,
    plan: ForcePlan,
    precond=None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    mixed: bool = False,
    solve_dtype: str = "float64",
    warm_start: Optional[torch.Tensor] = None,
) -> ForceResult:
    """dS_f/dx = -2 Re([A psi]^T [dM/dx][Lambda psi]) - 2 Re([M^T A psi]^T [dLambda/dx] psi),
    A = M Lambda. solve_dtype='float32' runs the whole evaluation in f32 (the
    trajectory force path; Metropolis exactness rests on the f64 endpoint
    actions)."""
    if solve_dtype != "float64":
        dt = {"float32": torch.float32}[solve_dtype]
        elph = elph.to_dtype(dt)
        fdm = fdm.astype(dt)
        Phi = Phi.to(dt)
        x = x.to(dt)
        if warm_start is not None:
            warm_start = warm_start.to(dt)
    mixed = mixed and Phi.dtype == torch.float64
    res = fermionic_action(Phi, elph, fdm, x, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed,
                           warm_start=warm_start)
    Lam = build_lambda(elph, x, fdm.n_sites)
    lam_psi = mul_lambda(Lam, res.psi)
    A_psi = fdm.mul_M(lam_psi)
    force = torch.zeros((elph.n_phonon, elph.Ltau), dtype=Phi.dtype, device=Phi.device)
    force = add_M_derivative_force(force, -2.0, A_psi, lam_psi, fdm, elph, x, plan)
    force = add_lambda_derivative_force(force, -2.0, fdm.mul_Mt(A_psi), res.psi, Lam, elph, x)
    return ForceResult(Sf=res.Sf, force=force.to(torch.float64), psi_raw=res.psi_raw, stats=res.stats)
