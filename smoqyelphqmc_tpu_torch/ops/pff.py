"""Pseudofermion fields, action and forces (port of the JAX package's ops/pff.py).

S_f = Phi^dag [Lambda^dag M^dag M Lambda]^{-1} Phi with Phi a complex field
carried as a (2, Ltau, N) channel pair; one CG solve of
[M^T M] psi = Lambda^{-T} Phi serves both channels. The Gaussian noise R is an
argument: the caller draws it (updates/), so a test can feed the JAX
package's exact draws.

The f32 trajectory force has three routes, all the same function: 'plain'
(K2 solve, then mul_M / checkerboard / mul_Mt products), 'k4' (K2 solve, then
kernel K4 for the product planes, and with SSH couplings its hop plane) and
'k3' (kernel K3: solve and planes in one launch, with a leading walker axis
allowed; Holstein couplings only). The caller picks the route
(`updates.hmc.force_route`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters
from .cg import CGStats
from .derivatives import ForcePlan, add_M_derivative_force, holstein_force_from_planes, ssh_force_from_hops
from .fermion_det import FermionDetMatrix, solve_MtM
from .force import force_planes
from .lambda_shift import (
    add_lambda_derivative_force,
    build_lambda,
    ldiv_lambda,
    ldiv_lambda_T,
    mul_lambda,
    mul_lambda_T,
)
from .pcg_force import solve_force


class ActionResult(NamedTuple):
    Sf: torch.Tensor
    Sf_imag: torch.Tensor
    psi: torch.Tensor  # (2, Ltau, N) Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi
    psi_raw: torch.Tensor  # the CG solution before Lambda^{-1} (warm starts)
    stats: CGStats


class ForceResult(NamedTuple):
    Sf: torch.Tensor
    force: torch.Tensor  # (..., n_phonon, Ltau) dS_f/dx, float64
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
    Lam: Optional[torch.Tensor] = None,
) -> ActionResult:
    """S_f = Phi^dag Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi: one CG solve.
    `Lam`, Lambda at x when the caller has built it."""
    if Lam is None:
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
    route: str = "plain",
) -> ForceResult:
    """dS_f/dx = -2 Re([A psi]^T [dM/dx][Lambda psi]) - 2 Re([M^T A psi]^T [dLambda/dx] psi),
    A = M Lambda. solve_dtype='float32' runs the whole evaluation in f32 (the
    trajectory force path; Metropolis exactness rests on the f64 endpoint
    actions).

    route='k3' runs the solve and the force planes as kernel K3 (Phi, x and
    the fermion matrix may then carry a leading walker axis, and the stats
    are per walker) and route='k4' runs the K2 solve and then kernel K4 for
    the planes (the JAX package's ops/pff.py:157-227), and with SSH couplings
    K4's SSH form for the hop plane too; both give Sf as rhs . psi_raw. The
    planes are the Holstein force and the hop plane the SSH force: the caller
    takes those routes only for an f32, symmetric, real-hopping evaluation,
    K3 without SSH couplings and with the spectral preconditioner
    (`updates.hmc.force_route`). route='plain' runs the derivative chain, on
    channel pairs for complex hoppings. Lambda is built once an evaluation."""
    if solve_dtype != "float64":
        dt = {"float32": torch.float32}[solve_dtype]
        elph = elph.to_dtype(dt)
        fdm = fdm.astype(dt)
        Phi = Phi.to(dt)
        x = x.to(dt)
        if warm_start is not None:
            warm_start = warm_start.to(dt)
    mixed = mixed and Phi.dtype == torch.float64
    Lam = build_lambda(elph, x, fdm.n_sites)
    if route != "plain":
        want_p2 = bool(np.any(elph.hol_ph_sym))
        hops = elph.n_ssh > 0
        rhs = ldiv_lambda_T(Lam.unsqueeze(-3), Phi)
        if route == "k3":
            if hops:
                raise ValueError("route 'k3': kernel K3 has no SSH form")
            psi_raw, P1, P2, stats = solve_force(fdm, precond, rhs, Lam, x0=warm_start, tol=tol, maxiter=maxiter,
                                                 want_p2=want_p2)
        else:
            psi_raw, stats = solve_MtM(fdm, rhs, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed,
                                       x0=warm_start)
            P1, P2, *H = force_planes(fdm, Lam, psi_raw, want_p2, hops)
        # Sf = Re(Phi^dag psi) = rhs . psi_raw (Lambda is real diagonal)
        Sf = torch.sum(rhs * psi_raw, dim=(-3, -2, -1))
        force = holstein_force_from_planes(P1, P2, elph, x, Lam, plan)
        if hops:
            force = ssh_force_from_hops(force, H[0], elph, x, plan)
        return ForceResult(Sf=Sf, force=force.to(torch.float64), psi_raw=psi_raw, stats=stats)
    res = fermionic_action(Phi, elph, fdm, x, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed,
                           warm_start=warm_start, Lam=Lam)
    lam_psi = mul_lambda(Lam, res.psi)
    A_psi = fdm.mul_M(lam_psi)
    force = torch.zeros((elph.n_phonon, elph.Ltau), dtype=Phi.dtype, device=Phi.device)
    force = add_M_derivative_force(force, -2.0, A_psi, lam_psi, fdm, elph, x, plan)
    force = add_lambda_derivative_force(force, -2.0, fdm.mul_Mt(A_psi), res.psi, Lam, elph, x)
    return ForceResult(Sf=res.Sf, force=force.to(torch.float64), psi_raw=res.psi_raw, stats=res.stats)
