"""Fermion-matrix derivative forces, Holstein couplings: force[p, l] +=
nu * Re <u | dM/dx_{p,l} | v> (port of the Holstein parts of
the JAX package's ops/derivatives.py). The SSH color walk waits (ROADMAP
Queue 1, item 15).

u, v carry a leading complex-channel axis (2, Ltau, N); with real couplings
Re <u|A|v> is the channel sum of elementwise products. The force from the
product planes of kernels K3 / K4 (`holstein_force_from_planes`) takes a
leading walker axis."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters
from .checkerboard import CheckerboardStructure
from .fermion_det import FermionDetMatrix, boundary_sign


@dataclasses.dataclass(frozen=True)
class ForcePlan:
    """Finite-mass mask of the Holstein couplings (frozen phonons take no force)."""

    hol_finite: np.ndarray  # (n_holstein,) float64


def build_force_plan(elph: ElectronPhononParameters, structure: CheckerboardStructure) -> ForcePlan:
    if elph.n_ssh:
        raise NotImplementedError("SSH forces are not ported yet (ROADMAP Queue 1, item 15)")
    frozen = elph.frozen_mask
    hol_finite = (~frozen[elph.hol_to_phonon]).astype(np.float64) if elph.n_holstein else np.zeros(0)
    return ForcePlan(hol_finite=hol_finite)


def _add_holstein_V_force(
    force: torch.Tensor,
    nu: float,
    up: torch.Tensor,
    vp: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """Holstein potential-derivative contribution."""
    if elph.n_holstein == 0:
        return force
    sites, phonons = elph.hol_to_site_t, elph.hol_to_phonon_t
    xp = x[phonons, :]
    dV = elph.dtau * (
        elph.hol_alpha[:, None]
        + 2.0 * elph.hol_alpha2[:, None] * xp
        + 3.0 * elph.hol_alpha3[:, None] * xp**2
        + 4.0 * elph.hol_alpha4[:, None] * xp**3
    )
    prod = torch.sum(up[..., sites] * vp[..., sites], dim=0)
    finite = torch.as_tensor(plan.hol_finite, dtype=prod.dtype, device=prod.device)
    val = nu * dV * prod.T * finite[:, None]
    return force.index_add(0, phonons, val)


def add_M_derivative_force(
    force: torch.Tensor,
    nu: float,
    u: torch.Tensor,
    v: torch.Tensor,
    fdm: FermionDetMatrix,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """force += nu * Re <u | dM/dx | v> for Holstein couplings (both
    factorizations). u, v: (2, Ltau, N); force: (n_phonon, Ltau)."""
    if elph.n_ssh:
        raise NotImplementedError("SSH forces are not ported yet (ROADMAP Queue 1, item 15)")
    cb = fdm.cb
    vp = torch.roll(v, 1, dims=-2) * boundary_sign(fdm.Ltau, True, v.dtype, v.device)
    vp = fdm.apply_B(vp)
    up = u
    if fdm.symmetric:
        up = cb.apply(up, transpose=True)
        vp = cb.apply(vp, inverse=True)
    if elph.n_holstein > 0:
        force = _add_holstein_V_force(force, -nu, up, vp, elph, x, plan)
    return force


def holstein_force_from_planes(
    P1: torch.Tensor,
    P2: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    Lam: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """dS_f/dx (..., n_phonon, Ltau) from the planes P1, P2 (..., Ltau, N) of
    kernels K3 / K4 (the JAX package's ops/derivatives.py:215-256): P1 carries
    the M-derivative site products, P2 the Lambda-derivative ones; x is
    (..., n_phonon, Ltau) and Lam (..., Ltau, N) with the same leading axes."""
    force = torch.zeros(x.shape[:-2] + (elph.n_phonon, elph.Ltau), dtype=P1.dtype, device=P1.device)
    if elph.n_holstein == 0:
        return force
    sites, phonons = elph.hol_to_site_t, elph.hol_to_phonon_t
    xp = x[..., phonons, :]
    dV = elph.dtau * (
        elph.hol_alpha[:, None]
        + 2.0 * elph.hol_alpha2[:, None] * xp
        + 3.0 * elph.hol_alpha3[:, None] * xp**2
        + 4.0 * elph.hol_alpha4[:, None] * xp**3
    )
    finite = torch.as_tensor(plan.hol_finite, dtype=P1.dtype, device=P1.device)
    val = 2.0 * dV * P1[..., sites].transpose(-1, -2) * finite[:, None]
    force = force.index_add(-2, phonons, val)
    idx = np.where(elph.hol_ph_sym)[0]
    if idx.size:
        idx_t = torch.as_tensor(idx, dtype=torch.long, device=P1.device)
        s_sites, s_phonons = sites[idx_t], phonons[idx_t]
        xs = x[..., s_phonons, :]
        dcoup = 0.5 * elph.dtau * (elph.hol_alpha[idx_t][:, None] + 3.0 * elph.hol_alpha3[idx_t][:, None] * xs**2)
        val2 = -2.0 * (dcoup.transpose(-1, -2) * Lam[..., s_sites] * P2[..., s_sites])
        force = force.index_add(-2, s_phonons, val2.transpose(-1, -2))
    return force
