"""Bosonic (phonon) action and its derivatives (port of the JAX package's
ops/bosonic.py):

  S_b = sum_p sum_l [ M_p / (2 dtau) (x_{p,l+1} - x_{p,l})^2
                      + dtau ( (1/2) M_p Omega_p^2 x_{p,l}^2 + Omega4_p x_{p,l}^4 ) ]
      + dtau sum_d sum_l [ (1/2) Mr_d Omegad_d^2 (x_{f,l} - x_{i,l})^2
                           + Omegad4_d (x_{f,l} - x_{i,l})^4 ]

with Mr the reduced mass of a dispersion pair. Frozen (infinite-mass) modes
are masked out of the on-site terms; a dispersion pair with one frozen
member uses the live member's mass. Fields x may carry leading walker axes
(..., n_phonon, Ltau); the action is then one value a walker."""

from __future__ import annotations

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters


def _live_mass(elph: ElectronPhononParameters) -> torch.Tensor:
    live = torch.as_tensor(~elph.frozen_mask, device=elph.mass.device)
    return torch.where(live, elph.mass, torch.zeros_like(elph.mass))


def _reduced_mass(elph: ElectronPhononParameters) -> torch.Tensor:
    """(n_dispersion,) reduced mass of each coupled pair; an infinite-mass
    member drops out (Mr -> the live mass; both frozen -> 0)."""
    m_i = elph.mass[elph.disp_to_phonon_t[0]]
    m_f = elph.mass[elph.disp_to_phonon_t[1]]
    fi, ff = torch.isfinite(m_i), torch.isfinite(m_f)
    both = fi & ff
    zero = torch.zeros_like(m_i)
    mr = torch.where(both, m_i * m_f / torch.where(both, m_i + m_f, torch.ones_like(m_i)), zero)
    mr = torch.where(fi & ~ff, m_i, mr)
    return torch.where(~fi & ff, m_f, mr)


def _dispersion_dx(elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """(..., n_dispersion, Ltau) x_f - x_i of every dispersion pair."""
    return x[..., elph.disp_to_phonon_t[1], :] - x[..., elph.disp_to_phonon_t[0], :]


def bosonic_action(elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """S_b(x) for x (..., n_phonon, Ltau): a 0-dim tensor, or one a walker."""
    dtau = elph.dtau
    m = _live_mass(elph)
    dx_tau = torch.roll(x, -1, dims=-1) - x
    kinetic = torch.sum(m[:, None] / (2.0 * dtau) * dx_tau**2, dim=(-2, -1))
    quartic = torch.where(m > 0, elph.Omega4, torch.zeros_like(elph.Omega4))
    potential = torch.sum(dtau * (0.5 * m[:, None] * elph.Omega[:, None] ** 2 * x**2 + quartic[:, None] * x**4),
                          dim=(-2, -1))
    S = kinetic + potential
    if elph.n_dispersion > 0:
        mr = _reduced_mass(elph)
        dxp = _dispersion_dx(elph, x)
        S = S + torch.sum(dtau * (0.5 * mr[:, None] * elph.disp_Omega[:, None] ** 2 * dxp**2
                                  + elph.disp_Omega4[:, None] * dxp**4), dim=(-2, -1))
    return S


def add_anharmonic_force(force: torch.Tensor, elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """force += d/dx of the quartic on-site term (frozen modes masked)."""
    m = _live_mass(elph)
    quartic = torch.where(m > 0, elph.Omega4, torch.zeros_like(elph.Omega4))
    return force + elph.dtau * 4.0 * quartic[:, None] * x**3


def add_dispersive_force(force: torch.Tensor, elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """force += d/dx of the dispersive pair coupling (frozen modes masked)."""
    if elph.n_dispersion == 0:
        return force
    mr = _reduced_mass(elph)
    dxp = _dispersion_dx(elph, x)
    g = elph.dtau * (mr[:, None] * elph.disp_Omega[:, None] ** 2 * dxp
                     + 4.0 * elph.disp_Omega4[:, None] * dxp**3)
    live = torch.as_tensor(~elph.frozen_mask, device=g.device)
    p_i, p_f = elph.disp_to_phonon_t[0], elph.disp_to_phonon_t[1]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    force = force.index_add(-2, p_f, torch.where(live[p_f][:, None], g, zero).to(force.dtype))
    return force.index_add(-2, p_i, torch.where(live[p_i][:, None], -g, zero).to(force.dtype))


def harmonic_curvature(elph: ElectronPhononParameters) -> torch.Tensor:
    """(n_phonon, Ltau) Q_{p,k} = M_p ((4/dtau) sin^2(pi k / Ltau) + dtau Omega_p^2)."""
    k = np.arange(elph.Ltau)
    sin2 = torch.as_tensor(np.sin(np.pi * k / elph.Ltau) ** 2, dtype=torch.float64, device=elph.mass.device)
    m = _live_mass(elph)
    return m[:, None] * (4.0 / elph.dtau * sin2[None, :] + elph.dtau * elph.Omega[:, None] ** 2)
