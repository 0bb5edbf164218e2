"""Bosonic (phonon) action and its derivatives (port of
the JAX package's ops/bosonic.py for models without dispersion couplings):

  S_b = sum_p sum_l [ M_p / (2 dtau) (x_{p,l+1} - x_{p,l})^2
                      + dtau ( (1/2) M_p Omega_p^2 x_{p,l}^2 + Omega4_p x_{p,l}^4 ) ]

with frozen (infinite-mass) modes masked out."""

from __future__ import annotations

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters


def _live_mass(elph: ElectronPhononParameters) -> torch.Tensor:
    live = torch.as_tensor(~elph.frozen_mask, device=elph.mass.device)
    return torch.where(live, elph.mass, torch.zeros_like(elph.mass))


def bosonic_action(elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    dtau = elph.dtau
    m = _live_mass(elph)
    dx_tau = torch.roll(x, -1, dims=1) - x
    kinetic = torch.sum(m[:, None] / (2.0 * dtau) * dx_tau**2)
    quartic = torch.where(m > 0, elph.Omega4, torch.zeros_like(elph.Omega4))
    potential = torch.sum(dtau * (0.5 * m[:, None] * elph.Omega[:, None] ** 2 * x**2 + quartic[:, None] * x**4))
    return kinetic + potential


def add_anharmonic_force(force: torch.Tensor, elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """force += d/dx of the quartic on-site term (frozen modes masked)."""
    m = _live_mass(elph)
    quartic = torch.where(m > 0, elph.Omega4, torch.zeros_like(elph.Omega4))
    return force + elph.dtau * 4.0 * quartic[:, None] * x**3


def harmonic_curvature(elph: ElectronPhononParameters) -> torch.Tensor:
    """(n_phonon, Ltau) Q_{p,k} = M_p ((4/dtau) sin^2(pi k / Ltau) + dtau Omega_p^2)."""
    k = np.arange(elph.Ltau)
    sin2 = torch.as_tensor(np.sin(np.pi * k / elph.Ltau) ** 2, dtype=torch.float64, device=elph.mass.device)
    m = _live_mass(elph)
    return m[:, None] * (4.0 / elph.dtau * sin2[None, :] + elph.dtau * elph.Omega[:, None] ** 2)
