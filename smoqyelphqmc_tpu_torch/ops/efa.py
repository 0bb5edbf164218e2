"""Exact Fourier accelerator: analytic harmonic evolution of the phonon field.

Port of the JAX package's ops/efa.py on torch.fft. HMC momenta carry per-mode
masses m_k = M ((4/dtau) sin^2(pi k/Ltau) + dtau (Omega^2 + eta^2)), so the
harmonic part rotates (x_k, p_k) exactly. The trajectory carries (x, p) as
(re, im) pairs in the unnormalised forward-DFT convention (omega space); the
per-step force path may run its two transforms in f32 while the carry stays
f64. The momentum noise xi is an argument (drawn by updates/hmc.py). The
transforms, kicks and rotations act on the last (tau) axis, so fields may
carry a leading walker axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.electron_phonon import ElectronPhononParameters
from .bosonic import _live_mass, harmonic_curvature
from .fourier import AxisDFT

Pair = Tuple[torch.Tensor, torch.Tensor]


class FourierAccelerator:
    """Per-(mode, frequency) curvatures Q and fictitious masses m, (n_phonon, Ltau)."""

    def __init__(self, Q: torch.Tensor, m: torch.Tensor, Ltau: int):
        self.Q = Q
        self.m = m
        self.Ltau = Ltau
        self.fwd = AxisDFT(Ltau)
        self.inv = AxisDFT(Ltau, inverse=True)
        self.fwd32 = AxisDFT(Ltau, dtype=torch.float32)
        self.inv32 = AxisDFT(Ltau, inverse=True, dtype=torch.float32)

    @staticmethod
    def build(elph: ElectronPhononParameters, eta: float = 0.0) -> "FourierAccelerator":
        Ltau = elph.Ltau
        Q = harmonic_curvature(elph)
        k = torch.arange(Ltau, dtype=torch.float64, device=elph.mass.device)
        sin2 = torch.sin(torch.pi * k / Ltau) ** 2
        mass = _live_mass(elph)
        m = mass[:, None] * (4.0 / elph.dtau * sin2[None, :] + elph.dtau * (elph.Omega[:, None] ** 2 + eta**2))
        return FourierAccelerator(Q=Q, m=m, Ltau=Ltau)

    def _inv_m(self) -> torch.Tensor:
        live = self.m > 0
        return torch.where(live, 1.0 / torch.where(live, self.m, torch.ones_like(self.m)), torch.zeros_like(self.m))

    def to_omega(self, v: torch.Tensor) -> Pair:
        return self.fwd.apply(v, None, axis=-1)

    def to_tau(self, vr: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
        return self.inv.apply(vr, vi, axis=-1)[0]

    def to_tau_f32(self, vr: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
        return self.inv32.apply(vr.to(torch.float32), vi.to(torch.float32), axis=-1)[0]

    def kick_omega(self, pw: Pair, force: torch.Tensor, dt: float) -> Pair:
        fr, fi = self.fwd.apply(force, None, axis=-1)
        return pw[0] - dt * fr, pw[1] - dt * fi

    def kick_omega_f32(self, pw: Pair, force: torch.Tensor, dt: float) -> Pair:
        """kick_omega with the force transform in f32; the f64 carry stays f64."""
        fr, fi = self.fwd32.apply(force.to(torch.float32), None, axis=-1)
        return pw[0] - dt * fr, pw[1] - dt * fi

    def rotation(self, t: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Planes (c, a, g) of the exact drift by t: x' = c x + a p, p' = c p - g x."""
        m, Q = self.m, self.Q
        live = m > 0
        inv_m = self._inv_m()
        omega = torch.sqrt(torch.where(live, Q * inv_m, torch.zeros_like(Q)))
        osc = omega > 0
        one = torch.ones_like(m)
        inv_mw = torch.where(osc, 1.0 / torch.where(osc, m * omega, one), torch.zeros_like(m))
        c = torch.where(osc, torch.cos(omega * t), one)
        a = torch.where(osc, torch.sin(omega * t) * inv_mw, t * inv_m)
        g = torch.where(osc, m * omega * torch.sin(omega * t), torch.zeros_like(m))
        return c, a, g

    @staticmethod
    def rotate_tabulated(xw: Pair, pw: Pair, rot) -> Tuple[Pair, Pair]:
        c, a, g = rot
        xr, xi = xw
        pr, pi = pw
        return (xr * c + pr * a, xi * c + pi * a), (pr * c - xr * g, pi * c - xi * g)

    def sample_momentum_omega(self, xi: torch.Tensor) -> Tuple[Pair, torch.Tensor]:
        """p_omega = sqrt(m) F xi for white noise xi (n_phonon, Ltau), and its
        kinetic energy."""
        xr, xim = self.fwd.apply(xi, None, axis=-1)
        s = torch.sqrt(self.m)
        pw = (s * xr, s * xim)
        return pw, self.kinetic_energy_omega(pw)

    def kinetic_energy_omega(self, pw: Pair) -> torch.Tensor:
        pr, pi = pw
        return 0.5 * torch.sum((pr**2 + pi**2) * self._inv_m()) / self.Ltau
