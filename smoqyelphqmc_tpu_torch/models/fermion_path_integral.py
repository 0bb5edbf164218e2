"""Fermion path integral: V(tau, site) and t(tau, hop) as a pure function of x.

Port of the JAX package's models/fermion_path_integral.py. Holstein couplings
shift V; SSH couplings dress the hoppings, which then depend on tau
(`static_hops` is False). Complex hoppings, static or from complex SSH
constants, carry their imaginary parts in `t_im` (None for real ones)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .electron_phonon import ElectronPhononParameters
from .tight_binding import TightBindingParameters


@dataclasses.dataclass
class FermionPathIntegral:
    V: torch.Tensor  # (..., Ltau, n_sites) eps - mu + Holstein terms; leading axes are walkers
    t: torch.Tensor  # (..., Ltau, n_hops) real parts; leading axes only with SSH couplings
    dtau: float
    Ltau: int
    n_sites: int
    static_hops: bool = True
    t_im: Optional[torch.Tensor] = None  # (..., Ltau, n_hops) imaginary parts; None for real hoppings

    def to_dtype(self, dtype: torch.dtype) -> "FermionPathIntegral":
        return dataclasses.replace(self, V=self.V.to(dtype), t=self.t.to(dtype),
                                   t_im=None if self.t_im is None else self.t_im.to(dtype))


def holstein_potential(elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """(..., n_holstein, Ltau) Holstein terms sum_k alpha_k x_p^k (caller scatters)."""
    xp = x[..., elph.hol_to_phonon_t, :]
    return (
        elph.hol_alpha[:, None] * xp
        + elph.hol_alpha2[:, None] * xp**2
        + elph.hol_alpha3[:, None] * xp**3
        + elph.hol_alpha4[:, None] * xp**4
    )


def ssh_hopping_shift(elph: ElectronPhononParameters, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., n_ssh, Ltau) SSH terms sum_k alpha_k (x_f - x_i)^k as an (re,
    im-or-None) pair (im for complex coupling constants)."""
    dx = x[..., elph.ssh_to_phonon_t[1], :] - x[..., elph.ssh_to_phonon_t[0], :]

    def poly(a1, a2, a3, a4):
        return a1[:, None] * dx + a2[:, None] * dx**2 + a3[:, None] * dx**3 + a4[:, None] * dx**4

    re = poly(elph.ssh_alpha, elph.ssh_alpha2, elph.ssh_alpha3, elph.ssh_alpha4)
    if not elph.complex_ssh:
        return re, None
    return re, poly(elph.ssh_alpha_im, elph.ssh_alpha2_im, elph.ssh_alpha3_im, elph.ssh_alpha4_im)


def build_path_integral(
    tbp: TightBindingParameters,
    elph: ElectronPhononParameters,
    x: torch.Tensor | None = None,
) -> FermionPathIntegral:
    """V[l, i] = eps_i - mu + sum_{holstein c -> i} sum_k alpha_k x_{p_c, l}^k,
    t[l, h] = t0_h - sum_{ssh c -> h} sum_k alpha_k (x_{p'_c, l} - x_{p_c, l})^k
    (and t_im likewise from t0_im and the imaginary parts of complex SSH
    constants). A field x (W, n_phonon, Ltau) gives V (W, Ltau, N), and with
    SSH couplings t (W, Ltau, n_hops); a walker batch's chemical potentials,
    tbp.mu of shape (W,), also give V (W, Ltau, N)."""
    if x is None:
        x = elph.x
    Ltau, n_sites = elph.Ltau, tbp.n_sites
    mu = tbp.mu
    if mu.dim() == 1:  # one mu a walker
        V = (tbp.eps[None, :] - mu[:, None])[:, None, :].expand(mu.shape[0], Ltau, n_sites)
    else:
        V = ((tbp.eps - mu)[None, :]).expand(Ltau, n_sites)
    if elph.n_holstein > 0:
        vals = holstein_potential(elph, x)
        V_sc = torch.zeros(x.shape[:-2] + (n_sites, Ltau), dtype=vals.dtype, device=vals.device)
        V_sc.index_add_(-2, elph.hol_to_site_t, vals)
        V = V + V_sc.transpose(-1, -2)
    t = tbp.t0[None, :].expand(Ltau, tbp.n_hops)
    t_im = None if tbp.t0_im is None else tbp.t0_im[None, :].expand(Ltau, tbp.n_hops)
    if elph.n_ssh > 0:
        shift_re, shift_im = ssh_hopping_shift(elph, x)

        def dressed(t_base, shift):
            sc = torch.zeros(x.shape[:-2] + (tbp.n_hops, Ltau), dtype=shift.dtype, device=shift.device)
            sc.index_add_(-2, elph.ssh_to_hop_t, shift)
            return t_base - sc.transpose(-1, -2)

        t = dressed(t, shift_re)
        if shift_im is not None:
            t_im = dressed(torch.zeros_like(t) if t_im is None else t_im, shift_im)
    return FermionPathIntegral(V=V.contiguous(), t=t.contiguous(), dtau=elph.dtau, Ltau=Ltau, n_sites=n_sites,
                               static_hops=elph.n_ssh == 0, t_im=None if t_im is None else t_im.contiguous())
