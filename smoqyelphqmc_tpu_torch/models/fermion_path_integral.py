"""Fermion path integral: V(tau, site) and t(tau, hop) as a pure function of x.

Port of the JAX package's models/fermion_path_integral.py (Holstein couplings;
without SSH couplings the hoppings carry no tau dependence, `static_hops`).
Complex hoppings carry their imaginary parts in `t_im` (None for real ones);
the SSH dressing of the imaginary part waits with the SSH couplings (ROADMAP
Queue 1, item 15)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .electron_phonon import ElectronPhononParameters
from .tight_binding import TightBindingParameters


@dataclasses.dataclass
class FermionPathIntegral:
    V: torch.Tensor  # (..., Ltau, n_sites) eps - mu + Holstein terms; leading axes are walkers
    t: torch.Tensor  # (Ltau, n_hops) real parts
    dtau: float
    Ltau: int
    n_sites: int
    static_hops: bool = True
    t_im: Optional[torch.Tensor] = None  # (Ltau, n_hops) imaginary parts; None for real hoppings

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


def build_path_integral(
    tbp: TightBindingParameters,
    elph: ElectronPhononParameters,
    x: torch.Tensor | None = None,
) -> FermionPathIntegral:
    """V[l, i] = eps_i - mu + sum_{holstein c -> i} sum_k alpha_k x_{p_c, l}^k,
    t[l, h] = t0_h (and t_im[l, h] = t0_im_h for complex hoppings). A field x
    (W, n_phonon, Ltau) gives V (W, Ltau, N); so does a walker batch's
    chemical potentials, tbp.mu of shape (W,), with or without Holstein
    couplings."""
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
    t_im = None if tbp.t0_im is None else tbp.t0_im[None, :].expand(Ltau, tbp.n_hops).contiguous()
    return FermionPathIntegral(V=V.contiguous(), t=t.contiguous(), dtau=elph.dtau, Ltau=Ltau,
                               n_sites=n_sites, static_hops=True, t_im=t_im)
