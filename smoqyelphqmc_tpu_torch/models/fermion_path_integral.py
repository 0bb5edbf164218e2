"""Fermion path integral: V(tau, site) and t(tau, hop) as a pure function of x.

Port of smoqyelphqmc_tpu/models/fermion_path_integral.py (Holstein couplings;
without SSH couplings the hoppings carry no tau dependence, `static_hops`)."""

from __future__ import annotations

import dataclasses

import torch

from .electron_phonon import ElectronPhononParameters
from .tight_binding import TightBindingParameters


@dataclasses.dataclass
class FermionPathIntegral:
    V: torch.Tensor  # (Ltau, n_sites) eps - mu + Holstein terms
    t: torch.Tensor  # (Ltau, n_hops)
    dtau: float
    Ltau: int
    n_sites: int
    static_hops: bool = True

    def to_dtype(self, dtype: torch.dtype) -> "FermionPathIntegral":
        return dataclasses.replace(self, V=self.V.to(dtype), t=self.t.to(dtype))


def holstein_potential(elph: ElectronPhononParameters, x: torch.Tensor) -> torch.Tensor:
    """(n_holstein, Ltau) Holstein terms sum_k alpha_k x_p^k (caller scatters)."""
    xp = x[elph.hol_to_phonon_t, :]
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
    t[l, h] = t0_h."""
    if x is None:
        x = elph.x
    Ltau, n_sites = elph.Ltau, tbp.n_sites
    V = ((tbp.eps - tbp.mu)[None, :]).expand(Ltau, n_sites)
    if elph.n_holstein > 0:
        vals = holstein_potential(elph, x)
        V_sc = torch.zeros((n_sites, Ltau), dtype=vals.dtype, device=vals.device)
        V_sc.index_add_(0, elph.hol_to_site_t, vals)
        V = V + V_sc.T
    t = tbp.t0[None, :].expand(Ltau, tbp.n_hops)
    return FermionPathIntegral(V=V.contiguous(), t=t.contiguous(), dtau=elph.dtau, Ltau=Ltau,
                               n_sites=n_sites, static_hops=True)
