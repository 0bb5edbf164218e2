"""Holstein shift matrix Lambda and its products.

Port of smoqyelphqmc_tpu/ops/lambda_shift.py: Lambda is diagonal per site with
a one-slice tau shift,

  Lambda[l, n] = s_l * exp(+dtau (alpha x_{p,l} + alpha3 x_{p,l}^3) / 2),
  s_0 = +1, s_l = -1 (l > 0),

with only ph-sym-form Holstein couplings contributing the exponential factor.
Fields are (..., Ltau, N); complex fields ride a leading channel axis."""

from __future__ import annotations

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters


def build_lambda(elph: ElectronPhononParameters, x: torch.Tensor, n_sites: int) -> torch.Tensor:
    """(Ltau, n_sites) shift matrix for the phonon field x (dtype of x)."""
    Ltau = elph.Ltau
    base = torch.full((Ltau, 1), -1.0, dtype=x.dtype, device=x.device)
    base[0, 0] = 1.0
    idx = np.where(elph.hol_ph_sym)[0]
    if idx.size == 0:
        return base.expand(Ltau, n_sites).contiguous()
    idx_t = torch.as_tensor(idx, dtype=torch.long, device=x.device)
    xp = x[elph.hol_to_phonon_t[idx_t], :]
    expo = 0.5 * elph.dtau * (elph.hol_alpha[idx_t][:, None] * xp + elph.hol_alpha3[idx_t][:, None] * xp**3)
    # the JAX package multiplies exp() factors per site; summing exponents is the
    # same product (bit-identical with one coupling per site, 1 ulp otherwise)
    expo_site = torch.zeros((n_sites, Ltau), dtype=x.dtype, device=x.device)
    expo_site.index_add_(0, elph.hol_to_site_t[idx_t], expo)
    return base * torch.exp(expo_site).T


def mul_lambda(Lam: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v'[l] = Lambda[l+1] v[l+1] (cyclic)."""
    return torch.roll(Lam * v, -1, dims=-2)


def ldiv_lambda(Lam: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v'[l] = v[l-1] / Lambda[l]."""
    return torch.roll(v, 1, dims=-2) / Lam


def mul_lambda_T(Lam: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v'[l] = Lambda[l] v[l-1]."""
    return Lam * torch.roll(v, 1, dims=-2)


def ldiv_lambda_T(Lam: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v'[l] = v[l+1] / Lambda[l+1]."""
    return torch.roll(v / Lam, -1, dims=-2)


def add_lambda_derivative_force(
    force: torch.Tensor,
    nu: float,
    up: torch.Tensor,
    v: torch.Tensor,
    Lam: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
) -> torch.Tensor:
    """force[p, l] += nu * Re <up | dLambda/dx_{p,l} | v>; up, v are (2, Ltau, N)."""
    idx = np.where(elph.hol_ph_sym)[0]
    if idx.size == 0:
        return force
    idx_t = torch.as_tensor(idx, dtype=torch.long, device=x.device)
    sites = elph.hol_to_site_t[idx_t]
    phonons = elph.hol_to_phonon_t[idx_t]
    xp = x[phonons, :]
    dcoup = 0.5 * elph.dtau * (elph.hol_alpha[idx_t][:, None] + 3.0 * elph.hol_alpha3[idx_t][:, None] * xp**2)
    lam_site = Lam[:, sites]
    up_shift = torch.roll(up, 1, dims=-2)
    prod = torch.sum(up_shift[..., sites] * v[..., sites], dim=0)
    val = nu * (dcoup.T * lam_site * prod)
    return force.index_add(0, phonons, val.T)
