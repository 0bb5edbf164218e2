"""Local (per-unit-cell-averaged) measurements: tight-binding and Holstein
energies, phonon moments.

Port of the JAX package's measure/local_measurements.py for the couplings the
port has. Estimator-based results are complex 0-dim tensors (the JAX package
returns (re, im) pairs); the products with the float64 model tables promote
them to complex128, as in the JAX package. Phonon moments are real float64.
The SSH and dispersion energies wait for those couplings (ROADMAP Queue 1,
item 15)."""

from __future__ import annotations

from typing import Optional

import torch

from ..models.electron_phonon import ElectronPhononParameters
from ..models.fermion_path_integral import FermionPathIntegral
from ..models.tight_binding import TightBindingParameters
from .greens_estimator import GreensEstimator


def _fields(est: GreensEstimator):
    """(GR, conj(R)) as complex (Nrv, Ltau, N) fields."""
    return torch.complex(est.GR[:, 0], est.GR[:, 1]), torch.complex(est.R[:, 0], -est.R[:, 1])


def _site_density_fields(est: GreensEstimator) -> torch.Tensor:
    """W = 1 - GR (.) conj(R): the per-point single-spin density estimate,
    complex (Nrv, Ltau, N)."""
    GR, Rc = _fields(est)
    return 1.0 - GR * Rc


def measure_onsite_energy(est: GreensEstimator, tbp: TightBindingParameters, orbital: int) -> torch.Tensor:
    """(1/Nc) sum_cells (eps - mu) <n>."""
    W = _site_density_fields(est).reshape(est.Nrv, est.Ltau, est.n_cells, est.n_orb)[..., orbital]
    eps = tbp.eps.reshape(est.n_cells, est.n_orb)[:, orbital] - tbp.mu  # (Nc,)
    return torch.sum(eps * W) / (est.Nrv * est.Ltau * est.n_cells)


def _hopping_energy(est: GreensEstimator, tbp: TightBindingParameters, t_lh: torch.Tensor, hopping_id: int,
                    t_lh_im: Optional[torch.Tensor] = None) -> torch.Tensor:
    """< t GR(i) conj(R)(f) + conj(t) GR(f) conj(R)(i) > normalized by
    (Ltau Nsites Nrv); t_lh(_im): (Ltau, n_hops) parts of the hopping
    amplitudes."""
    start, stop = tbp.bond_slices[hopping_id]
    nt = tbp.neighbor_table[:, start:stop]
    dev = est.GR.device
    i = torch.as_tensor(nt[0], dtype=torch.long, device=dev)
    f = torch.as_tensor(nt[1], dtype=torch.long, device=dev)
    t = t_lh[:, start:stop]  # (Ltau, Nc)
    if t_lh_im is not None:
        t = torch.complex(t, t_lh_im[:, start:stop])
    GR, Rc = _fields(est)
    fw = GR[..., i] * Rc[..., f]
    rv = GR[..., f] * Rc[..., i]
    return torch.sum(t * fw + t.conj() * rv) / (est.Ltau * est.n_sites * est.Nrv)


def measure_bare_hopping_energy(est: GreensEstimator, tbp: TightBindingParameters, hopping_id: int) -> torch.Tensor:
    t = tbp.t0[None, :].expand(est.Ltau, tbp.n_hops)
    ti = None if tbp.t0_im is None else tbp.t0_im[None, :].expand(est.Ltau, tbp.n_hops)
    return _hopping_energy(est, tbp, t, hopping_id, ti)


def measure_hopping_energy(est: GreensEstimator, tbp: TightBindingParameters, fpi: FermionPathIntegral,
                           hopping_id: int) -> torch.Tensor:
    return _hopping_energy(est, tbp, fpi.t, hopping_id, fpi.t_im)


def measure_hopping_amplitude(tbp: TightBindingParameters, fpi: FermionPathIntegral,
                              hopping_id: int) -> torch.Tensor:
    """Mean dressed hopping amplitude of one hopping type (complex128)."""
    start, stop = tbp.bond_slices[hopping_id]
    im = torch.zeros((), dtype=fpi.t.dtype, device=fpi.t.device) if fpi.t_im is None \
        else fpi.t_im[:, start:stop].mean()
    return torch.complex(fpi.t[:, start:stop].mean(), im)


def measure_hopping_inversion(tbp: TightBindingParameters, fpi: FermionPathIntegral,
                              hopping_id: int) -> torch.Tensor:
    """Fraction of (hop, slice) entries whose dressed hopping has the opposite
    sign of the bare hopping (float64)."""
    start, stop = tbp.bond_slices[hopping_id]
    return (fpi.t[:, start:stop] * tbp.t0[start:stop][None, :] < 0).to(torch.float64).mean()


# ----------------------------------------------------------------------
# Electron-phonon measurements
# ----------------------------------------------------------------------


def _type_slice(elph: ElectronPhononParameters, type_id: int) -> slice:
    return slice(type_id * elph.n_cells, (type_id + 1) * elph.n_cells)


def measure_phonon_kinetic_energy(elph: ElectronPhononParameters, x: torch.Tensor, phonon_id: int) -> torch.Tensor:
    """Primitive estimator KE = 1/(2 dtau) - M <(x_{l+1}-x_l)^2> / (2 dtau^2),
    averaged over the cells of one phonon type; frozen modes report 0."""
    sl = _type_slice(elph, phonon_id)
    xs, m = x[sl], elph.mass[sl]
    live = torch.isfinite(m)
    dx = torch.roll(xs, -1, dims=1) - xs
    ke = 0.5 / elph.dtau - torch.where(live, m, 0.0)[:, None] * dx**2 / (2.0 * elph.dtau**2)
    ke = torch.where(live[:, None], ke, 0.0)
    return torch.sum(ke.mean(dim=1)) / torch.clamp(live.sum(), min=1)


def measure_phonon_potential_energy(elph: ElectronPhononParameters, x: torch.Tensor,
                                    phonon_id: int) -> torch.Tensor:
    """<(1/2) M Omega^2 x^2 + Omega4 x^4> per mode of one type."""
    sl = _type_slice(elph, phonon_id)
    xs, m = x[sl], elph.mass[sl]
    live = torch.isfinite(m)
    pe = 0.5 * torch.where(live, m, 0.0)[:, None] * elph.Omega[sl][:, None] ** 2 * xs**2
    pe = pe + torch.where(live, elph.Omega4[sl], 0.0)[:, None] * xs**4
    return torch.sum(pe.mean(dim=1)) / torch.clamp(live.sum(), min=1)


def measure_phonon_position_moment(elph: ElectronPhononParameters, x: torch.Tensor, phonon_id: int,
                                   power: int) -> torch.Tensor:
    return torch.mean(x[_type_slice(elph, phonon_id)] ** power)


def measure_holstein_energy(est: GreensEstimator, elph: ElectronPhononParameters, x: torch.Tensor,
                            holstein_id: int) -> torch.Tensor:
    """Single-spin Holstein coupling energy of one coupling type: even powers
    couple to n, odd powers to (n - 1/2) in the particle-hole-symmetric form."""
    nc = elph.n_cells
    sl = slice(holstein_id * nc, (holstein_id + 1) * nc)
    phonons = elph.hol_to_phonon_t[sl]
    sites = elph.hol_to_site_t[sl]
    shift = 0.5 if bool(elph.hol_ph_sym[holstein_id * nc]) else 0.0
    xp = x[phonons, :]  # (Nc, Ltau)
    even = elph.hol_alpha2[sl][:, None] * xp**2 + elph.hol_alpha4[sl][:, None] * xp**4
    odd = elph.hol_alpha[sl][:, None] * xp + elph.hol_alpha3[sl][:, None] * xp**3
    n = _site_density_fields(est)[..., sites].mean(dim=0).T  # (Nc, Ltau)
    return torch.sum(even * n + odd * (n - shift)) / (nc * est.Ltau)


def measure_ssh_energy(*args, **kwargs):
    raise NotImplementedError("SSH couplings are not ported yet (ROADMAP Queue 1, item 15)")


def measure_dispersion_energy(*args, **kwargs):
    raise NotImplementedError("dispersion couplings are not ported yet (ROADMAP Queue 1, item 15)")
