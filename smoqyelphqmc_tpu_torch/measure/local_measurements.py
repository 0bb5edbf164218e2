"""Local (per-unit-cell-averaged) measurements: tight-binding, Holstein, SSH
and dispersion energies, phonon moments.

Port of the JAX package's measure/local_measurements.py. Estimator-based
results are complex 0-dim tensors (the JAX package returns (re, im) pairs);
the products with the float64 model tables promote them to complex128, as in
the JAX package. Phonon moments and the dispersion energy are real float64.
The fields x are one walker's (n_phonon, Ltau), the path integral's t one
walker's (Ltau, n_hops)."""

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


def measure_ssh_energy(est: GreensEstimator, elph: ElectronPhononParameters, tbp: TightBindingParameters,
                       x: torch.Tensor, ssh_id: int) -> torch.Tensor:
    """Single-spin SSH coupling energy of one coupling type:
    <c G(i, f) + conj(c) G(f, i)> with c = sum_k alpha_k (x_f - x_i)^k
    (complex for complex coupling constants)."""
    nc = elph.n_cells
    sl = slice(ssh_id * nc, (ssh_id + 1) * nc)
    hops = elph.ssh_to_hop[sl]
    dev = est.GR.device
    s_i = torch.as_tensor(tbp.neighbor_table[0, hops], dtype=torch.long, device=dev)
    s_f = torch.as_tensor(tbp.neighbor_table[1, hops], dtype=torch.long, device=dev)
    dx = x[elph.ssh_to_phonon_t[1, sl], :] - x[elph.ssh_to_phonon_t[0, sl], :]  # (Nc, Ltau)

    def poly(a1, a2, a3, a4):
        return a1[sl][:, None] * dx + a2[sl][:, None] * dx**2 + a3[sl][:, None] * dx**3 + a4[sl][:, None] * dx**4

    GR, Rc = _fields(est)
    hf = -(GR[..., s_i] * Rc[..., s_f]).mean(dim=0).T  # (Nc, Ltau)
    hr = -(GR[..., s_f] * Rc[..., s_i]).mean(dim=0).T
    e = torch.sum(poly(elph.ssh_alpha, elph.ssh_alpha2, elph.ssh_alpha3, elph.ssh_alpha4) * (hf + hr))
    if elph.complex_ssh:
        c_im = poly(elph.ssh_alpha_im, elph.ssh_alpha2_im, elph.ssh_alpha3_im, elph.ssh_alpha4_im)
        e = e + torch.sum(1j * c_im * (hf - hr))
    return e / (nc * est.Ltau)


def measure_dispersion_energy(elph: ElectronPhononParameters, x: torch.Tensor, dispersion_id: int) -> torch.Tensor:
    """<(1/2) Mr Omega_d^2 (dx)^2 + Omega4_d (dx)^4> of one dispersive coupling type."""
    from ..ops.bosonic import _reduced_mass

    nc = elph.n_cells
    sl = slice(dispersion_id * nc, (dispersion_id + 1) * nc)
    mr = _reduced_mass(elph)[sl]
    dxp = x[elph.disp_to_phonon_t[1, sl], :] - x[elph.disp_to_phonon_t[0, sl], :]
    u = 0.5 * mr[:, None] * elph.disp_Omega[sl][:, None] ** 2 * dxp**2 + elph.disp_Omega4[sl][:, None] * dxp**4
    return torch.mean(torch.sum(u, dim=0) / nc)
