"""Electron-phonon model definition and lattice-expanded parameters.

Port of the JAX package's models/electron_phonon.py: phonon modes (with
disorder, anharmonic Omega4 and frozen modes), Holstein couplings, SSH
couplings (real or complex coupling constants) and dispersion couplings.
Layouts are the JAX package's: type-major (index = type * n_cells + cell), x
shaped (n_phonon, Ltau); complex SSH constants keep their imaginary parts in
the `*_im` fields (None for real ones).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..lattice import Bond, ModelGeometry, cell_linear_indices
from .tight_binding import TightBindingModel, TightBindingParameters


@dataclasses.dataclass(frozen=True)
class PhononMode:
    """Dispersionless phonon mode in every unit cell; M = inf freezes it."""

    basis_vec: Tuple[float, ...]
    Omega_mean: float
    Omega_std: float = 0.0
    M: float = 1.0
    Omega4_mean: float = 0.0
    Omega4_std: float = 0.0

    def __init__(self, basis_vec, Omega_mean, Omega_std=0.0, M=1.0, Omega4_mean=0.0, Omega4_std=0.0):
        object.__setattr__(self, "basis_vec", tuple(float(x) for x in basis_vec))
        object.__setattr__(self, "Omega_mean", float(Omega_mean))
        object.__setattr__(self, "Omega_std", float(Omega_std))
        object.__setattr__(self, "M", float(M))
        object.__setattr__(self, "Omega4_mean", float(Omega4_mean))
        object.__setattr__(self, "Omega4_std", float(Omega4_std))


@dataclasses.dataclass(frozen=True)
class HolsteinCoupling:
    """Local coupling sum_k alpha_k X_p^k n_i; `ph_sym_form` couples the odd
    powers to (n - 1/2) through the Lambda shift matrix (ops/lambda_shift.py)."""

    phonon_id: int
    orbital_id: int
    displacement: Tuple[int, ...]
    alpha_mean: float
    alpha_std: float = 0.0
    alpha2_mean: float = 0.0
    alpha2_std: float = 0.0
    alpha3_mean: float = 0.0
    alpha3_std: float = 0.0
    alpha4_mean: float = 0.0
    alpha4_std: float = 0.0
    ph_sym_form: bool = False

    def __init__(self, phonon_id, orbital_id, displacement, alpha_mean, alpha_std=0.0,
                 alpha2_mean=0.0, alpha2_std=0.0, alpha3_mean=0.0, alpha3_std=0.0,
                 alpha4_mean=0.0, alpha4_std=0.0, ph_sym_form=False):
        object.__setattr__(self, "phonon_id", int(phonon_id))
        object.__setattr__(self, "orbital_id", int(orbital_id))
        object.__setattr__(self, "displacement", tuple(int(d) for d in displacement))
        for name, val in [("alpha_mean", alpha_mean), ("alpha_std", alpha_std),
                          ("alpha2_mean", alpha2_mean), ("alpha2_std", alpha2_std),
                          ("alpha3_mean", alpha3_mean), ("alpha3_std", alpha3_std),
                          ("alpha4_mean", alpha4_mean), ("alpha4_std", alpha4_std)]:
            object.__setattr__(self, name, float(val))
        object.__setattr__(self, "ph_sym_form", bool(ph_sym_form))


@dataclasses.dataclass(frozen=True)
class SSHCoupling:
    """SSH coupling: the hopping on `bond` becomes t - sum_k alpha_k (Dx)^k,
    Dx = x_{p_final} - x_{p_initial} for phonon_ids = (p_initial, p_final);
    p_initial lives on the bond's initial cell, p_final on its final cell.
    Bond-SSH models couple a frozen mode and a live one, optical-SSH models
    two live ones. The alpha means may be complex."""

    phonon_ids: Tuple[int, int]
    bond: Bond
    alpha_mean: complex
    alpha_std: float = 0.0
    alpha2_mean: complex = 0.0
    alpha2_std: float = 0.0
    alpha3_mean: complex = 0.0
    alpha3_std: float = 0.0
    alpha4_mean: complex = 0.0
    alpha4_std: float = 0.0

    def __init__(self, phonon_ids, bond, alpha_mean, alpha_std=0.0, alpha2_mean=0.0,
                 alpha2_std=0.0, alpha3_mean=0.0, alpha3_std=0.0, alpha4_mean=0.0, alpha4_std=0.0):
        object.__setattr__(self, "phonon_ids", (int(phonon_ids[0]), int(phonon_ids[1])))
        object.__setattr__(self, "bond", bond)
        for name, val in [("alpha_mean", alpha_mean), ("alpha_std", alpha_std),
                          ("alpha2_mean", alpha2_mean), ("alpha2_std", alpha2_std),
                          ("alpha3_mean", alpha3_mean), ("alpha3_std", alpha3_std),
                          ("alpha4_mean", alpha4_mean), ("alpha4_std", alpha4_std)]:
            object.__setattr__(self, name, float(val) if name.endswith("std") else complex(val))


@dataclasses.dataclass(frozen=True)
class DispersionCoupling:
    """Dispersive coupling of phonon_ids[0] in cell i and phonon_ids[1] in cell
    i + displacement: (1/2) Omega^2 Mr (x_f - x_i)^2 + Omega4 (x_f - x_i)^4 a
    time slice, Mr the pair's reduced mass, weighted by dtau."""

    phonon_ids: Tuple[int, int]
    displacement: Tuple[int, ...]
    Omega_mean: float
    Omega_std: float = 0.0
    Omega4_mean: float = 0.0
    Omega4_std: float = 0.0

    def __init__(self, phonon_ids, displacement, Omega_mean, Omega_std=0.0, Omega4_mean=0.0, Omega4_std=0.0):
        object.__setattr__(self, "phonon_ids", (int(phonon_ids[0]), int(phonon_ids[1])))
        object.__setattr__(self, "displacement", tuple(int(d) for d in displacement))
        object.__setattr__(self, "Omega_mean", float(Omega_mean))
        object.__setattr__(self, "Omega_std", float(Omega_std))
        object.__setattr__(self, "Omega4_mean", float(Omega4_mean))
        object.__setattr__(self, "Omega4_std", float(Omega4_std))


class ElectronPhononModel:
    """Registry of phonon modes and couplings."""

    def __init__(self, model_geometry: ModelGeometry, tight_binding_model: TightBindingModel):
        self.model_geometry = model_geometry
        self.tight_binding_model = tight_binding_model
        self.phonon_modes: List[PhononMode] = []
        self.holstein_couplings: List[HolsteinCoupling] = []
        self.ssh_couplings: List[SSHCoupling] = []
        self.dispersion_couplings: List[DispersionCoupling] = []

    def add_phonon_mode(self, phonon_mode: PhononMode) -> int:
        self.phonon_modes.append(phonon_mode)
        return len(self.phonon_modes) - 1

    def add_holstein_coupling(self, holstein_coupling: HolsteinCoupling) -> int:
        if not 0 <= holstein_coupling.phonon_id < len(self.phonon_modes):
            raise ValueError(f"unknown phonon id {holstein_coupling.phonon_id}")
        if not 0 <= holstein_coupling.orbital_id < self.model_geometry.n_orbitals:
            raise ValueError(f"unknown orbital id {holstein_coupling.orbital_id}")
        self.holstein_couplings.append(holstein_coupling)
        return len(self.holstein_couplings) - 1

    def _check_phonons(self, phonon_ids) -> None:
        for p in phonon_ids:
            if not 0 <= p < len(self.phonon_modes):
                raise ValueError(f"unknown phonon id {p}")

    def add_ssh_coupling(self, ssh_coupling: SSHCoupling) -> int:
        self._check_phonons(ssh_coupling.phonon_ids)
        if ssh_coupling.bond not in self.tight_binding_model.t_bonds:
            raise ValueError("an SSH coupling must modulate a hopping bond of the tight-binding model")
        self.ssh_couplings.append(ssh_coupling)
        return len(self.ssh_couplings) - 1

    def add_dispersion_coupling(self, dispersion_coupling: DispersionCoupling) -> int:
        self._check_phonons(dispersion_coupling.phonon_ids)
        self.dispersion_couplings.append(dispersion_coupling)
        return len(self.dispersion_couplings) - 1


_FLOAT_FIELDS = ("x", "Omega", "Omega4", "mass", "hol_alpha", "hol_alpha2", "hol_alpha3", "hol_alpha4",
                 "ssh_alpha", "ssh_alpha2", "ssh_alpha3", "ssh_alpha4", "ssh_alpha_im", "ssh_alpha2_im",
                 "ssh_alpha3_im", "ssh_alpha4_im", "disp_Omega", "disp_Omega4")


@dataclasses.dataclass
class ElectronPhononParameters:
    """Lattice-expanded electron-phonon parameters + the initial phonon field.

    Float fields are tensors on one device; index tables are host NumPy arrays
    (with device copies for gathers)."""

    x: torch.Tensor  # (n_phonon, Ltau)
    Omega: torch.Tensor  # (n_phonon,)
    Omega4: torch.Tensor  # (n_phonon,)
    mass: torch.Tensor  # (n_phonon,), +inf for frozen modes
    hol_alpha: torch.Tensor  # (n_holstein,)
    hol_alpha2: torch.Tensor
    hol_alpha3: torch.Tensor
    hol_alpha4: torch.Tensor
    ssh_alpha: torch.Tensor  # (n_ssh,) real parts
    ssh_alpha2: torch.Tensor
    ssh_alpha3: torch.Tensor
    ssh_alpha4: torch.Tensor
    ssh_alpha_im: Optional[torch.Tensor]  # (n_ssh,) imaginary parts; None for real constants
    ssh_alpha2_im: Optional[torch.Tensor]
    ssh_alpha3_im: Optional[torch.Tensor]
    ssh_alpha4_im: Optional[torch.Tensor]
    disp_Omega: torch.Tensor  # (n_dispersion,)
    disp_Omega4: torch.Tensor
    beta: float
    dtau: float
    Ltau: int
    n_cells: int
    nphonon: int
    hol_to_phonon: np.ndarray  # (n_holstein,) int32
    hol_to_site: np.ndarray  # (n_holstein,) int32
    hol_ph_sym: np.ndarray  # (n_holstein,) bool
    ssh_to_phonon: np.ndarray  # (2, n_ssh) int32: (p_initial, p_final) of each coupling
    ssh_to_hop: np.ndarray  # (n_ssh,) int32 hop of each coupling
    disp_to_phonon: np.ndarray  # (2, n_dispersion) int32
    frozen_mask: np.ndarray  # (n_phonon,) bool

    def __post_init__(self):
        dev = self.x.device

        def long(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        self.hol_to_phonon_t = long(self.hol_to_phonon)
        self.hol_to_site_t = long(self.hol_to_site)
        self.ssh_to_phonon_t = long(self.ssh_to_phonon)
        self.ssh_to_hop_t = long(self.ssh_to_hop)
        self.disp_to_phonon_t = long(self.disp_to_phonon)

    @property
    def n_phonon(self) -> int:
        return self.nphonon * self.n_cells

    @property
    def n_holstein(self) -> int:
        return self.hol_to_phonon.shape[0]

    @property
    def n_ssh(self) -> int:
        return self.ssh_to_hop.shape[0]

    @property
    def n_dispersion(self) -> int:
        return self.disp_to_phonon.shape[1]

    @property
    def complex_ssh(self) -> bool:
        """True when an SSH coupling constant is complex."""
        return self.ssh_alpha_im is not None

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to_dtype(self, dtype: torch.dtype) -> "ElectronPhononParameters":
        """Copy with every float tensor cast (the f32 force path, ops/pff.py)."""
        return dataclasses.replace(self, **{f: getattr(self, f).to(dtype) for f in _FLOAT_FIELDS
                                            if getattr(self, f) is not None})


def _expand(mean, std: float, n: int, rng: np.random.Generator, dtype=np.float64) -> np.ndarray:
    vals = np.full(n, mean, dtype=dtype)
    if std > 0:
        vals = vals + std * rng.standard_normal(n)
    return vals


def initialize_electron_phonon_parameters(
    beta: float,
    dtau: float,
    electron_phonon_model: ElectronPhononModel,
    tight_binding_parameters: TightBindingParameters,
    rng: np.random.Generator | None = None,
    x_init: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> ElectronPhononParameters:
    """Expand the model onto the lattice and sample the initial field (the same
    draws, in the same order, as the JAX package: the modes, the Holstein,
    SSH and dispersion couplings, then the field)."""
    if rng is None:
        rng = np.random.default_rng(0)
    geo = electron_phonon_model.model_geometry
    tbm = electron_phonon_model.tight_binding_model
    n_cells = geo.n_cells
    Ltau = int(round(beta / dtau))
    if abs(Ltau * dtau - beta) >= 1e-10:
        raise ValueError("beta must be an integer multiple of dtau")

    modes = electron_phonon_model.phonon_modes
    nphonon = len(modes)
    n_phonon = nphonon * n_cells
    Omega = np.concatenate([_expand(m.Omega_mean, m.Omega_std, n_cells, rng) for m in modes]) if modes else np.zeros(0)
    Omega4 = np.concatenate([_expand(m.Omega4_mean, m.Omega4_std, n_cells, rng) for m in modes]) if modes else np.zeros(0)
    mass = np.concatenate([np.full(n_cells, m.M) for m in modes]) if modes else np.zeros(0)
    frozen_mask = ~np.isfinite(mass)

    cells = cell_linear_indices(geo.L)
    Lvec = np.asarray(geo.L, dtype=np.int64)
    cell_lin = np.arange(n_cells)

    def _targets(disp):
        """Linear cell index of cell + disp for every cell."""
        return np.ravel_multi_index(((cells + np.asarray(disp, dtype=np.int64)[None, :]) % Lvec[None, :]).T, geo.L)

    def _cat(lst, dtype=np.float64):
        return np.concatenate(lst).astype(dtype) if lst else np.zeros(0, dtype=dtype)

    alphas: List[List[np.ndarray]] = [[], [], [], []]
    hol_to_phonon, hol_to_site, hol_ph_sym = [], [], []
    for hc in electron_phonon_model.holstein_couplings:
        keep = ~geo.displacement_wrap_mask(hc.displacement)
        for k, (mean, std) in enumerate([(hc.alpha_mean, hc.alpha_std), (hc.alpha2_mean, hc.alpha2_std),
                                         (hc.alpha3_mean, hc.alpha3_std), (hc.alpha4_mean, hc.alpha4_std)]):
            alphas[k].append(_expand(mean, std, n_cells, rng) * keep)
        hol_to_phonon.append(hc.phonon_id * n_cells + cell_lin)
        hol_to_site.append(_targets(hc.displacement) * geo.n_orbitals + hc.orbital_id)
        hol_ph_sym.append(np.full(n_cells, hc.ph_sym_form, dtype=bool))

    sshs = electron_phonon_model.ssh_couplings
    complex_ssh = any(complex(v).imag != 0 for sc in sshs
                      for v in (sc.alpha_mean, sc.alpha2_mean, sc.alpha3_mean, sc.alpha4_mean))
    # complex constants expand in complex128 (disorder perturbs the real part)
    ssh_dtype = np.complex128 if complex_ssh else np.float64
    ssh_alphas: List[List[np.ndarray]] = [[], [], [], []]
    ssh_i, ssh_f, ssh_to_hop = [], [], []
    for sc in sshs:
        start, stop = tight_binding_parameters.bond_slices[tbm.t_bonds.index(sc.bond)]
        if stop - start != n_cells:
            raise ValueError("an SSH bond must have one hop a cell")
        ssh_to_hop.append(start + cell_lin)
        ssh_i.append(sc.phonon_ids[0] * n_cells + cell_lin)
        ssh_f.append(sc.phonon_ids[1] * n_cells + _targets(sc.bond.displacement))
        keep = ~geo.bond_wrap_mask(sc.bond)
        for k, (mean, std) in enumerate([(sc.alpha_mean, sc.alpha_std), (sc.alpha2_mean, sc.alpha2_std),
                                         (sc.alpha3_mean, sc.alpha3_std), (sc.alpha4_mean, sc.alpha4_std)]):
            ssh_alphas[k].append(_expand(mean if complex_ssh else mean.real, std, n_cells, rng, ssh_dtype) * keep)

    disp_Omega, disp_Omega4, disp_i, disp_f = [], [], [], []
    for dc in electron_phonon_model.dispersion_couplings:
        keep = ~geo.displacement_wrap_mask(dc.displacement)
        disp_Omega.append(_expand(dc.Omega_mean, dc.Omega_std, n_cells, rng) * keep)
        disp_Omega4.append(_expand(dc.Omega4_mean, dc.Omega4_std, n_cells, rng) * keep)
        disp_i.append(dc.phonon_ids[0] * n_cells + cell_lin)
        disp_f.append(dc.phonon_ids[1] * n_cells + _targets(dc.displacement))

    if x_init is None:
        x_init = np.zeros((n_phonon, Ltau))
        if n_phonon:
            finite = np.isfinite(mass) & (Omega > 0)
            sigma = np.zeros(n_phonon)
            sigma[finite] = 1.0 / np.sqrt(2.0 * mass[finite] * Omega[finite])
            x_init = sigma[:, None] * rng.standard_normal((n_phonon, Ltau))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, device=device)

    ssh = [_cat(a, ssh_dtype) for a in ssh_alphas]
    return ElectronPhononParameters(
        x=t(x_init), Omega=t(Omega), Omega4=t(Omega4), mass=t(mass),
        hol_alpha=t(_cat(alphas[0])), hol_alpha2=t(_cat(alphas[1])),
        hol_alpha3=t(_cat(alphas[2])), hol_alpha4=t(_cat(alphas[3])),
        ssh_alpha=t(ssh[0].real), ssh_alpha2=t(ssh[1].real), ssh_alpha3=t(ssh[2].real), ssh_alpha4=t(ssh[3].real),
        ssh_alpha_im=t(ssh[0].imag) if complex_ssh else None,
        ssh_alpha2_im=t(ssh[1].imag) if complex_ssh else None,
        ssh_alpha3_im=t(ssh[2].imag) if complex_ssh else None,
        ssh_alpha4_im=t(ssh[3].imag) if complex_ssh else None,
        disp_Omega=t(_cat(disp_Omega)), disp_Omega4=t(_cat(disp_Omega4)),
        beta=float(beta), dtau=float(dtau), Ltau=Ltau, n_cells=n_cells, nphonon=nphonon,
        hol_to_phonon=_cat(hol_to_phonon, np.int32),
        hol_to_site=_cat(hol_to_site, np.int32),
        hol_ph_sym=_cat(hol_ph_sym, bool),
        ssh_to_phonon=np.stack([_cat(ssh_i, np.int32), _cat(ssh_f, np.int32)]),
        ssh_to_hop=_cat(ssh_to_hop, np.int32),
        disp_to_phonon=np.stack([_cat(disp_i, np.int32), _cat(disp_f, np.int32)]),
        frozen_mask=frozen_mask,
    )


ElectronPhononParameters.from_model = staticmethod(initialize_electron_phonon_parameters)
