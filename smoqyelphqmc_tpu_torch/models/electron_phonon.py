"""Electron-phonon model definition and lattice-expanded parameters.

Port of smoqyelphqmc_tpu/models/electron_phonon.py for the couplings of this
slice: phonon modes (with disorder, anharmonic Omega4 and frozen modes) and
Holstein couplings. SSH and dispersion couplings are not ported yet (ROADMAP
Queue 1, item 15). Layouts are the JAX package's: type-major
(index = type * n_cells + cell), x shaped (n_phonon, Ltau).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..lattice import ModelGeometry, cell_linear_indices
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


class ElectronPhononModel:
    """Registry of phonon modes and Holstein couplings."""

    def __init__(self, model_geometry: ModelGeometry, tight_binding_model: TightBindingModel):
        self.model_geometry = model_geometry
        self.tight_binding_model = tight_binding_model
        self.phonon_modes: List[PhononMode] = []
        self.holstein_couplings: List[HolsteinCoupling] = []

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


_FLOAT_FIELDS = ("x", "Omega", "Omega4", "mass", "hol_alpha", "hol_alpha2", "hol_alpha3", "hol_alpha4")


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
    beta: float
    dtau: float
    Ltau: int
    n_cells: int
    nphonon: int
    hol_to_phonon: np.ndarray  # (n_holstein,) int32
    hol_to_site: np.ndarray  # (n_holstein,) int32
    hol_ph_sym: np.ndarray  # (n_holstein,) bool
    frozen_mask: np.ndarray  # (n_phonon,) bool

    def __post_init__(self):
        dev = self.x.device
        self.hol_to_phonon_t = torch.as_tensor(self.hol_to_phonon, dtype=torch.long, device=dev)
        self.hol_to_site_t = torch.as_tensor(self.hol_to_site, dtype=torch.long, device=dev)

    @property
    def n_phonon(self) -> int:
        return self.nphonon * self.n_cells

    @property
    def n_holstein(self) -> int:
        return self.hol_to_phonon.shape[0]

    @property
    def n_ssh(self) -> int:
        return 0

    @property
    def n_dispersion(self) -> int:
        return 0

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to_dtype(self, dtype: torch.dtype) -> "ElectronPhononParameters":
        """Copy with every float tensor cast (the f32 force path, ops/pff.py)."""
        return dataclasses.replace(self, **{f: getattr(self, f).to(dtype) for f in _FLOAT_FIELDS})


def _expand(mean: float, std: float, n: int, rng: np.random.Generator) -> np.ndarray:
    vals = np.full(n, mean, dtype=np.float64)
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
    device: torch.device | str = "cpu",
) -> ElectronPhononParameters:
    """Expand the model onto the lattice and sample the initial field (the same
    draws, in the same order, as the JAX package for Holstein models)."""
    if rng is None:
        rng = np.random.default_rng(0)
    geo = electron_phonon_model.model_geometry
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

    alphas: List[List[np.ndarray]] = [[], [], [], []]
    hol_to_phonon, hol_to_site, hol_ph_sym = [], [], []
    cells = cell_linear_indices(geo.L)
    Lvec = np.asarray(geo.L, dtype=np.int64)
    for hc in electron_phonon_model.holstein_couplings:
        keep = ~geo.displacement_wrap_mask(hc.displacement)
        for k, (mean, std) in enumerate([(hc.alpha_mean, hc.alpha_std), (hc.alpha2_mean, hc.alpha2_std),
                                         (hc.alpha3_mean, hc.alpha3_std), (hc.alpha4_mean, hc.alpha4_std)]):
            alphas[k].append(_expand(mean, std, n_cells, rng) * keep)
        cell_lin = np.arange(n_cells)
        hol_to_phonon.append(hc.phonon_id * n_cells + cell_lin)
        tgt = (cells + np.asarray(hc.displacement, dtype=np.int64)[None, :]) % Lvec[None, :]
        hol_to_site.append(np.ravel_multi_index(tgt.T, geo.L) * geo.n_orbitals + hc.orbital_id)
        hol_ph_sym.append(np.full(n_cells, hc.ph_sym_form, dtype=bool))

    def _cat(lst, dtype=np.float64):
        return np.concatenate(lst).astype(dtype) if lst else np.zeros(0, dtype=dtype)

    if x_init is None:
        x_init = np.zeros((n_phonon, Ltau))
        if n_phonon:
            finite = np.isfinite(mass) & (Omega > 0)
            sigma = np.zeros(n_phonon)
            sigma[finite] = 1.0 / np.sqrt(2.0 * mass[finite] * Omega[finite])
            x_init = sigma[:, None] * rng.standard_normal((n_phonon, Ltau))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, device=device)

    return ElectronPhononParameters(
        x=t(x_init), Omega=t(Omega), Omega4=t(Omega4), mass=t(mass),
        hol_alpha=t(_cat(alphas[0])), hol_alpha2=t(_cat(alphas[1])),
        hol_alpha3=t(_cat(alphas[2])), hol_alpha4=t(_cat(alphas[3])),
        beta=float(beta), dtau=float(dtau), Ltau=Ltau, n_cells=n_cells, nphonon=nphonon,
        hol_to_phonon=_cat(hol_to_phonon, np.int32),
        hol_to_site=_cat(hol_to_site, np.int32),
        hol_ph_sym=_cat(hol_ph_sym, bool),
        frozen_mask=frozen_mask,
    )


ElectronPhononParameters.from_model = staticmethod(initialize_electron_phonon_parameters)
