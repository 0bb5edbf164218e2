"""Tight-binding model definition and lattice-expanded parameters.

Port of smoqyelphqmc_tpu/models/tight_binding.py. The host-side expansion is the
same NumPy code driven by the same `np.random.Generator`, so the expanded arrays
are bit-identical; they are then placed on `device` as float64 tensors.
Complex hoppings are not ported yet (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..lattice import Bond, ModelGeometry


@dataclasses.dataclass(frozen=True)
class TightBindingModel:
    """Translationally-invariant tight-binding model definition (same fields and
    constructor as the JAX package's TightBindingModel)."""

    model_geometry: ModelGeometry
    t_bonds: Tuple[Bond, ...]
    t_mean: Tuple[complex, ...]
    eps_mean: Tuple[float, ...]
    mu: float = 0.0
    t_std: Tuple[float, ...] | None = None
    eps_std: Tuple[float, ...] | None = None

    def __init__(
        self,
        model_geometry: ModelGeometry,
        t_bonds: Sequence[Bond],
        t_mean: Sequence[complex],
        eps_mean: Sequence[float],
        mu: float = 0.0,
        t_std: Sequence[float] | None = None,
        eps_std: Sequence[float] | None = None,
    ):
        object.__setattr__(self, "model_geometry", model_geometry)
        object.__setattr__(self, "t_bonds", tuple(t_bonds))
        object.__setattr__(self, "t_mean", tuple(t_mean))
        object.__setattr__(self, "eps_mean", tuple(float(e) for e in eps_mean))
        object.__setattr__(self, "mu", float(mu))
        object.__setattr__(self, "t_std", None if t_std is None else tuple(float(s) for s in t_std))
        object.__setattr__(self, "eps_std", None if eps_std is None else tuple(float(s) for s in eps_std))
        if len(self.t_bonds) != len(self.t_mean):
            raise ValueError("t_bonds and t_mean differ in length")
        if len(self.eps_mean) != model_geometry.n_orbitals:
            raise ValueError("eps_mean needs one entry per orbital")
        bond_ids = tuple(model_geometry.add_bond(b) for b in self.t_bonds)
        object.__setattr__(self, "bond_ids", bond_ids)

    bond_ids: Tuple[int, ...] = dataclasses.field(init=False, default=())


@dataclasses.dataclass
class TightBindingParameters:
    """Lattice-expanded tight-binding parameters.

    Hoppings are bond-type-major (hop h = bond_type * n_cells + cell) with
    `neighbor_table` (2, n_hops) kept as host NumPy metadata."""

    t0: torch.Tensor  # (n_hops,) float64
    eps: torch.Tensor  # (n_sites,) float64
    mu: torch.Tensor  # () float64
    neighbor_table: np.ndarray  # (2, n_hops) int32
    bond_ids: Tuple[int, ...]
    bond_slices: Tuple[Tuple[int, int], ...]
    n_sites: int
    n_orbitals: int

    @property
    def n_hops(self) -> int:
        return self.neighbor_table.shape[1]


def initialize_tight_binding_parameters(
    tight_binding_model: TightBindingModel,
    rng: np.random.Generator | None = None,
    device: torch.device | str = "cpu",
) -> TightBindingParameters:
    """Expand a TightBindingModel onto the finite lattice, sampling disorder
    (the same draws, in the same order, as the JAX package)."""
    geo = tight_binding_model.model_geometry
    if rng is None:
        rng = np.random.default_rng(0)
    if any(np.imag(t) != 0 for t in tight_binding_model.t_mean):
        raise NotImplementedError(
            "complex hoppings are not ported yet (ROADMAP Queue 1, item 14)"
        )

    n_cells = geo.n_cells
    tables: List[np.ndarray] = []
    t_vals: List[np.ndarray] = []
    bond_slices: List[Tuple[int, int]] = []
    start = 0
    for b, bond in enumerate(tight_binding_model.t_bonds):
        tables.append(geo.build_neighbor_table(bond))
        tm = np.full(n_cells, float(np.real(tight_binding_model.t_mean[b])), dtype=np.float64)
        if tight_binding_model.t_std is not None and tight_binding_model.t_std[b] > 0:
            tm = tm + tight_binding_model.t_std[b] * rng.standard_normal(n_cells)
        tm[geo.bond_wrap_mask(bond)] = 0.0
        t_vals.append(tm)
        bond_slices.append((start, start + n_cells))
        start += n_cells

    neighbor_table = np.concatenate(tables, axis=1) if tables else np.zeros((2, 0), dtype=np.int32)
    t0 = np.concatenate(t_vals) if t_vals else np.zeros(0, dtype=np.float64)

    eps = np.empty(geo.n_sites, dtype=np.float64)
    eps_mean = np.asarray(tight_binding_model.eps_mean)
    for orb in range(geo.n_orbitals):
        vals = np.full(n_cells, eps_mean[orb])
        if tight_binding_model.eps_std is not None and tight_binding_model.eps_std[orb] > 0:
            vals = vals + tight_binding_model.eps_std[orb] * rng.standard_normal(n_cells)
        eps[orb :: geo.n_orbitals] = vals

    f64 = torch.float64
    return TightBindingParameters(
        t0=torch.as_tensor(t0, dtype=f64, device=device),
        eps=torch.as_tensor(eps, dtype=f64, device=device),
        mu=torch.tensor(tight_binding_model.mu, dtype=f64, device=device),
        neighbor_table=neighbor_table.astype(np.int32),
        bond_ids=tuple(tight_binding_model.bond_ids),
        bond_slices=tuple(bond_slices),
        n_sites=geo.n_sites,
        n_orbitals=geo.n_orbitals,
    )


TightBindingParameters.from_model = staticmethod(initialize_tight_binding_parameters)
