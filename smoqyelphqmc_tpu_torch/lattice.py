"""Lattice geometry layer (host-side, NumPy); a copy of the JAX package's lattice.py.

Provides the capability surface of LatticeUtilities as consumed by the reference
(see SmoQyElPhQMC.jl tutorials/holstein_honeycomb.jl:146-185 and SURVEY.md section 2b):
`UnitCell`, `Lattice`, `Bond`, `ModelGeometry`, `add_bond`, `nsites`.

Conventions (0-indexed, NumPy row-major; differs from the Julia reference's 1-indexed
column-major layout but is bit-equivalent in content):

- unit cells are indexed by a D-tuple `i = (i_0, ..., i_{D-1})`, flattened C-order;
- a site is `(cell, orbital)` with flat index `site = cell_linear * n_orb + orbital`;
  a space-time field of shape (Ltau, *L, n_orb) reshapes to (Ltau, Nsites);
- a `Bond` connects orbital `orbitals[0]` in cell `i` (initial site) to orbital
  `orbitals[1]` in cell `i + displacement` (final site), mirroring the reference's
  neighbor-table convention (initial row 1 / final row 2,
  SmoQyElPhQMC.jl src/Measurements/tight_binding_measurements.jl:108-116).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class UnitCell:
    """Unit cell: lattice vectors (n_dim of them) and orbital basis vectors."""

    lattice_vecs: Tuple[Tuple[float, ...], ...]
    basis_vecs: Tuple[Tuple[float, ...], ...]

    def __init__(self, lattice_vecs: Sequence[Sequence[float]], basis_vecs: Sequence[Sequence[float]]):
        object.__setattr__(self, "lattice_vecs", tuple(tuple(float(x) for x in v) for v in lattice_vecs))
        object.__setattr__(self, "basis_vecs", tuple(tuple(float(x) for x in v) for v in basis_vecs))

    @property
    def n_dim(self) -> int:
        return len(self.lattice_vecs)

    @property
    def n_orbitals(self) -> int:
        return len(self.basis_vecs)

    @property
    def lattice_vec_matrix(self) -> np.ndarray:
        """(D, D) matrix whose rows are the lattice vectors."""
        return np.asarray(self.lattice_vecs, dtype=np.float64)

    @property
    def reciprocal_vec_matrix(self) -> np.ndarray:
        """(D, D) matrix whose rows are the reciprocal lattice vectors b_i, a_i.b_j = 2 pi delta_ij."""
        return 2.0 * np.pi * np.linalg.inv(self.lattice_vec_matrix).T


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Finite lattice: extent L per dimension and periodicity flags."""

    L: Tuple[int, ...]
    periodic: Tuple[bool, ...]

    def __init__(self, L: Sequence[int], periodic: Sequence[bool] | None = None):
        L = tuple(int(x) for x in L)
        if periodic is None:
            periodic = tuple(True for _ in L)
        object.__setattr__(self, "L", L)
        object.__setattr__(self, "periodic", tuple(bool(p) for p in periodic))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.L))


@dataclasses.dataclass(frozen=True)
class Bond:
    """Directed bond: orbital pair (initial, final) and unit-cell displacement."""

    orbitals: Tuple[int, int]
    displacement: Tuple[int, ...]

    def __init__(self, orbitals: Sequence[int], displacement: Sequence[int]):
        object.__setattr__(self, "orbitals", (int(orbitals[0]), int(orbitals[1])))
        object.__setattr__(self, "displacement", tuple(int(d) for d in displacement))


def nsites(unit_cell: UnitCell, lattice: Lattice) -> int:
    return unit_cell.n_orbitals * lattice.n_cells


def cell_linear_indices(L: Tuple[int, ...]) -> np.ndarray:
    """(n_cells, D) integer cell coordinates in C-order flattening."""
    grids = np.meshgrid(*[np.arange(l) for l in L], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


class ModelGeometry:
    """Registry of the lattice geometry and the bond definitions used by the model.

    Mirrors the role of SmoQyDQMC.ModelGeometry + add_bond! as used by the reference
    tutorials (SmoQyElPhQMC.jl tutorials/holstein_honeycomb.jl:167-185).
    """

    def __init__(self, unit_cell: UnitCell, lattice: Lattice):
        self.unit_cell = unit_cell
        self.lattice = lattice
        self.bonds: List[Bond] = []
        # trivial bond ids for each orbital (used by correlation bookkeeping): the
        # "bond" from an orbital to itself with zero displacement.
        for orb in range(unit_cell.n_orbitals):
            self.bonds.append(Bond((orb, orb), (0,) * unit_cell.n_dim))

    @property
    def n_dim(self) -> int:
        return self.unit_cell.n_dim

    @property
    def n_orbitals(self) -> int:
        return self.unit_cell.n_orbitals

    @property
    def n_cells(self) -> int:
        return self.lattice.n_cells

    @property
    def n_sites(self) -> int:
        return nsites(self.unit_cell, self.lattice)

    @property
    def L(self) -> Tuple[int, ...]:
        return self.lattice.L

    def add_bond(self, bond: Bond) -> int:
        """Register a bond definition, returning its bond id (deduplicated)."""
        for i, b in enumerate(self.bonds):
            if b == bond:
                return i
        self.bonds.append(bond)
        return len(self.bonds) - 1

    def bond(self, bond_id: int) -> Bond:
        return self.bonds[bond_id]

    def site_index(self, cell: Sequence[int], orbital: int) -> int:
        """Flat site index for a cell coordinate + orbital."""
        lin = int(np.ravel_multi_index([c % l for c, l in zip(cell, self.L)], self.L))
        return lin * self.n_orbitals + orbital

    def build_neighbor_table(self, bond: Bond) -> np.ndarray:
        """(2, n_cells) neighbor table for one bond type.

        Row 0 = initial site (orbital[0] in cell i), row 1 = final site
        (orbital[1] in cell i + displacement), one column per unit cell i in
        C-order. Wrapping is applied per dimension; for NON-periodic dimensions
        the wrapped columns keep their (wrapped) indices so every bond type has
        a static n_cells hops, and the expansion layers zero their amplitudes
        (see bond_wrap_mask)."""
        L = self.L
        cells = cell_linear_indices(L)  # (n_cells, D)
        o_i, o_f = bond.orbitals
        disp = np.asarray(bond.displacement, dtype=np.int64)
        cells_f = (cells + disp[None, :]) % np.asarray(L, dtype=np.int64)[None, :]
        lin_i = np.ravel_multi_index(cells.T, L)
        lin_f = np.ravel_multi_index(cells_f.T, L)
        table = np.stack([lin_i * self.n_orbitals + o_i, lin_f * self.n_orbitals + o_f], axis=0)
        return table.astype(np.int32)

    def bond_wrap_mask(self, bond: Bond) -> np.ndarray:
        """(n_cells,) bool: True where the bond leaves the lattice through a
        NON-periodic boundary (open boundary conditions: those hops carry zero
        amplitude and no coupling — LatticeUtilities' open-BC capability with
        static array shapes)."""
        L = self.L
        cells = cell_linear_indices(L)  # (n_cells, D)
        disp = np.asarray(bond.displacement, dtype=np.int64)
        raw = cells + disp[None, :]
        wrapped = np.zeros(cells.shape[0], dtype=bool)
        for d, (l, per) in enumerate(zip(L, self.lattice.periodic)):
            if not per:
                wrapped |= (raw[:, d] < 0) | (raw[:, d] >= l)
        return wrapped

    def displacement_wrap_mask(self, displacement, orbital: int = 0) -> np.ndarray:
        """(n_cells,) bool wrap mask for a raw displacement (Holstein couplings
        reaching across an open boundary)."""
        return self.bond_wrap_mask(Bond(orbitals=(orbital, orbital), displacement=list(displacement)))

    def site_positions(self) -> np.ndarray:
        """(n_sites, D) real-space positions of every site."""
        cells = cell_linear_indices(self.L).astype(np.float64)  # (n_cells, D)
        A = self.unit_cell.lattice_vec_matrix  # rows are lattice vectors
        basis = np.asarray(self.unit_cell.basis_vecs, dtype=np.float64)  # (n_orb, D)
        pos = cells @ A  # (n_cells, D)
        return (pos[:, None, :] + basis[None, :, :]).reshape(self.n_sites, self.n_dim)


def checkerboard_decomposition(neighbor_table: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Greedy edge coloring of the hopping graph into non-overlapping groups.

    TPU-native re-design of Checkerboard.jl's `checkerboard_decomposition!`
    (used at SmoQyElPhQMC.jl src/FermionDetMatrix.jl:96): hoppings are partitioned
    into "colors" such that within a color no site appears twice, so all 2x2 hop
    rotations of a color commute and can be applied as one vectorized
    gather + elementwise kernel.

    Args:
      neighbor_table: (2, n_hops) int array of site pairs.

    Returns:
      perm: (n_hops,) permutation such that hop `perm[k]` is the k-th hop in
        color-sorted order (mirrors the reference's checkerboard_perm: the
        permuted table is `neighbor_table[:, perm]`).
      colors: list of arrays of positions (into the permuted order) covered by
        each color, as contiguous ranges.
    """
    n_hops = neighbor_table.shape[1]
    color_of = np.full(n_hops, -1, dtype=np.int64)
    colors_members: List[List[int]] = []
    colors_sites: List[set] = []
    for h in range(n_hops):
        i, j = int(neighbor_table[0, h]), int(neighbor_table[1, h])
        placed = False
        for c, sites in enumerate(colors_sites):
            if i not in sites and j not in sites:
                sites.add(i)
                sites.add(j)
                colors_members[c].append(h)
                color_of[h] = c
                placed = True
                break
        if not placed:
            colors_sites.append({i, j})
            colors_members.append([h])
            color_of[h] = len(colors_members) - 1
    perm = np.concatenate([np.asarray(m, dtype=np.int64) for m in colors_members]) if n_hops else np.zeros(0, np.int64)
    colors: List[np.ndarray] = []
    start = 0
    for m in colors_members:
        colors.append(np.arange(start, start + len(m), dtype=np.int64))
        start += len(m)
    return perm, colors
