"""The Holstein honeycomb of the reference package's tutorial
(tutorials/holstein_honeycomb.jl) as the plain reference's model: two
orbitals a cell, the three nearest-neighbour bonds (orbital 0 of cell c to
orbital 1 of cells c, c - a1 and c - a2, bond type by bond type, cells in C
order), one phonon mode a orbital coupled in the particle-hole symmetric
form, and the tutorial's Green's function pairs."""

from __future__ import annotations

import numpy as np

from benchmark.reference import ElPhModel

GREENS_PAIRS = ((0, 0), (1, 1), (0, 1))
BOND_DISPLACEMENTS = ((0, 0), (-1, 0), (0, -1))


def honeycomb_hops(L: int):
    """(neighbor table (2, 3 L^2), each hop's initial cell, each hop's final
    cell): orbital 0 of cell c to orbital 1 of cell c + d, for each bond
    displacement d in turn, cells in C order."""
    cells = np.stack(np.meshgrid(np.arange(L), np.arange(L), indexing="ij"), axis=-1).reshape(-1, 2)
    lin = cells[:, 0] * L + cells[:, 1]
    tables, finals = [], []
    for d in BOND_DISPLACEMENTS:
        f = (cells + np.asarray(d)) % L
        finals.append(f[:, 0] * L + f[:, 1])
        tables.append(np.stack([lin * 2, finals[-1] * 2 + 1]))
    return np.concatenate(tables, axis=1), np.tile(lin, len(BOND_DISPLACEMENTS)), np.concatenate(finals)


def build(config: dict) -> ElPhModel:
    L = int(config["L"])
    nt, initial, _ = honeycomb_hops(L)
    nc = L * L
    phonons = np.arange(2 * nc)
    return ElPhModel(
        neighbor_table=nt, t=np.full(nt.shape[1], float(config.get("t", 1.0))), eps=np.zeros(2 * nc),
        L=(L, L), n_orb=2, mass=np.ones(2 * nc), Omega=np.full(2 * nc, float(config["Omega"])), n_types=2,
        hol_phonon=phonons, hol_site=np.concatenate([initial[:nc] * 2, initial[:nc] * 2 + 1]),
        hol_alpha=np.full(2 * nc, float(config["alpha"])), hol_ph_sym=np.ones(2 * nc, dtype=bool),
    )
