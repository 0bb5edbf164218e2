"""The optical-SSH honeycomb of the reference package's example
(examples/ossh_honeycomb.jl) as the plain reference's model: the honeycomb's
two orbitals a cell and three nearest-neighbour bonds in the hop order of
`holstein_honeycomb`, one vibration mode on each sublattice (type 0 on
orbital 0, type 1 on orbital 1), and on every hop an SSH coupling of the
mode of its initial cell's sublattice A to the mode of its final cell's
sublattice B, t = t0 - alpha (x_B - x_A); the Green's function pairs are
the four orbital pairs of the example's measurement set."""

from __future__ import annotations

import numpy as np

from benchmark.reference import ElPhModel
from benchmark.references.holstein_honeycomb import honeycomb_hops

GREENS_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))


def build(config: dict) -> ElPhModel:
    L = int(config["L"])
    nt, initial, final = honeycomb_hops(L)
    nc = L * L
    n_hops = nt.shape[1]
    return ElPhModel(
        neighbor_table=nt, t=np.full(n_hops, float(config.get("t", 1.0))), eps=np.zeros(2 * nc),
        L=(L, L), n_orb=2, mass=np.ones(2 * nc), Omega=np.full(2 * nc, float(config["Omega"])), n_types=2,
        ssh_hop=np.arange(n_hops), ssh_phonon=np.stack([initial, nc + final]),
        ssh_alpha=np.full(n_hops, float(config["alpha"])),
    )
