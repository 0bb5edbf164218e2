"""Model definitions used by the port's smoke run and tests, mirroring the
JAX package's examples/_common.py."""

from __future__ import annotations

import numpy as np

from ..lattice import Bond, Lattice, ModelGeometry, UnitCell
from .electron_phonon import ElectronPhononModel, HolsteinCoupling, PhononMode
from .tight_binding import TightBindingModel


def holstein_honeycomb_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Honeycomb Holstein model (examples/_common.py:holstein_honeycomb_model):
    two orbitals per cell, three nearest-neighbour bonds, one phonon mode per
    orbital. Returns (geometry, tight-binding model, electron-phonon model)."""
    uc = UnitCell(
        lattice_vecs=[[1.5, np.sqrt(3) / 2], [1.5, -np.sqrt(3) / 2]],
        basis_vecs=[[0.0, 0.0], [1.0, 0.0]],
    )
    geo = ModelGeometry(uc, Lattice(L=[L, L], periodic=[True, True]))
    bonds = [
        Bond(orbitals=(0, 1), displacement=[0, 0]),
        Bond(orbitals=(0, 1), displacement=[-1, 0]),
        Bond(orbitals=(0, 1), displacement=[0, -1]),
    ]
    for b in bonds:
        geo.add_bond(b)
    tbm = TightBindingModel(geo, bonds, [t, t, t], [0.0, 0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p1 = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega))
    p2 = em.add_phonon_mode(PhononMode([1.0, 0.0], Omega))
    em.add_holstein_coupling(HolsteinCoupling(p1, 0, [0, 0], alpha, ph_sym_form=True))
    em.add_holstein_coupling(HolsteinCoupling(p2, 1, [0, 0], alpha, ph_sym_form=True))
    return geo, tbm, em
