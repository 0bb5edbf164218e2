"""Model definitions and the tutorial measurement set used by the port's
smoke run and tests, mirroring the JAX package's examples/_common.py."""

from __future__ import annotations

import numpy as np

from ..lattice import Bond, Lattice, ModelGeometry, UnitCell
from .electron_phonon import ElectronPhononModel, HolsteinCoupling, PhononMode
from .tight_binding import TightBindingModel
from ..measure.container import MeasurementSpec


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


def holstein_honeycomb_spec(geo) -> MeasurementSpec:
    """Measurement set of the holstein honeycomb tutorial
    (examples/_common.py:holstein_honeycomb_spec): greens and phonon greens
    time-displaced, density, pair and spin_z integrated, the tr_greens and
    cdw composites."""
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0), (1, 1), (0, 1)], time_displaced=True)
    spec.add_correlation("phonon_greens", [(0, 0), (1, 1), (0, 1)], time_displaced=True)
    spec.add_correlation("density", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("pair", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("spin_z", [(0, 0), (1, 1)], integrated=True)
    spec.add_composite_correlation(
        "tr_greens", "greens", id_pairs=[(0, 0), (1, 1)], coefficients=[1.0, 1.0],
        time_displaced=True,
    )
    spec.add_composite_correlation(
        "cdw", "density", ids=[0, 1], coefficients=[1.0, -1.0],
        displacement_vecs=[[0.0, 0.0], [0.0, 0.0]], integrated=True,
    )
    return spec


def complex_chain_model(L: int, t: float = 1.0, phase: float = 0.7, mu: float = 0.1, Omega: float = 1.0,
                        alpha: float = 0.5):
    """Periodic chain with the complex hopping t e^{i phase} (a threaded flux)
    and a Holstein coupling (tests/test_complex_hoppings.py:complex_chain_model,
    examples/holstein_flux_chain.py): one orbital per cell, one bond, one
    phonon mode. Returns (geometry, tight-binding model, electron-phonon
    model)."""
    geo = ModelGeometry(UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), Lattice(L=[L]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    tbm = TightBindingModel(geo, [bond], [t * np.exp(1j * phase)], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], Omega))
    em.add_holstein_coupling(HolsteinCoupling(p, 0, [0], alpha, ph_sym_form=True))
    return geo, tbm, em
