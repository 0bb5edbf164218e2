"""Model definitions and measurement sets used by the port's smoke run and
tests, copies of the JAX package's examples/_common.py (the Holstein
honeycomb tutorial, the five SSH examples and their `basic_spec`)."""

from __future__ import annotations

import numpy as np

from ..lattice import Bond, Lattice, ModelGeometry, UnitCell
from .electron_phonon import ElectronPhononModel, HolsteinCoupling, PhononMode, SSHCoupling
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


def chain_geometry(L: int):
    """Periodic chain, one orbital a cell and its nearest-neighbour bond."""
    geo = ModelGeometry(UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), Lattice(L=[L], periodic=[True]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    return geo, bond


def square_geometry(L: int):
    """Periodic L x L square lattice, one orbital a cell and its x and y bonds."""
    geo = ModelGeometry(UnitCell(lattice_vecs=[[1.0, 0.0], [0.0, 1.0]], basis_vecs=[[0.0, 0.0]]),
                        Lattice(L=[L, L], periodic=[True, True]))
    bx, by = Bond(orbitals=(0, 0), displacement=[1, 0]), Bond(orbitals=(0, 0), displacement=[0, 1])
    geo.add_bond(bx)
    geo.add_bond(by)
    return geo, (bx, by)


def bssh_chain_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Bond-SSH chain: a live phonon on each bond and a frozen reference mode,
    so the hopping is t - alpha X."""
    geo, bond = chain_geometry(L)
    tbm = TightBindingModel(geo, [bond], [t], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    live = em.add_phonon_mode(PhononMode([0.5], Omega))
    frozen = em.add_phonon_mode(PhononMode([0.0], Omega, M=np.inf))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(frozen, live), bond=bond, alpha_mean=alpha))
    return geo, tbm, em


def bssh_square_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Bond-SSH square lattice: x and y bond phonons and one frozen mode."""
    geo, (bx, by) = square_geometry(L)
    tbm = TightBindingModel(geo, [bx, by], [t, t], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    px = em.add_phonon_mode(PhononMode([0.5, 0.0], Omega))
    py = em.add_phonon_mode(PhononMode([0.0, 0.5], Omega))
    frozen = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega, M=np.inf))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(frozen, px), bond=bx, alpha_mean=alpha))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(frozen, py), bond=by, alpha_mean=alpha))
    return geo, tbm, em


def ossh_chain_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Optical-SSH chain: the phonon on each site modulates the bond it
    starts, coupling alpha (X_{i+1} - X_i)."""
    geo, bond = chain_geometry(L)
    tbm = TightBindingModel(geo, [bond], [t], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], Omega))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=alpha))
    return geo, tbm, em


def ossh_square_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Optical-SSH square lattice: x- and y-vibration modes on each site."""
    geo, (bx, by) = square_geometry(L)
    tbm = TightBindingModel(geo, [bx, by], [t, t], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    px = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega))
    py = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(px, px), bond=bx, alpha_mean=alpha))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(py, py), bond=by, alpha_mean=alpha))
    return geo, tbm, em


def ossh_honeycomb_model(L: int, Omega: float, alpha: float, mu: float, t: float = 1.0):
    """Optical-SSH honeycomb: a vibration mode on each sublattice, coupled
    along the three nearest-neighbour bonds. Returns (geometry, tight-binding
    model, electron-phonon model)."""
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
    pAx = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega))
    pBx = em.add_phonon_mode(PhononMode([1.0, 0.0], Omega))
    for b in bonds:
        em.add_ssh_coupling(SSHCoupling(phonon_ids=(pAx, pBx), bond=b, alpha_mean=alpha))
    return geo, tbm, em


def basic_spec(geo, bond_ids=()) -> MeasurementSpec:
    """Measurement set of the SSH examples: greens, phonon greens, density,
    pair, spin_z, and bond and current correlations on the hopping bonds."""
    spec = MeasurementSpec(geometry=geo)
    orb_pairs = [(a, b) for a in range(geo.n_orbitals) for b in range(geo.n_orbitals)]
    diag_pairs = [(a, a) for a in range(geo.n_orbitals)]
    spec.add_correlation("greens", orb_pairs, time_displaced=True)
    spec.add_correlation("phonon_greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", diag_pairs, integrated=True)
    spec.add_correlation("pair", diag_pairs, integrated=True)
    spec.add_correlation("spin_z", diag_pairs, integrated=True)
    for bid in bond_ids:
        spec.add_correlation("bond", [(bid, bid)], integrated=True)
        spec.add_correlation("current", [(bid, bid)], integrated=True)
    return spec


def ossh_honeycomb_spec(geo, bond_ids=()) -> MeasurementSpec:
    """Measurement set of the reference package's examples/ossh_honeycomb.jl:
    `basic_spec` on the given bonds (the example measures all three)."""
    return basic_spec(geo, bond_ids)
