"""The port's mirrors of tests/_models.py (no jax import, so that worker
processes of the fleet tests start quickly): the same models built in the
PyTorch port from the same NumPy seed."""

import numpy as np

from smoqyelphqmc_tpu_torch import (
    Bond,
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    Lattice,
    ModelGeometry,
    PhononMode,
    TightBindingModel,
    TightBindingParameters,
    UnitCell,
)


def port_chain_model(L=4, t=1.0, mu=0.1, Omega=1.0, alpha=0.5, beta=1.0, dtau=0.1, seed=0):
    """Port mirror of _models.chain_model (Holstein coupling)."""
    geo = ModelGeometry(UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), Lattice(L=[L], periodic=[True]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    tbm = TightBindingModel(model_geometry=geo, t_bonds=[bond], t_mean=[t], eps_mean=[0.0], mu=mu)
    em = ElectronPhononModel(model_geometry=geo, tight_binding_model=tbm)
    pid = em.add_phonon_mode(PhononMode(basis_vec=[0.0], Omega_mean=Omega))
    em.add_holstein_coupling(
        HolsteinCoupling(phonon_id=pid, orbital_id=0, displacement=[0], alpha_mean=alpha, ph_sym_form=True)
    )
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, device="cpu")
    return geo, tbm, tbp, em, elph


def port_honeycomb_model(L=2, t=1.0, mu=0.0, Omega=1.0, alpha=0.5, beta=1.0, dtau=0.1, seed=0, ph_sym=True):
    """Port mirror of _models.honeycomb_model."""
    a1 = [1.5, np.sqrt(3) / 2]
    a2 = [1.5, -np.sqrt(3) / 2]
    geo = ModelGeometry(UnitCell(lattice_vecs=[a1, a2], basis_vecs=[[0.0, 0.0], [1.0, 0.0]]),
                        Lattice(L=[L, L], periodic=[True, True]))
    bonds = [Bond(orbitals=(0, 1), displacement=[0, 0]), Bond(orbitals=(0, 1), displacement=[-1, 0]),
             Bond(orbitals=(0, 1), displacement=[0, -1])]
    for b in bonds:
        geo.add_bond(b)
    tbm = TightBindingModel(model_geometry=geo, t_bonds=bonds, t_mean=[t, t, t], eps_mean=[0.0, 0.0], mu=mu)
    em = ElectronPhononModel(model_geometry=geo, tight_binding_model=tbm)
    p1 = em.add_phonon_mode(PhononMode(basis_vec=[0.0, 0.0], Omega_mean=Omega))
    p2 = em.add_phonon_mode(PhononMode(basis_vec=[1.0, 0.0], Omega_mean=Omega))
    em.add_holstein_coupling(HolsteinCoupling(phonon_id=p1, orbital_id=0, displacement=[0, 0], alpha_mean=alpha,
                                              ph_sym_form=ph_sym))
    em.add_holstein_coupling(HolsteinCoupling(phonon_id=p2, orbital_id=1, displacement=[0, 0], alpha_mean=alpha,
                                              ph_sym_form=ph_sym))
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, device="cpu")
    return geo, tbm, tbp, em, elph
