"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same small models are built in both packages from the same NumPy seed
(tests/_models.py for the JAX package, the mirrors below for the port); arrays
cross between the packages as numpy arrays with an explicit dtype."""

import numpy as np
import pytest
import torch

from _models import chain_model, honeycomb_model
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

# the tier-1 gate runs 6 xdist workers on 8 cores
torch.set_num_threads(2)


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
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
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
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    return geo, tbm, tbp, em, elph


MODEL_FNS = {"chain": (chain_model, port_chain_model), "honeycomb": (honeycomb_model, port_honeycomb_model)}

# (model, kwargs) cases shared by the parity tests: chain L=6 and honeycomb L=2
CASES = [
    pytest.param("chain", dict(L=6, beta=0.8, alpha=0.4), id="chain"),
    pytest.param("honeycomb", dict(L=2, beta=0.6, alpha=0.3), id="honeycomb"),
]


def both_models(name, **kw):
    """(jax_model_tuple, port_model_tuple) built from the same arguments."""
    jax_fn, port_fn = MODEL_FNS[name]
    return jax_fn(**kw), port_fn(**kw)


def np64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64)


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=torch.float64)


def t32(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), dtype=torch.float32)


def fdm_pair(name, kw, x_seed=None, symmetric=True):
    """JAX and port fermion matrices of one model at one field (the model's
    initial field, or a field from `x_seed`), both float64."""
    import jax.numpy as jnp

    from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral as jbuild
    from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct
    from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix as JFdm
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix

    (jg, jtbm, jtbp, jem, jelph), (pg, ptbm, ptbp, pem, pelph) = both_models(name, **kw)
    x = np64(jelph.x)
    if x_seed is not None:
        x = 0.3 * np.random.default_rng(x_seed).standard_normal(x.shape)
    jfdm = JFdm.from_path_integral(jbuild(jtbp, jelph, x=jnp.asarray(x)),
                                   jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites), symmetric=symmetric)
    pfdm = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(x)),
                                               build_checkerboard_structure(ptbp.neighbor_table, ptbp.n_sites),
                                               symmetric=symmetric)
    return jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), x
