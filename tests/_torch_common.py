"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same small models are built in both packages from the same NumPy seed
(tests/_models.py for the JAX package, its mirrors in tests/_torch_models.py
for the port); arrays cross between the packages as numpy arrays with an
explicit dtype."""

import numpy as np
import pytest
import torch

from _models import chain_model, honeycomb_model
from _torch_models import port_chain_model, port_honeycomb_model

# the tier-1 gate runs 6 xdist workers on 8 cores
torch.set_num_threads(2)


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


def permuted_neighbor_table(neighbor_table, n_sites: int, seed: int) -> np.ndarray:
    """The hopping graph with its site labels permuted by a seeded permutation:
    an irregular partner map (more than 8 lane-shift classes per color)."""
    perm = np.random.default_rng(seed).permutation(n_sites)
    return perm[np.asarray(neighbor_table)].astype(np.int32)


def fdm_pair(name, kw, x_seed=None, symmetric=True, perm_seed=None):
    """JAX and port fermion matrices of one model at one field (the model's
    initial field, or a field from `x_seed`), both float64; `perm_seed`
    relabels the sites of the hopping graph (permuted_neighbor_table)."""
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
    nt = np.asarray(ptbp.neighbor_table)
    if perm_seed is not None:
        nt = permuted_neighbor_table(nt, ptbp.n_sites, perm_seed)
    jfdm = JFdm.from_path_integral(jbuild(jtbp, jelph, x=jnp.asarray(x)), jstruct(nt, jtbp.n_sites),
                                   symmetric=symmetric)
    pfdm = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(x)),
                                               build_checkerboard_structure(nt, ptbp.n_sites), symmetric=symmetric)
    return jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), x
