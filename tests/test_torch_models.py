"""Parity of the PyTorch port's host-side model layer with the JAX package.

Lattices, expanded parameters and path-integral arrays come from the same
NumPy code and draws in both packages, so they must agree exactly; the
Lambda shift matrix goes through exp(), computed by two libraries, so it is
held to 1e-14 relative.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, both_models, np64, t64

from smoqyelphqmc_tpu import lattice as jlattice
from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral as jbuild
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct
from smoqyelphqmc_tpu.ops.lambda_shift import build_lambda as jlambda
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch import lattice as plattice
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.lambda_shift import (
    build_lambda,
    ldiv_lambda,
    ldiv_lambda_T,
    mul_lambda,
    mul_lambda_T,
)

ALL_CASES = CASES + [pytest.param("honeycomb", dict(L=3, beta=0.5, ph_sym=False), id="honeycomb-noph")]


@pytest.mark.parametrize("name,kw", ALL_CASES)
def test_tight_binding_parameters_exact(name, kw):
    (_, _, jtbp, _, _), (_, _, ptbp, _, _) = both_models(name, **kw)
    np.testing.assert_array_equal(ptbp.t0.numpy(), np64(jtbp.t0))
    np.testing.assert_array_equal(ptbp.eps.numpy(), np64(jtbp.eps))
    assert float(ptbp.mu) == float(jtbp.mu)
    np.testing.assert_array_equal(ptbp.neighbor_table, np.asarray(jtbp.neighbor_table))
    assert ptbp.bond_slices == tuple(jtbp.bond_slices) and ptbp.n_sites == jtbp.n_sites


@pytest.mark.parametrize("name,kw", ALL_CASES)
def test_electron_phonon_parameters_exact(name, kw):
    (_, _, _, _, jelph), (_, _, _, _, pelph) = both_models(name, **kw)
    for f in ("x", "Omega", "Omega4", "mass", "hol_alpha", "hol_alpha2", "hol_alpha3", "hol_alpha4"):
        np.testing.assert_array_equal(getattr(pelph, f).numpy(), np64(getattr(jelph, f)), err_msg=f)
    for f in ("hol_to_phonon", "hol_to_site", "hol_ph_sym", "frozen_mask"):
        np.testing.assert_array_equal(getattr(pelph, f), np.asarray(getattr(jelph, f)), err_msg=f)
    assert (pelph.Ltau, pelph.n_cells, pelph.nphonon, pelph.beta, pelph.dtau) == (
        jelph.Ltau, jelph.n_cells, jelph.nphonon, jelph.beta, jelph.dtau)


def test_disorder_draws_exact():
    """Disordered hoppings, energies, frequencies and couplings consume the
    NumPy generator in the same order in both packages."""
    import smoqyelphqmc_tpu as J
    import smoqyelphqmc_tpu_torch as P

    def build(M, device_kw):
        geo = M.ModelGeometry(M.UnitCell([[1.0]], [[0.0]]), M.Lattice([5]))
        bond = M.Bond((0, 0), [1])
        tbm = M.TightBindingModel(geo, [bond], [1.0], [0.2], mu=0.3, t_std=[0.1], eps_std=[0.2])
        em = M.ElectronPhononModel(geo, tbm)
        p = em.add_phonon_mode(M.PhononMode([0.0], 1.2, Omega_std=0.1, Omega4_mean=0.05))
        em.add_holstein_coupling(M.HolsteinCoupling(p, 0, [0], 0.4, alpha_std=0.1, alpha2_mean=0.1,
                                                    ph_sym_form=True))
        rng = np.random.default_rng(3)
        tbp = M.TightBindingParameters.from_model(tbm, rng, **device_kw)
        return tbp, M.ElectronPhononParameters.from_model(0.6, 0.1, em, tbp, rng, **device_kw)

    jtbp, jelph = build(J, {})
    ptbp, pelph = build(P, {"device": "cpu"})
    np.testing.assert_array_equal(ptbp.t0.numpy(), np64(jtbp.t0))
    np.testing.assert_array_equal(ptbp.eps.numpy(), np64(jtbp.eps))
    for f in ("x", "Omega", "Omega4", "hol_alpha", "hol_alpha2"):
        np.testing.assert_array_equal(getattr(pelph, f).numpy(), np64(getattr(jelph, f)), err_msg=f)


@pytest.mark.parametrize("name,kw", ALL_CASES)
def test_path_integral_exact(name, kw):
    (_, _, jtbp, _, jelph), (_, _, ptbp, _, pelph) = both_models(name, **kw)
    x = 0.3 * np.random.default_rng(1).standard_normal(np64(jelph.x).shape)
    jf = jbuild(jtbp, jelph, x=jnp.asarray(x))
    pf = build_path_integral(ptbp, pelph, t64(x))
    np.testing.assert_array_equal(pf.V.numpy(), np64(jf.V))
    np.testing.assert_array_equal(pf.t.numpy(), np64(jf.t))
    assert pf.static_hops and jf.static_hops


@pytest.mark.parametrize("name,kw", ALL_CASES)
def test_checkerboard_structure_exact(name, kw):
    (jgeo, _, jtbp, _, _), (pgeo, _, ptbp, _, _) = both_models(name, **kw)
    js = jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites)
    ps = build_checkerboard_structure(ptbp.neighbor_table, ptbp.n_sites)
    for f in ("neighbor_table", "perm", "site_hop", "site_side", "partner"):
        np.testing.assert_array_equal(getattr(ps, f), getattr(js, f), err_msg=f)
    assert ps.color_slices == js.color_slices
    np.testing.assert_array_equal(pgeo.site_positions(), jgeo.site_positions())
    for b in jgeo.bonds:
        pb = plattice.Bond(b.orbitals, b.displacement)
        np.testing.assert_array_equal(pgeo.build_neighbor_table(pb), jgeo.build_neighbor_table(b))
    nt = np.asarray(jtbp.neighbor_table)
    jp, jc = jlattice.checkerboard_decomposition(nt)
    pp, pc = plattice.checkerboard_decomposition(nt)
    np.testing.assert_array_equal(pp, jp)
    assert all(np.array_equal(a, b) for a, b in zip(pc, jc))


@pytest.mark.parametrize("name,kw", ALL_CASES)
def test_lambda_shift_matches(name, kw):
    (_, _, jtbp, _, jelph), (_, _, ptbp, _, pelph) = both_models(name, **kw)
    x = 0.3 * np.random.default_rng(2).standard_normal(np64(jelph.x).shape)
    N = jtbp.n_sites
    jL = np64(jlambda(jelph, jnp.asarray(x), N))
    pL = build_lambda(pelph, t64(x), N)
    np.testing.assert_allclose(pL.numpy(), jL, rtol=1e-14, atol=0)
    v = np.random.default_rng(3).standard_normal((2,) + jL.shape)
    from smoqyelphqmc_tpu.ops import lambda_shift as jls

    for pf, jf in ((mul_lambda, jls.mul_lambda), (ldiv_lambda, jls.ldiv_lambda),
                   (mul_lambda_T, jls.mul_lambda_T), (ldiv_lambda_T, jls.ldiv_lambda_T)):
        got = pf(t64(jL), t64(v)).numpy()
        np.testing.assert_array_equal(got, np64(jf(jnp.asarray(jL), jnp.asarray(v))))


@pytest.mark.parametrize("name,kw", CASES)
def test_convert_carries_parameters(name, kw):
    """convert.py turns the JAX package's parameters into the port's, equal to
    the port's own expansion of the same model."""
    (_, _, jtbp, _, jelph), (_, _, ptbp, _, pelph) = both_models(name, **kw)
    ctbp = convert.tight_binding_parameters(jtbp)
    celph = convert.electron_phonon_parameters(jelph)
    np.testing.assert_array_equal(ctbp.t0.numpy(), ptbp.t0.numpy())
    np.testing.assert_array_equal(ctbp.neighbor_table, ptbp.neighbor_table)
    assert ctbp.bond_slices == ptbp.bond_slices
    for f in ("x", "Omega", "mass", "hol_alpha"):
        np.testing.assert_array_equal(getattr(celph, f).numpy(), getattr(pelph, f).numpy())
    np.testing.assert_array_equal(celph.hol_to_site, pelph.hol_to_site)
    assert celph.x.dtype == torch.float64


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads neither jax
    nor the JAX package."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import smoqyelphqmc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'smoqyelphqmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.') or k == 'smoqyelphqmc_tpu'"
        " or k.startswith('smoqyelphqmc_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(root), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
