"""Parity of the port's measurements with the JAX package: the estimator's
transforms, its refresh fed the JAX package's phases, the single-particle
Green's function, the three pair topologies, every correlation kind and the
whole measurement tree, with R and GR carried across by
`convert.greens_estimator`.

Tolerances: the transforms are exact up to f64 rounding (1e-12 of the
input scale); the f32 estimator refresh is an f32 PCG solve at tol 2e-5 in
both packages (bf16 preconditioner in K2's plain version, f32 in the JAX XLA
path), held at rtol 2e-4 / atol 2e-5 of max|GR| (tests/test_pallas.py:96),
the f64 mixed refresh at 1e-8 (test_pallas.py:276); measurements of the same
R and GR agree to 1e-10 of each output's largest magnitude in f64, and to
1e-5 of it in f32 (f32 products summed over up to ~10^3 terms, through the
JAX package's DFT matmuls against pocketfft; measured 3.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, both_models, np64, t64

from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.measure.scalar import measure_double_occ as jdocc
from smoqyelphqmc_tpu.measure.scalar import measure_n as jn
from smoqyelphqmc_tpu.measure.scalar import measure_Nsqrd as jnsq
from smoqyelphqmc_tpu.updates.context import initialize_qmc as jinit
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.measure import container as pcontainer
from smoqyelphqmc_tpu_torch.measure import greens_estimator as pge
from smoqyelphqmc_tpu_torch.measure.scalar import measure_double_occ, measure_n, measure_Nsqrd
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm

torch.set_num_threads(2)

TOL = {"float64": 1e-10, "float32": 1e-5}
DTYPES = [pytest.param("float64", id="f64"), pytest.param("float32", id="f32")]
NRV = 4


def _chains(name, kw):
    """JAX and port contexts and states of one model, the port's built from
    the JAX package's expanded parameters."""
    (jg, _, jtbp, _, jelph), (pg, *_) = both_models(name, **kw)
    jctx, jstate = jinit(jtbp, jelph, seed=0, tol=1e-10)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, "cpu"),
                                  convert.electron_phonon_parameters(jelph, "cpu"))
    return jg, pg, jctx, jstate, pctx, pstate


def _theta(key, Nrv, Ltau, N):
    """The phases update_greens_estimator draws (greens_estimator.py:216)."""
    return t64(np64(jax.random.uniform(key, (Nrv, Ltau, N), maxval=2.0 * np.pi)))


def _jax_estimator(jg, jctx, jstate, dtype, seed=3):
    est = jge.build_greens_estimator(jctx.Ltau, jg.n_orbitals, jg.L, Nrv=NRV, dtype=dtype)
    upd = jge.update_greens_estimator(est, jmake_fdm(jctx, jstate.x), jax.random.PRNGKey(seed),
                                      precond=jstate.precond, tol=1e-10, mixed=True,
                                      solve_dtype="float32" if dtype == "float32" else None)
    assert bool(upd.converged)
    return upd.estimator


def _close(got: torch.Tensor, ref_pair, tol):
    """A complex port output against a JAX (re, im) pair, relative to the
    reference's largest magnitude."""
    ref = np64(ref_pair[0]) + 1j * np64(ref_pair[1])
    g = got.numpy()
    assert g.shape == ref.shape
    assert np.max(np.abs(g - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


@pytest.mark.parametrize("shape", [(6, (4,)), (5, (3, 2)), (2, (24, 24)), (1030, (2,))],
                         ids=["chain", "2d", "per-axis-space", "factored-tau"])
@pytest.mark.parametrize("inverse", [False, True])
def test_space_time_dft_matches(shape, inverse):
    """The estimator's transform against the JAX package's PackedDFT /
    FactoredDFT choice (joint and per-axis space, dense and factored tau), on
    the tau axis of length Ltau and the doubled 2 Ltau."""
    Ltau, L = shape
    jest = jge.build_greens_estimator(Ltau, 1, L, Nrv=1)
    pest = pge.build_greens_estimator(Ltau, 1, L, Nrv=1, device="cpu")
    rng = np.random.default_rng(Ltau)
    for n_tau, doubled in ((Ltau, False), (2 * Ltau, True)):
        ar, ai = rng.standard_normal((2, 2, n_tau) + L)
        ref = jest.xt(jnp.asarray(ar), jnp.asarray(ai), inverse=inverse, doubled=doubled)
        got = pest.xt(torch.complex(t64(ar), t64(ai)), inverse=inverse)
        _close(got, ref, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kw", CASES)
def test_update_greens_estimator_matches(name, kw, dtype):
    """The refresh from the same field, preconditioner kind and phases: R
    exactly, GR at the solve's tolerance (f32 PCG at tol 2e-5, or the f64
    mixed solve at 1e-10)."""
    jg, pg, jctx, jstate, pctx, pstate = _chains(name, kw)
    key = jax.random.PRNGKey(5)
    f32 = dtype == "float32"
    jest = jge.build_greens_estimator(jctx.Ltau, jg.n_orbitals, jg.L, Nrv=NRV, dtype=dtype)
    jupd = jge.update_greens_estimator(jest, jmake_fdm(jctx, jstate.x), key, precond=jstate.precond, tol=1e-10,
                                       mixed=True, solve_dtype="float32" if f32 else None)
    pest = pge.build_greens_estimator(pctx.Ltau, pg.n_orbitals, pg.L, Nrv=NRV, dtype=dtype, device="cpu")
    pupd = pge.update_greens_estimator(pest, make_fdm(pctx, pstate.x), _theta(key, NRV, jctx.Ltau, jctx.n_sites),
                                       precond=pstate.precond, tol=1e-10, mixed=True,
                                       solve_dtype="float32" if f32 else None)
    assert bool(jupd.converged) and bool(pupd.converged)
    est = pupd.estimator
    assert est.GR.shape == (NRV, 2, jctx.Ltau, jctx.n_sites) and est.GR.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(est.R.numpy(), np.asarray(jupd.estimator.R))
    ref = np64(jupd.estimator.GR)
    scale = np.max(np.abs(ref))
    if f32:
        np.testing.assert_allclose(est.GR.numpy(), ref, rtol=2e-4, atol=2e-5 * scale)
    else:
        np.testing.assert_allclose(est.GR.numpy(), ref, rtol=0, atol=1e-8 * scale)


def test_mul_Mt_broadcasts_over_two_leading_axes():
    """M^T on (Nrv, 2, Ltau, N) equals M^T system by system."""
    *_, pctx, pstate = _chains("honeycomb", dict(L=2, beta=0.6, alpha=0.3))
    fdm = make_fdm(pctx, pstate.x)
    v = torch.randn((3, 2, pctx.Ltau, pctx.n_sites), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    got = fdm.mul_Mt(v)
    for i in range(3):
        for c in range(2):
            np.testing.assert_allclose(got[i, c].numpy(), fdm.mul_Mt(v[i, c]).numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kw", CASES)
def test_scalars_and_greens_function_match(name, kw, dtype):
    """measure_n (all sites and per orbital), Nsqrd, double occupancy and
    G_ab(r, tau) for every orbital pair, from the same R and GR."""
    jg, pg, jctx, jstate, pctx, pstate = _chains(name, kw)
    jest = _jax_estimator(jg, jctx, jstate, dtype)
    pest = convert.greens_estimator(jest, "cpu")
    tol = TOL[dtype]
    pairs = [(a, b) for a in range(jg.n_orbitals) for b in range(jg.n_orbitals)]
    for a, b in pairs:
        _close(pge.measure_G(pest, (a, b)), jge.measure_G(jest, (a, b)), tol)
    for orb in [None] + list(range(jg.n_orbitals)):
        _close(measure_n(pest, orb), jn(jest, orb), tol)
        _close(measure_double_occ(pest, orb), jdocc(jest, orb), tol)
    _close(measure_Nsqrd(pest), jnsq(jest), tol)


def _weights(rng, Ltau, L, complex_part):
    tr = 1.0 + 0.3 * rng.standard_normal((Ltau,) + L)
    ti = 0.3 * rng.standard_normal((Ltau,) + L) if complex_part else None
    jw = (jnp.asarray(tr), None if ti is None else jnp.asarray(ti))
    pw = (t64(tr), None if ti is None else t64(ti))
    return jw, pw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("topology", ["GD0_GD0", "GDD_G00", "G0D_GD0"])
def test_pair_topologies_match(topology, dtype):
    """The three contraction topologies on the honeycomb with every orbital
    coincidence the boundary corrections branch on, nonzero displacements,
    and hopping weights (real, complex, conjugated) on either side."""
    jg, pg, jctx, jstate, pctx, pstate = _chains("honeycomb", dict(L=2, beta=0.6, alpha=0.3))
    jest = _jax_estimator(jg, jctx, jstate, dtype)
    pest = convert.greens_estimator(jest, "cpu")
    jfn, pfn = getattr(jge, "measure_" + topology), getattr(pge, "measure_" + topology)
    rng = np.random.default_rng(11)
    z = (0, 0)
    cases = [((0, 0, 1, 1), (z, z, z, z)), ((0, 1, 1, 0), ((1, 0), z, (0, 1), (1, 1))),
             ((1, 1, 1, 1), ((1, 0), (1, 0), (0, 1), (0, 1))), ((0, 0, 0, 0), ((1, 1), z, z, (1, 0)))]
    for orbs, rs in cases:
        _close(pfn(pest, orbs, *rs, 0.7), jfn(jest, orbs, *rs, 0.7), TOL[dtype])
        for complex_part in (False, True):
            (jtD, ptD), (jt0, pt0) = (_weights(rng, jest.Ltau, jest.L, complex_part) for _ in range(2))
            for conj_tD, conj_t0 in ((False, False), (True, True), (True, False)):
                ref = jfn(jest, orbs, *rs, -1.3, jtD, jt0, conj_tD, conj_t0)
                _close(pfn(pest, orbs, *rs, -1.3, ptD, pt0, conj_tD, conj_t0), ref, TOL[dtype])
            _close(pfn(pest, orbs, *rs, 0.5, ptD, None, True, False), jfn(jest, orbs, *rs, 0.5, jtD, None, True, False),
                   TOL[dtype])


def _full_spec(module, geo):
    """The spec of tests/test_measurements.py:43-80 with the spin-resolved
    kinds added."""
    spec = module.MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0), (1, 1), (0, 1)], time_displaced=True)
    spec.add_correlation("phonon_greens", [(0, 0), (1, 1)], time_displaced=True)
    spec.add_correlation("density", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("pair", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("spin_z", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("bond", [(2, 2)], integrated=True)
    spec.add_correlation("current", [(2, 2)], integrated=True)
    spec.add_correlation("density_updn", [(0, 1)])
    spec.add_correlation("bond_upup", [(0, 1)])
    spec.add_correlation("current_dnup", [(2, 3)])
    spec.add_correlation("spin_x", [(0, 1)])
    spec.add_composite_correlation(
        "cdw", "density", ids=[0, 1], coefficients=[1.0, -1.0],
        displacement_vecs=[[0.0, 0.0], [0.0, 0.0]], integrated=True,
    )
    spec.add_composite_correlation(
        "tr_greens", "greens", id_pairs=[(0, 0), (1, 1)], coefficients=[1.0, 1.0],
        time_displaced=True,
    )
    return spec


NAN_GLOBALS = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_make_measurements_tree_matches(dtype):
    """The whole tree: the same categories, names, shapes and dtypes per leaf,
    the six DQMC-only globals NaN, every other leaf finite and equal to the
    JAX package's at the dtype's tolerance; then a bin of two passes through
    both packages' accumulators."""
    jg, pg, jctx, jstate, pctx, pstate = _chains("honeycomb", dict(L=2, beta=0.6, alpha=0.5))
    jest = _jax_estimator(jg, jctx, jstate, dtype)
    pest = convert.greens_estimator(jest, "cpu")
    jout = jcontainer.make_measurements(jctx, _full_spec(jcontainer, jg), jest, jstate.x)
    pout = pcontainer.make_measurements(pctx, _full_spec(pcontainer, pg), pest, t64(jstate.x))
    assert list(pout) == list(jout) == ["global", "local", "correlations", "composite"]
    for cat in jout:
        assert list(pout[cat]) == list(jout[cat]), cat
        for name, (jr, ji) in jout[cat].items():
            pr, pi = pout[cat][name]
            assert pr.numpy().dtype == np.asarray(jr).dtype and pi.numpy().dtype == np.asarray(ji).dtype, name
            if cat == "global" and name in NAN_GLOBALS:
                assert np.isnan(pr.item()) and pi.item() == 0.0
                continue
            assert np.all(np.isfinite(pr.numpy())) and np.all(np.isfinite(pi.numpy())), name
            _close(torch.complex(pr.double(), pi.double()), (jr, ji), TOL[dtype])

    jacc, pacc = jcontainer.MeasurementAccumulator(None), pcontainer.MeasurementAccumulator(None)
    for _ in range(2):
        jacc.accumulate(jout)
        pacc.accumulate(pout)
    jbin, pbin = jacc.finalize_bin(), pacc.finalize_bin()
    assert pacc.sums is None and pacc.count == 0
    for cat in jbin:
        for name, (jr, ji) in jbin[cat].items():
            pr, pi = pbin[cat][name]
            assert isinstance(pr, (np.ndarray, np.generic)) and pr.dtype == jr.dtype, (cat, name)
            if not (cat == "global" and name in NAN_GLOBALS):
                _close(torch.as_tensor(pr + 1j * pi), (jr, ji), TOL[dtype])
            else:
                assert np.isnan(pr)
