"""The port's walker path with a complex fermion matrix: one W = 2 walker
sweep of the complex chain (t e^{0.7 i}) with 'auto' (the doubled-basis
spectral preconditioner) and with the matrix-free KPM preconditioner (K8's
plain version), and of the complex-SSH chain, each with the shared refresh
and in per-walker mode, fed the JAX package's draws against its vmapped
walker_sweep (tests/test_torch_kpm_walkers.py:replay_walker_sweep); the
walker-mean fermion matrix of static complex hops; each walker's
measurement pass of the flux chain's correlations (current included) at its
own complex fermion matrix against the JAX package's.

Tolerances: accept flags equal, Delta H 1e-5, fields 1e-6 relative (the
f32-force tolerances of ROADMAP Queue 3); the measurements 1e-4 of each
output's largest magnitude (f32 estimators, tests/test_torch_ssh_walkers.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_common import np64, t64
from test_complex_hoppings import complex_chain_model as jax_complex_chain
from test_torch_kpm_walkers import MODES, replay_walker_sweep, walker_chains
from test_torch_ssh_models import build
from test_torch_ssh_simulation import assert_bins_match

import smoqyelphqmc_tpu as J
import smoqyelphqmc_tpu_torch as P
from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch.measure.container import MeasurementAccumulator, MeasurementSpec
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.ops import kpm as pkpm
from smoqyelphqmc_tpu_torch.ops import kpm_mf, mtm, pcg, pcg_force
from smoqyelphqmc_tpu_torch.ops.fermion_det import CPLX_MTM
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.context import make_fdm

torch.set_num_threads(2)

CHAIN = dict(L=6, phase=0.7, alpha=0.5, beta=1.0, dtau=0.1, seed=0)
OPTS = dict(mixed_precision=True, force_dtype="float32")
REAL_KERNELS = [mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, kpm_mf.KPM_MF,
                kpm_mf.KPM_MF_ASYM]


def _complex_chain(kind, W=2, seed=4):
    *_, jtbp, _, jelph = jax_complex_chain(**CHAIN)
    return walker_chains(jtbp, jelph, W, seed, preconditioner=kind, **OPTS)


@pytest.mark.parametrize("shared", MODES)
@pytest.mark.parametrize("kind", ["auto", "kpm"])
def test_complex_walker_sweep_matches_jax_draws(kind, shared, monkeypatch):
    """The complex chain at W = 2: each walker's flags, Delta H and field
    against the JAX package's; the complex M^dag M ran, K8's plain version
    ran with 'kpm' (not with 'auto'), and no real-hopping kernel did."""
    monkeypatch.setenv("SMOQY_KPM_MATRIX_FREE", "1")
    monkeypatch.setattr(pkpm, "MATRIX_FREE_MIN_SITES", 0)
    jctx, jstates, pctx, pstates = _complex_chain(kind)
    assert pctx.complex_hops and pstates.precond[0].complex_pair
    before = [c.plain_calls for c in REAL_KERNELS]
    k8, cplx = kpm_mf.KPM_MF_CPLX.plain_calls, [c.plain_calls for c in CPLX_MTM.values()]
    replay_walker_sweep(jctx, jstates, pctx, pstates, 4, shared)
    assert [c.plain_calls for c in REAL_KERNELS] == before
    assert all(c.plain_calls > c0 for c, c0 in zip(CPLX_MTM.values(), cplx))
    assert (kpm_mf.KPM_MF_CPLX.plain_calls > k8) == (kind == "kpm")


@pytest.mark.parametrize("shared", MODES)
def test_complex_ssh_walker_sweep_matches_jax_draws(shared):
    """The complex-SSH chain (real hoppings, complex SSH constants) at W = 2
    with the doubled-basis spectral preconditioner: each walker's own
    complex hopping tables, flags, Delta H and field against the JAX
    package's."""
    _, _, jtbp, _, jelph = build(J, "complex_ssh_chain")
    jctx, jstates, pctx, pstates = walker_chains(jtbp, jelph, 2, 6, preconditioner="auto", **OPTS)
    assert pctx.complex_hops and pctx.tbp.t0_im is None
    fdm = make_fdm(pctx, pstates.x)
    assert fdm.sinh_hop_im.shape[0] == 2 and not torch.equal(fdm.sinh_hop_im[0], fdm.sinh_hop_im[1])
    replay_walker_sweep(jctx, jstates, pctx, pstates, 4, shared)


def test_walker_mean_fdm_keeps_static_complex_hops():
    """The walker mean of static complex hops: exp_nV averaged over the
    walkers, sinh_hop_im and the checkerboard's S_im the model's, so that the
    shared refresh builds from the complex Bbar; the JAX package's mean of
    every leaf gives the same tables."""
    jctx, jstates, pctx, pstates = _complex_chain("auto", W=3)
    mean = walkers.walker_mean_fdm(make_fdm(pctx, pstates.x))
    jfdms = jax.vmap(lambda x: jmake_fdm(jctx, x))(jstates.x)
    jmean = jax.tree_util.tree_map(lambda a: a.mean(axis=0), jfdms)
    assert tuple(mean.exp_nV.shape) == (pctx.Ltau, pctx.n_sites)
    np.testing.assert_allclose(mean.exp_nV.numpy(), np64(jmean.exp_nV), rtol=1e-13, atol=0)
    np.testing.assert_allclose(mean.sinh_hop_im.numpy(), np64(jmean.sinh_hop_im), rtol=1e-13, atol=0)
    assert mean.cb.S_im is not None and float(mean.cb.S_im.abs().max()) > 1e-2
    v = np.random.default_rng(3).standard_normal((2, pctx.Ltau, pctx.n_sites))
    ref = np64(jmean.mul_M(jax.numpy.asarray(v)))
    assert np.max(np.abs(mean.mul_M(t64(v)).numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))


def _flux_spec(spec_cls, geo, bond_id):
    """examples/holstein_flux_chain.py's correlations."""
    spec = spec_cls(geometry=geo)
    spec.add_correlation("greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("phonon_greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    spec.add_correlation("current", [(bond_id, bond_id)], integrated=True)
    return spec


def test_complex_walker_measure_matches_jax():
    """walker_measure at W = 2 on the complex chain after the shared refresh:
    each walker's estimator refresh and measurement pass (the flux chain's
    greens, phonon greens, density and current correlations) at its own
    complex fermion matrix, against the JAX package's at that walker's field
    and preconditioner with the same phases; the two walkers' outputs
    differ."""
    Nrv, tol = 3, 1e-8
    jgeo, jtbm, *_ = jax_complex_chain(**CHAIN)
    jctx, jstates, pctx, pstates = _complex_chain("auto")
    jstates = jwalkers.shared_precond_refresh(jctx, jstates)
    pstates = walkers.shared_precond_refresh(pctx, pstates)
    geo = P.ModelGeometry(P.UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), P.Lattice(L=[CHAIN["L"]]))
    geo.add_bond(P.Bond(orbitals=(0, 0), displacement=[1]))
    jspec = _flux_spec(jcontainer.MeasurementSpec, jgeo, jtbm.bond_ids[0])
    pspec = _flux_spec(MeasurementSpec, geo, jtbm.bond_ids[0])
    jest = jge.build_greens_estimator(jctx.Ltau, 1, jgeo.L, Nrv=Nrv, dtype="float32")
    pest = build_greens_estimator(pctx.Ltau, 1, geo.L, Nrv=Nrv, dtype="float32", device="cpu")

    @jax.jit
    def jmeasure(s1, k):
        upd = jge.update_greens_estimator(jest, jmake_fdm(jctx, s1.x), k, precond=s1.precond, tol=tol,
                                          maxiter=10_000, mixed=True, solve_dtype="float32")
        return jcontainer.make_measurements(jctx, jspec, upd.estimator, s1.x)

    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    L, N = pctx.Ltau, pctx.n_sites
    thetas = [t64(np64(jax.random.uniform(k, (Nrv, L, N), maxval=2.0 * np.pi))) for k in keys]
    m = walkers.walker_measure(pctx, pspec, pstates, pest, thetas, tol=tol, maxiter=10_000, mixed=True,
                               solve_dtype="float32")
    bins = []
    for w in range(2):
        assert bool(m.updates[w].converged)
        jout = jmeasure(jax.tree_util.tree_map(lambda a: a[w], jstates), keys[w])
        jacc, pacc = jcontainer.MeasurementAccumulator(jspec), MeasurementAccumulator(pspec)
        jacc.accumulate(jout)
        pacc.accumulate(m.outs[w])
        pbin = pacc.finalize_bin()
        assert_bins_match(jacc.finalize_bin(), pbin, tag=w)
        bins.append(pbin["correlations"]["current"])
    assert not np.array_equal(bins[0][0], bins[1][0])


RUNS = {"kpm-sym": ("honeycomb", dict(preconditioner="kpm")),
        "kpm-asym": ("honeycomb", dict(preconditioner="kpm", symmetric=False)),
        "complex-auto": ("complex_chain", dict(preconditioner="auto")),
        "complex-kpm": ("complex_chain", dict(preconditioner="kpm")),
        "complex-ssh": ("complex_ssh_chain", {})}


@pytest.mark.parametrize("case", list(RUNS))
def test_run_simulation_walkers_on_cpu(case, tmp_path):
    """run_simulation at W = 2 on the CPU with KPM in both factorizations,
    complex hoppings with 'auto' and 'kpm', and complex SSH constants: every
    solve converges, both walkers' bins and the statistics are written."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.models import library

    model, opts = RUNS[case]
    if model == "honeycomb":
        geo, tbm, em = library.holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    elif model == "complex_chain":
        geo, tbm, em = library.complex_chain_model(6)
    else:
        geo, tbm, _, em, _ = build(P, model)
    cfg = SimulationConfig(beta=0.6, dtau=0.1, N_therm=1, N_measurements=2, N_bins=1, Nt=3, Nrv=3, tol=1e-7,
                           seed=4, n_walkers=2, **opts)
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix=case, sID=1)
    md = run_simulation(info, tbm, em, library.basic_spec(geo, list(tbm.bond_ids)), cfg, device="cpu")
    assert md["all_converged"] and md["n_walkers"] == 2
    assert md.get("kpm_active") is (True if opts.get("preconditioner") == "kpm" else None)
    assert sorted(os.listdir(os.path.join(info.datafolder, "bins"))) == ["bin-0_pID-0.h5", "bin-0_pID-1.h5"]
    assert os.path.exists(os.path.join(info.datafolder, "stats.h5"))
