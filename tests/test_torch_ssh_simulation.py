"""The port's measured simulation on SSH models at W = 1: two measured sweeps
of the optical-SSH honeycomb (L=2) fed the JAX package's draws against the
JAX package's functions composed as its measured step, and
`run_simulation` on the CPU for each of the five SSH examples' models
(examples/_common.py: bssh and ossh chain and square, ossh honeycomb),
writing the whole output set with the SSH energies.

Tolerances (as tests/test_torch_simulation.py holds the Holstein path):
accept flags equal; the end field to 1e-6 relative; the bin averages to
1e-4 of each output's largest magnitude (f32 measurements of estimators
whose f32 solves stop at 2e-5 relative). Delta H of the production path to
1e-5: its f32 trajectory forces stop at tol 1e-5 in both packages with
different preconditioner arithmetic (bf16 in K2's plain version), and SSH
forces carry that into Delta H at the 1e-6 level (measured 4e-6 on the
honeycomb at Nt=6, where the Holstein path's is 1e-8). With f64 forces
solved to 1e-11 the two packages' trajectories agree to 1e-10 in Delta H and
1e-12 in the field (`test_exact_ssh_trajectory_matches_jax`).
"""

import glob
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from _torch_common import np64, t64
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_ssh_models import build

import smoqyelphqmc_tpu as J
from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, measured_sweep, run_simulation
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.measure.container import MeasurementAccumulator
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.models import library
from smoqyelphqmc_tpu_torch.ops.force import FORCE
from smoqyelphqmc_tpu_torch.ops.mtm import MTM
from smoqyelphqmc_tpu_torch.ops.pcg import PCG
from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE
from smoqyelphqmc_tpu_torch.parallel.walkers import WalkerDraws
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import _common as jexamples  # noqa: E402

torch.set_num_threads(2)

NAN_GLOBALS = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"}
MODELS = ["bssh_chain_model", "bssh_square_model", "ossh_chain_model", "ossh_square_model", "ossh_honeycomb_model"]


def ssh_chains(kind="ossh_honeycomb", seed=6, **opts):
    """JAX and port contexts and states of one SSH model, the port's built
    from the JAX package's expanded parameters."""
    geo, tbm, jtbp, _, jelph = build(J, kind)
    opts = dict(dict(mixed_precision=True, force_dtype="float32", preconditioner="spectral"), **opts)
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), **opts)
    return geo, tbm, jctx, jstate, pctx, pstate


def assert_bins_match(jbin, pbin, tag=""):
    for cat in jbin:
        assert sorted(pbin[cat]) == sorted(jbin[cat])
        for name, (jr, ji) in jbin[cat].items():
            pr, pi = pbin[cat][name]
            assert pr.dtype == jr.dtype, (tag, cat, name)
            if cat == "global" and name in NAN_GLOBALS:
                assert np.isnan(pr) and np.isnan(jr)
                continue
            ref = np64(jr) + 1j * np64(ji)
            assert np.max(np.abs((pr + 1j * pi) - ref)) <= 1e-4 * max(np.max(np.abs(ref)), 1e-300), (tag, cat, name)


def test_measured_ssh_sweeps_match_jax_draws():
    """Two measured sweeps (reflection + swap + HMC, the f32 estimator
    refresh, the SSH examples' measurement pass) of the optical-SSH
    honeycomb from the same state with the JAX package's draws and phases:
    the same accept flags, Delta H, end field and bin (ssh_energy
    included); K3 and K4 never run."""
    geo, tbm, jctx, jstate, pctx, pstate = ssh_chains()
    jspec = jexamples.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    pspec = library.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    Nrv, Nt = 3, 6
    cfg = SimulationConfig(beta=0.6, dtau=0.1, Nt=Nt, Nrv=Nrv, preconditioner="spectral")
    jparams = jhmc.HMCParams(Nt=Nt)

    @jax.jit
    def jax_measured(s, est, key_host):
        s, r = jglobal.reflection_update(jctx, s)
        s, sw = jglobal.swap_update(jctx, s)
        s, h = jhmc.hmc_update(jctx, s, jparams)
        key_host, sub = jax.random.split(key_host)
        upd = jge.update_greens_estimator(est, jmake_fdm(jctx, s.x), sub, precond=s.precond, tol=cfg.tol,
                                          maxiter=cfg.maxiter, mixed=True, solve_dtype="float32")
        out = jcontainer.make_measurements(jctx, jspec, upd.estimator, s.x)
        return s, upd.estimator, key_host, out, jax.numpy.stack([r.accepted, sw.accepted, h.accepted]), h.delta_H

    jest = jge.build_greens_estimator(jctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32")
    pest = build_greens_estimator(pctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32", device="cpu")
    key_host = jax.random.PRNGKey(cfg.seed + 7919)
    key = jstate.key
    L, N, n_ph, n_cells = jctx.Ltau, jctx.n_sites, jctx.elph.n_phonon, jctx.elph.n_cells
    jacc, pacc = jcontainer.MeasurementAccumulator(jspec), MeasurementAccumulator(pspec)
    k34 = (PCG_FORCE.plain_calls, FORCE.plain_calls)
    for _ in range(2):
        rd, key = _reflection_draws(key, len(_candidate_modes(pctx, None)), L, N)
        sd, key = _swap_draws(key, len(_type_pairs(pctx, None)), n_cells, L, N)
        hd, key = _hmc_draws(key, n_ph, L, N)
        _, sub = jax.random.split(key_host)
        theta = t64(np64(jax.random.uniform(sub, (Nrv, L, N), maxval=2.0 * np.pi)))
        jstate, jest, key_host, jout, jflags, jdH = jax_measured(jstate, jest, key_host)
        m = measured_sweep(pctx, pstate, HMCParams(Nt=Nt), WalkerDraws(rd, sd, hd, theta), pest, pspec, cfg)
        pstate, pest = m.state, m.update.estimator
        assert [st.accepted for st in m.stats] == [bool(f) for f in np.asarray(jflags)]
        assert m.stats.converged and bool(m.update.converged)
        assert abs(m.stats.hmc.delta_H - float(jdH)) <= 1e-5
        jacc.accumulate(jout)
        pacc.accumulate(m.out)
    assert (PCG_FORCE.plain_calls, FORCE.plain_calls) == k34
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jstate.key))
    xj = np64(jstate.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    jbin, pbin = jacc.finalize_bin(), pacc.finalize_bin()
    assert "ssh_energy" in pbin["local"] and pbin["local"]["ssh_energy"][0].shape == (3,)
    assert_bins_match(jbin, pbin)


@pytest.mark.parametrize("kind", ["ossh_honeycomb", "bssh_square_disp", "complex_ssh_chain"])
def test_exact_ssh_trajectory_matches_jax(kind):
    """One leapfrog trajectory (Nt=6) with f64 forces solved to 1e-11 from
    the same field and draws: Delta H to 1e-10, the end field to 1e-12
    relative, the same accept decision (SSH forces, the dispersive force,
    complex SSH constants with the doubled-basis preconditioner)."""
    pre = "auto" if kind.startswith("complex") else "spectral"
    _, _, jctx, jstate, pctx, pstate = ssh_chains(kind, seed=2, force_dtype="float64", tol_force=1e-11,
                                                  preconditioner=pre)
    hd, _ = _hmc_draws(jstate.key, jctx.elph.n_phonon, jctx.Ltau, jctx.n_sites)
    jnew, jst = jax.jit(lambda s: jhmc.hmc_update(jctx, s, jhmc.HMCParams(Nt=6)))(jstate)
    pnew, pst = hmc_update(pctx, pstate, HMCParams(Nt=6), hd)
    assert bool(jst.converged) and pst.converged and pst.accepted == bool(jst.accepted)
    assert abs(pst.delta_H - float(jst.delta_H)) <= 1e-10
    xj = np64(jnew.x)
    assert np.max(np.abs(pnew.x.numpy() - xj)) <= 1e-12 * np.max(np.abs(xj))
    assert np.max(np.abs(xj - np64(jstate.x))) > 1e-3


@pytest.mark.parametrize("make_model", MODELS)
def test_run_simulation_ssh_examples_write_output_set(tmp_path, make_model):
    """run_simulation on the CPU for each SSH example's model (the examples'
    configuration: radial updates, the package defaults) at a small size:
    the output set of the JAX package's `run_simulation` with the SSH
    energies, finite
    bins except the NaN globals, plain versions only."""
    L = 4 if "chain" in make_model else 2
    geo, tbm, em = getattr(library, make_model)(L, 1.0, 0.5, 0.0)
    spec = library.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    cfg = SimulationConfig(beta=0.4, dtau=0.1, N_therm=1, N_measurements=2, N_bins=2, Nt=3, Nrv=2, seed=3,
                           use_radial_updates=True)
    counters = (MTM[torch.float32], MTM[torch.float64], PCG)
    before = [(c.launches, c.plain_calls) for c in counters]
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix=make_model, sID=1)
    md = run_simulation(info, tbm, em, spec, cfg, device="cpu")
    after = [(c.launches, c.plain_calls) for c in counters]
    assert all(l1 == l0 and p1 > p0 for (l0, p0), (l1, p1) in zip(before, after))
    files = set(os.listdir(info.datafolder))
    assert {"model_summary.toml", "simulation_info_pID-0.toml", "binned_data.h5", "stats.h5", "bins",
            "global_stats.csv", "correlations_greens_time_displaced.csv"} <= files
    assert sorted(os.listdir(os.path.join(info.datafolder, "bins"))) == ["bin-0_pID-0.h5", "bin-1_pID-0.h5"]
    assert not glob.glob(os.path.join(info.datafolder, "checkpoint_*"))
    assert md["all_converged"] and md["measurement_iters"] > 0
    with h5py.File(os.path.join(info.datafolder, "binned_data.h5"), "r") as f:
        n_types = len(em.ssh_couplings)
        for name in ("ssh_energy", "ssh_energy_up", "ssh_energy_dn", "hopping_energy"):
            v = f["local"][name][()]
            assert v.shape[0] == 2 and np.all(np.isfinite(v)), name
        assert f["local"]["ssh_energy"].shape == (2, n_types)
        for cat in ("global", "local", "correlations"):
            for name, ds in f[cat].items():
                v = ds[()]
                assert np.all(np.isnan(v.real)) if name in NAN_GLOBALS else np.all(np.isfinite(v)), (cat, name)
