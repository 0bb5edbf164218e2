"""The port's measured simulation: two measured sweeps fed the JAX package's
draws against the same sweeps composed from JAX functions, `run_simulation`
on the CPU writing the whole output set through the plain versions,
runtime-limit interrupts with bit-identical resume (the port's twins of
tests/test_checkpoint_resume.py), the NotImplementedError of the option
whose code is not ported yet, and a run with each option ported since.

Tolerances: accept flags must be equal; the end field after two sweeps is
held to 1e-6 relative, as one sweep is in tests/test_torch_hmc.py; the bin
averages to 1e-4 of each output's largest magnitude (f32 measurements of
estimators whose f32 solves stop at 2e-5 relative in both packages, with
K2's bf16 preconditioner against the JAX XLA path's f32 one, at fields that
differ at the 1e-6 level; measured 1.4e-6). A resumed run's bins must equal the
uninterrupted run's bit for bit.
"""

import dataclasses
import glob
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from _torch_common import np64, t64
from test_torch_hmc import _both_chains, _hmc_draws, _reflection_draws, _swap_draws

from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, measured_sweep, run_simulation
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.measure.container import MeasurementAccumulator
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec
from smoqyelphqmc_tpu_torch.ops.mtm import MTM
from smoqyelphqmc_tpu_torch.ops.pcg import PCG
from smoqyelphqmc_tpu_torch.parallel.walkers import WalkerDraws
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
from _common import holstein_honeycomb_spec as jax_holstein_honeycomb_spec  # noqa: E402

torch.set_num_threads(2)

NAN_GLOBALS = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"}


def test_tutorial_spec_matches_examples():
    """models.library.holstein_honeycomb_spec is the tutorial's set."""
    geo, *_ = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    ours, ref = holstein_honeycomb_spec(geo), jax_holstein_honeycomb_spec(geo)
    for got, want in ((ours.correlations, ref.correlations), (ours.composites, ref.composites)):
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {k: dataclasses.asdict(v) for k, v in want.items()}


def test_measured_sweeps_match_jax_draws():
    """Two measured sweeps (reflection + swap + HMC, the f32 estimator
    refresh, the tutorial measurement pass) from the same state with the JAX
    package's draws and phases, against the JAX package's functions composed
    as its driver's measured_step: the same accept flags, the end field, and
    the bin of the two passes."""
    jctx, jstate, pctx, pstate = _both_chains(seed=6, L=2, beta=0.6, alpha=0.5)
    geo = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)[0]
    jspec, pspec = jax_holstein_honeycomb_spec(geo), holstein_honeycomb_spec(geo)
    Nrv, Nt = 4, 6
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
        return s, upd.estimator, key_host, out, jax.numpy.stack([r.accepted, sw.accepted, h.accepted])

    jest = jge.build_greens_estimator(jctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32")
    pest = build_greens_estimator(pctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32", device="cpu")
    key_host = jax.random.PRNGKey(cfg.seed + 7919)
    key = jstate.key
    L, N, n_ph, n_cells = jctx.Ltau, jctx.n_sites, jctx.elph.n_phonon, jctx.elph.n_cells
    jacc, pacc = jcontainer.MeasurementAccumulator(jspec), MeasurementAccumulator(pspec)
    for _ in range(2):
        rd, key = _reflection_draws(key, len(_candidate_modes(pctx, None)), L, N)
        sd, key = _swap_draws(key, len(_type_pairs(pctx, None)), n_cells, L, N)
        hd, key = _hmc_draws(key, n_ph, L, N)
        _, sub = jax.random.split(key_host)
        theta = t64(np64(jax.random.uniform(sub, (Nrv, L, N), maxval=2.0 * np.pi)))
        jstate, jest, key_host, jout, jflags = jax_measured(jstate, jest, key_host)
        m = measured_sweep(pctx, pstate, HMCParams(Nt=Nt), WalkerDraws(rd, sd, hd, theta), pest, pspec, cfg)
        pstate, pest = m.state, m.update.estimator
        assert [st.accepted for st in m.stats] == [bool(f) for f in np.asarray(jflags)]
        assert m.stats.converged and bool(m.update.converged)
        jacc.accumulate(jout)
        pacc.accumulate(m.out)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jstate.key))
    xj = np64(jstate.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    jbin, pbin = jacc.finalize_bin(), pacc.finalize_bin()
    for cat in jbin:
        assert sorted(pbin[cat]) == sorted(jbin[cat])  # a jitted tree comes back with sorted keys
        for name, (jr, ji) in jbin[cat].items():
            pr, pi = pbin[cat][name]
            assert pr.dtype == jr.dtype, (cat, name)
            if cat == "global" and name in NAN_GLOBALS:
                assert np.isnan(pr) and np.isnan(jr)
                continue
            ref = np64(jr) + 1j * np64(ji)
            assert np.max(np.abs((pr + 1j * pi) - ref)) <= 1e-4 * max(np.max(np.abs(ref)), 1e-300), (cat, name)


def _config(**kw):
    opts = dict(beta=0.4, dtau=0.1, N_therm=2, N_measurements=4, N_bins=2, Nt=2, Nrv=3, tol=1e-7, seed=21)
    return SimulationConfig(**{**opts, **kw})


def _model():
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.4, 0.0)
    return tbm, em, holstein_honeycomb_spec(geo)


def _bins(datafolder):
    out = {}
    for path in sorted(glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.h5"))):
        with h5py.File(path, "r") as f:
            for cat in ("global", "local", "correlations", "composite"):
                for name, ds in f[cat].items():
                    out[(os.path.basename(path), cat, name)] = ds[()]
    return out


def test_run_simulation_writes_output_set(tmp_path):
    """The tutorial set on the CPU: the output set of the JAX package's
    driver, finite bins except the NaN globals, the plain versions only."""
    tbm, em, spec = _model()
    counters = (MTM[torch.float32], MTM[torch.float64], PCG)
    before = [(c.launches, c.plain_calls) for c in counters]
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="hh", sID=1)
    md = run_simulation(info, tbm, em, spec, _config(), device="cpu")
    after = [(c.launches, c.plain_calls) for c in counters]
    assert all(l1 == l0 and p1 > p0 for (l0, p0), (l1, p1) in zip(before, after))
    files = set(os.listdir(info.datafolder))
    assert {"model_summary.toml", "simulation_info_pID-0.toml", "binned_data.h5", "stats.h5", "bins",
            "global_stats.csv", "correlations_greens_time_displaced.csv", "composite_cdw_integrated.csv",
            "composite_tr_greens_time_displaced_momentum.csv"} <= files
    assert sorted(os.listdir(os.path.join(info.datafolder, "bins"))) == ["bin-0_pID-0.h5", "bin-1_pID-0.h5"]
    assert not glob.glob(os.path.join(info.datafolder, "checkpoint_*"))
    assert md["all_converged"] and 0.0 <= md["hmc_acceptance_rate"] <= 1.0 and md["measurement_iters"] > 0
    assert md["n_measure_timed"] == 4 and md["n_therm_timed"] == 2 and md["t_refresh_s"] > 0 and md["t_measurements_s"] > 0
    for (_, cat, name), v in _bins(info.datafolder).items():
        assert np.all(np.isnan(v.real)) if name in NAN_GLOBALS else np.all(np.isfinite(v)), (cat, name)
    with h5py.File(os.path.join(info.datafolder, "binned_data.h5"), "r") as f:
        assert f["correlations"]["greens"].shape == (2, 3, 5, 2, 2)
        assert 0.0 < f["global"]["density"][0].real < 2.0
        assert f["global"]["density"].dtype == np.complex128


def test_runtime_limit_interrupt_and_resume(tmp_path):
    """Runtime limit 0: the run stops after its first sweep with a checkpoint
    and no statistics; the same sim_info resumes, completes, and deletes its
    checkpoints."""
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="resume_test", sID=1)
    run_simulation(info, tbm, em, spec, _config(checkpoint_freq_hours=0.0, runtime_limit_hours=0.0), device="cpu")
    assert glob.glob(os.path.join(info.datafolder, "checkpoint_pID-0_slot-*.pkl"))
    assert not os.path.exists(os.path.join(info.datafolder, "stats.h5"))
    info2 = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="resume_test", sID=1)
    run_simulation(info2, tbm, em, spec, _config(checkpoint_freq_hours=0.0), device="cpu")
    assert os.path.exists(os.path.join(info2.datafolder, "stats.h5"))
    assert not glob.glob(os.path.join(info2.datafolder, "checkpoint_pID-0_slot-*.pkl"))


@pytest.mark.parametrize("interrupts", ["once", "every-sweep"])
def test_resume_is_bit_identical(tmp_path, interrupts):
    """Interrupted runs write the uninterrupted run's bins exactly: stopped
    once after the first thermalization sweep (mid-bin: the checkpoint
    carries the partial-bin sums), or after every sweep until the first bin
    is written, each resume restoring the field, preconditioner, generator
    state, counters, metadata and sums."""
    tbm, em, spec = _model()
    ref_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="uninterrupted", sID=1)
    ref_md = run_simulation(ref_info, tbm, em, spec, _config(seed=33), device="cpu")
    ref = _bins(ref_info.datafolder)
    assert ref

    def info():
        return SimulationInfo(filepath=str(tmp_path), datafolder_prefix="interrupted", sID=1)

    stop = _config(seed=33, checkpoint_freq_hours=0.0 if interrupts == "once" else np.inf, runtime_limit_hours=0.0)
    run_simulation(info(), tbm, em, spec, stop, device="cpu")
    if interrupts == "every-sweep":
        first_bin = os.path.join(info().datafolder, "bins", "bin-0_pID-0.h5")
        for _ in range(stop.N_therm + stop.N_measurements // stop.N_bins):
            if os.path.exists(first_bin):
                break
            run_simulation(info(), tbm, em, spec, stop, device="cpu")
        assert os.path.exists(first_bin) and glob.glob(os.path.join(info().datafolder, "checkpoint_*.pkl"))
    md = run_simulation(info(), tbm, em, spec, dataclasses.replace(stop, runtime_limit_hours=np.inf), device="cpu")
    got = _bins(info().datafolder)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    for k in ("hmc_acceptance_rate", "reflection_iters", "swap_iters", "hmc_iters", "measurement_iters"):
        assert md[k] == ref_md[k], k


@pytest.mark.parametrize("field,value,item", [("sweeps_per_dispatch", 4, 18)])
def test_unported_options_raise(tmp_path, field, value, item):
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="unported", sID=1)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        run_simulation(info, tbm, em, spec, _config(**{field: value}), device="cpu")


@pytest.mark.parametrize("field,value,key", [
    ("hmc_integrator", "omelyan", "hmc_acceptance_rate"), ("target_acceptance", 0.7, "hmc_dt_final"),
    ("use_radial_updates", True, "radial_acceptance_rate"), ("target_density", 1.0, "final_mu"),
    ("n_walkers", 2, "final_mu_per_walker"),
])
def test_ported_options_run(tmp_path, field, value, key):
    """Each option that raised before its code was ported now runs to the
    end of run_simulation on the CPU and reports its metadata key (W = 2
    with mu tuning, so that each walker's final mu is there)."""
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="ported", sID=1)
    extra = dict(target_density=1.0) if field == "n_walkers" else {}
    md = run_simulation(info, tbm, em, spec, _config(**{field: value}, **extra), device="cpu")
    assert md["all_converged"] and key in md and os.path.exists(os.path.join(info.datafolder, "stats.h5"))
    assert 0.0 <= md["radial_acceptance_rate"] <= 1.0 and md["measurement_iters"] > 0

