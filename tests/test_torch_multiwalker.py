"""The port's measured multi-walker simulation: two measured W = 2 sweeps with
a chemical potential a walker, fed the JAX package's draws, against the JAX
package's functions composed as its multi-walker driver's measured sweep
(`_measured_body`: the shared refresh at the walker-mean mu, each walker's
reflection, swap and HMC at its own mu, each walker's estimator refresh and
measurement pass); `run_simulation` at W = 2 with every sampler option on
writing the whole output set; interrupted and resumed runs at W = 2 with mu
tuning and dt targeting (the port's twins of tests/test_driver.py and
tests/test_checkpoint_resume.py).

Tolerances, as tests/test_torch_simulation.py holds W = 1: accept flags
equal, the fields to 1e-6 relative, the bins to 1e-4 of each output's
largest magnitude (f32 measurements of estimators whose f32 solves stop at
2e-5 relative in both packages); a resumed run's bins, tuning profiles,
final mu and dt equal the uninterrupted run's bit for bit.
"""

import dataclasses
import glob
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import np64, t64
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_walkers import _both_walker_chains

from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_simulation, simulate
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.measure.container import MeasurementAccumulator
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec
from smoqyelphqmc_tpu_torch.ops import pcg_force
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
from _common import holstein_honeycomb_spec as jax_holstein_honeycomb_spec  # noqa: E402

torch.set_num_threads(2)

NAN_GLOBALS = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"}

# the metadata keys of the JAX package's multi-walker driver (driver.py:1005-1019, :1216-1227, :1256-1322)
JAX_KEYS = {"n_walkers", "N_therm", "N_measurements", "N_bins", "seed", "hmc_acceptance_rate",
            "reflection_acceptance_rate", "swap_acceptance_rate", "radial_acceptance_rate", "hmc_iters",
            "reflection_iters", "swap_iters", "measurement_iters", "t_first_therm_sweep_s", "n_first_therm_batch",
            "t_therm_s", "n_therm_timed", "t_first_measured_sweep_s", "n_first_measured_batch", "t_measure_s",
            "n_measure_timed", "precond_fallback_sweeps", "hmc_dt_final", "final_mu_per_walker"}


def _jax_with_mu(ctx, mu):
    return ctx.replace(tbp=ctx.tbp.replace(mu=mu))


def test_measured_walker_sweeps_match_jax_draws():
    """Two measured sweeps at W = 2 with mu = (0, 0.1) from the same fields
    and each walker's JAX draws: the same accept flags, the fields, and each
    walker's bin of the two passes, whose chemical potential is its own."""
    W, Nt, Nrv, tol = 2, 4, 4, 1e-10
    jctx, jstates, pctx, pstates = _both_walker_chains(W, 4, L=2, beta=0.6, alpha=0.5)
    geo = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)[0]
    jspec, pspec = jax_holstein_honeycomb_spec(geo), holstein_honeycomb_spec(geo)
    jmus = jnp.asarray([0.0, 0.1])
    pmus = torch.tensor([0.0, 0.1], dtype=torch.float64)
    jest = jge.build_greens_estimator(jctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32")
    pest = build_greens_estimator(pctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32", device="cpu")
    hp = jhmc.HMCParams(Nt=Nt, refresh_precond_at_start=False, fused_step_force=True)

    @jax.jit
    def jax_measured(s, key):
        s = jwalkers.shared_precond_refresh(_jax_with_mu(jctx, jnp.mean(jmus)), s)

        def one(s1, mu):
            c = _jax_with_mu(jctx, mu)
            s1, r = jglobal.reflection_update(c, s1)
            s1, sw = jglobal.swap_update(c, s1)
            s1, h = jhmc.hmc_update(c, s1, hp)
            return s1, jnp.stack([r.accepted, sw.accepted, h.accepted])

        s, flags = jax.vmap(one)(s, jmus)
        key, sub = jax.random.split(key)

        def meas(s1, k, mu):
            c = _jax_with_mu(jctx, mu)
            upd = jge.update_greens_estimator(jest, jmake_fdm(c, s1.x), k, precond=s1.precond, tol=tol,
                                              maxiter=10_000, mixed=True, solve_dtype="float32")
            return jcontainer.make_measurements(c, jspec, upd.estimator, s1.x)

        return s, key, jax.vmap(meas)(s, jax.random.split(sub, W), jmus), flags

    n_cands, n_pairs = len(_candidate_modes(pctx, None)), len(_type_pairs(pctx, None))
    L, N, n_ph, n_cells = pctx.Ltau, pctx.n_sites, pctx.elph.n_phonon, pctx.elph.n_cells
    key_host = jax.random.PRNGKey(17)
    keys = list(jstates.key)
    jaccs = [jcontainer.MeasurementAccumulator(jspec) for _ in range(W)]
    paccs = [MeasurementAccumulator(pspec) for _ in range(W)]
    first = []  # the first sweep's initial states, draws and end field
    for _ in range(2):
        draws = []
        for w in range(W):
            rd, keys[w] = _reflection_draws(keys[w], n_cands, L, N)
            sd, keys[w] = _swap_draws(keys[w], n_pairs, n_cells, L, N)
            hd, keys[w] = _hmc_draws(keys[w], n_ph, L, N)
            draws.append(walkers.WalkerDraws(rd, sd, hd))
        _, sub = jax.random.split(key_host)
        thetas = [t64(np64(jax.random.uniform(k, (Nrv, L, N), maxval=2.0 * np.pi))) for k in jax.random.split(sub, W)]
        jstates, key_host, jout, jflags = jax_measured(jstates, key_host)
        k3 = pcg_force.PCG_FORCE.plain_calls
        first = first or [pstates, draws]
        pstates, st = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=Nt), draws, mus=pmus)
        assert pcg_force.PCG_FORCE.plain_calls == k3 + Nt
        first = first if len(first) == 3 else first + [pstates.x]
        m = walkers.walker_measure(pctx, pspec, pstates, pest, thetas, pmus, tol=tol, maxiter=10_000, mixed=True,
                                   solve_dtype="float32")
        outs, upds = m.outs, m.updates
        for w in range(W):
            assert [s[w].accepted for s in st] == [bool(f) for f in np.asarray(jflags[w])]
            assert all(s[w].converged for s in st) and bool(upds[w].converged)
            jaccs[w].accumulate(jax.tree_util.tree_map(lambda a: a[w], jout))
            paccs[w].accumulate(outs[w])
    for w in range(W):
        np.testing.assert_array_equal(np.asarray(keys[w]), np.asarray(jstates.key[w]))
        xj = np64(jstates.x[w])
        assert np.max(np.abs(pstates.x[w].numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
        jbin, pbin = jaccs[w].finalize_bin(), paccs[w].finalize_bin()
        assert float(pbin["global"]["chemical_potential"][0]) == float(pmus[w])
        for cat in jbin:
            assert sorted(pbin[cat]) == sorted(jbin[cat])
            for name, (jr, ji) in jbin[cat].items():
                pr, pi = pbin[cat][name]
                if cat == "global" and name in NAN_GLOBALS:
                    assert np.isnan(pr) and np.isnan(jr)
                    continue
                ref = np64(jr) + 1j * np64(ji)
                err = np.max(np.abs((pr + 1j * pi) - ref))
                assert err <= 1e-4 * max(np.max(np.abs(ref)), 1e-300), (w, cat, name)
    # the check would see a lost mu: the first sweep at mu = 0 for both
    # walkers (the shared preconditioner then at mu = 0 too) keeps walker 0's
    # field within the bound and moves walker 1's far beyond it
    at_zero, _ = walkers.walker_sweep(pctx, first[0], HMCParams(Nt=Nt), first[1])
    scale = [float(v.abs().max()) for v in first[2]]
    assert float((at_zero.x[0] - first[2][0]).abs().max()) <= 1e-6 * scale[0]
    assert float((at_zero.x[1] - first[2][1]).abs().max()) > 1e-4 * scale[1]


def _config(**kw):
    opts = dict(beta=0.4, dtau=0.1, N_therm=2, N_measurements=4, N_bins=2, Nt=2, Nrv=3, tol=1e-7, seed=21,
                n_walkers=2, use_radial_updates=True, hmc_integrator="omelyan", target_acceptance=0.7,
                target_density=0.9)
    return SimulationConfig(**{**opts, **kw})


def _model():
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.4, 0.0)
    return tbm, em, holstein_honeycomb_spec(geo)


def _outputs(datafolder):
    """Every bin's datasets and every tuning profile's text."""
    out = {}
    for path in sorted(glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.h5"))):
        with h5py.File(path, "r") as f:
            for cat in ("global", "local", "correlations", "composite"):
                for name, ds in f[cat].items():
                    out[(os.path.basename(path), cat, name)] = ds[()]
    for path in sorted(glob.glob(os.path.join(datafolder, "density_tuning_profile_pID-*.csv"))):
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def test_run_simulation_walkers_writes_output_set(tmp_path):
    """W = 2 with radial updates, Omelyan, dt targeting and mu tuning on the
    CPU: both walkers' bins, the merged bins and statistics, one tuning
    profile a walker, and the JAX package's metadata keys."""
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="mw", sID=1)
    cfg = _config()
    md = run_simulation(info, tbm, em, spec, cfg, device="cpu")
    files = set(os.listdir(info.datafolder))
    assert {"model_summary.toml", "simulation_info_pID-0.toml", "binned_data.h5", "stats.h5", "bins",
            "global_stats.csv", "density_tuning_profile_pID-0.csv", "density_tuning_profile_pID-1.csv"} <= files
    assert sorted(os.listdir(os.path.join(info.datafolder, "bins"))) == sorted(
        f"bin-{b}_pID-{p}.h5" for p in (0, 1) for b in (0, 1))
    assert not glob.glob(os.path.join(info.datafolder, "checkpoint_*"))
    assert JAX_KEYS <= set(md) and md["n_walkers"] == 2 and md["all_converged"]
    assert len(md["final_mu_per_walker"]) == 2 and md["final_mu_per_walker"] != [0.0, 0.0]
    dt0 = np.pi / (2 * cfg.Nt)
    assert dt0 / 8 <= md["hmc_dt_final"] <= 8 * dt0 and md["hmc_dt_final"] != dt0
    for p in (0, 1):
        with open(os.path.join(info.datafolder, f"density_tuning_profile_pID-{p}.csv")) as f:
            rows = f.read().splitlines()
        # one row a tuner update: every thermalization and measured sweep
        assert rows[0] == "step mu n Nsqrd" and len(rows) == 1 + cfg.N_therm + cfg.N_measurements
        assert float(rows[-1].split()[1]) == md["final_mu_per_walker"][p]
    with h5py.File(os.path.join(info.datafolder, "binned_data.h5"), "r") as f:
        assert f["global"]["density"].shape[0] == 4
        mu_bins = f["global"]["chemical_potential"][()].real
        assert np.all(np.isfinite(mu_bins)) and len(set(mu_bins.tolist())) > 1


def test_simulate_walkers_yields_per_walker_bins(tmp_path):
    """simulate at W = 2 yields (pID, bin index, tree) for each walker and
    bin; a walker's bins hold its own tuned chemical potential. A `recenter`
    passed to simulate acts on one walker's field after every drift: Nt + 1
    calls a walker and leapfrog trajectory."""
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="mw_sim", sID=1)
    cfg = _config(use_radial_updates=False, hmc_integrator="leapfrog")
    seen = []

    def recenter(x):
        seen.append(tuple(x.shape))
        return x - 0.1 * x.mean()

    run = simulate(info, tbm, em, spec, cfg, device="cpu", recenter=recenter)
    items = []
    while True:
        try:
            items.append(next(run))
        except StopIteration as done:
            md, finished = done.value
            break
    assert finished and [(p, b) for p, b, _ in items] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    mus = {p: float(tree["global"]["chemical_potential"][0]) for p, b, tree in items if b == 1}
    assert mus[0] != mus[1] and md["radial_acceptance_rate"] == md["reflection_acceptance_rate"]
    assert len(seen) == (cfg.N_therm + cfg.N_measurements) * cfg.n_walkers * (cfg.Nt + 1)
    assert len(set(seen)) == 1 and len(seen[0]) == 2 and seen[0][1] == round(cfg.beta / cfg.dtau)


@pytest.mark.parametrize("interrupts", ["once", "every-sweep"])
def test_walkers_resume_is_bit_identical(tmp_path, interrupts):
    """W = 2 with mu tuning and dt targeting, interrupted once after the
    first thermalization sweep or after every sweep until the first bins
    are out: the bins, the tuning profiles, the final mu and dt equal the
    uninterrupted run's bit for bit."""
    tbm, em, spec = _model()
    ref_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="uninterrupted", sID=1)
    ref_md = run_simulation(ref_info, tbm, em, spec, _config(seed=33), device="cpu")
    ref = _outputs(ref_info.datafolder)
    assert len([k for k in ref if isinstance(k, str)]) == 2

    def info():
        return SimulationInfo(filepath=str(tmp_path), datafolder_prefix="interrupted", sID=1)

    stop = _config(seed=33, checkpoint_freq_hours=0.0 if interrupts == "once" else np.inf, runtime_limit_hours=0.0)
    run_simulation(info(), tbm, em, spec, stop, device="cpu")
    n_runs = 1
    if interrupts == "every-sweep":
        first_bin = os.path.join(info().datafolder, "bins", "bin-0_pID-1.h5")
        for _ in range(stop.N_therm + stop.N_measurements // stop.N_bins):
            if os.path.exists(first_bin):
                break
            run_simulation(info(), tbm, em, spec, stop, device="cpu")
            n_runs += 1
        assert os.path.exists(first_bin) and glob.glob(os.path.join(info().datafolder, "checkpoint_*.pkl"))
    md = run_simulation(info(), tbm, em, spec, dataclasses.replace(stop, runtime_limit_hours=np.inf), device="cpu")
    got = _outputs(info().datafolder)
    assert set(got) == set(ref) and (n_runs > 2 if interrupts == "every-sweep" else True)
    for k in ref:
        if isinstance(k, str):
            assert got[k] == ref[k], k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    for k in ("final_mu_per_walker", "hmc_dt_final", "hmc_acceptance_rate", "radial_acceptance_rate", "hmc_iters",
              "measurement_iters", "precond_fallback_sweeps"):
        assert md[k] == ref_md[k], k
