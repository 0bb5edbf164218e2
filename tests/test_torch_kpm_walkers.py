"""The port's walker path with the KPM preconditioner: one W = 2 walker sweep
fed the JAX package's draws against its vmapped walker_sweep, with the
shared refresh (its Lanczos start vector jax.random.normal(key[0]), walker
0's key at the sweep's start, as the JAX package draws it) and in per-walker
mode (each walker's trajectory-start refresh from its own k_pre0), in both
factorizations; the KPM diagnostics folded over the walkers against the JAX
package's fold_kpm_diagnostics; the driver at W = 2; and a measured W = 2
KPM run_simulation interrupted and resumed.

Both packages run the matrix-free apply (the port's MATRIX_FREE_MIN_SITES
set to 0, so that the plain versions of K6 / K7 run; SMOQY_KPM_MATRIX_FREE=1
on the JAX side, whose XLA recurrence runs on the CPU).

Tolerances (the f32-force tolerances of tests/test_torch_kpm.py and
tests/test_torch_walkers.py): accept flags equal, Delta H 1e-5, each
walker's end field 1e-6 relative, the refreshed preconditioner's bounds
1e-10 relative and coefficients 1e-6 of their largest value; a resumed
run's bins equal the uninterrupted run's bit for bit.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import both_models, np64, t64
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_kpm import _check_state, _v0
from test_torch_multiwalker import _outputs

from smoqyelphqmc_tpu import driver as jdriver
from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates.context import make_fdm
from smoqyelphqmc_tpu_torch import convert, driver
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_simulation, run_updates
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec
from smoqyelphqmc_tpu_torch.ops import kpm as pkpm
from smoqyelphqmc_tpu_torch.ops import mtm
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
from smoqyelphqmc_tpu_torch.ops.kpm_mf import KPM_MF, KPM_MF_ASYM
from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

torch.set_num_threads(2)

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]
MODES = [pytest.param(True, id="shared"), pytest.param(False, id="perwalker")]


@pytest.fixture
def matrix_free(monkeypatch):
    monkeypatch.setenv("SMOQY_KPM_MATRIX_FREE", "1")
    monkeypatch.setattr(pkpm, "MATRIX_FREE_MIN_SITES", 0)


def walker_chains(jtbp, jelph, W, seed, **opts):
    """Both packages' W-walker states from one chain (the JAX package's
    init_walker_states jitter, its initial KPM start vector
    split(PRNGKey(seed))[1] handed to the port)."""
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    dim = 2 * jctx.n_sites if make_fdm(jctx, jstate.x).complex_hops else jctx.n_sites
    v_init = t64(_v0(jax.random.split(jax.random.PRNGKey(seed))[1], dim)) if opts["preconditioner"] == "kpm" else None
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), lanczos_v0=v_init, **opts)
    assert pctx.lanczos_dim == dim
    jstates = jwalkers.init_walker_states(jctx, jstate, W, seed=seed + 1)
    return jctx, jstates, pctx, convert.walker_states(jstates.x, precond=pstate.precond, device="cpu")


def replay_walker_sweep(jctx, jstates, pctx, pstates, Nt, shared):
    """One walker sweep in both packages from the same fields and
    preconditioner, the port fed each walker's JAX draws: its reflection,
    swap and HMC keys, its trajectory-start Lanczos vector k_pre0, and the
    shared refresh's normal(key[0]). Holds every walker's accept flags,
    Delta H (1e-5) and end field (1e-6 relative) to the JAX package's.
    Returns (JAX states, port states, port SweepStats)."""
    W = pstates.n_walkers
    hp = jhmc.HMCParams(Nt=Nt)
    jout, (jr, js, jh) = jax.jit(lambda s: jwalkers.walker_sweep(jctx, s, hp, shared_precond=shared))(jstates)
    kpm = isinstance(pstates.precond[0], KPMPreconditioner)
    dim, L, N = pctx.lanczos_dim, pctx.Ltau, pctx.n_sites
    n_cands, n_pairs = len(_candidate_modes(pctx, None)), len(_type_pairs(pctx, None))
    draws = []
    for w in range(W):
        rd, key = _reflection_draws(jstates.key[w], n_cands, L, N)
        sd, key = _swap_draws(key, n_pairs, pctx.elph.n_cells, L, N)
        hd, _ = _hmc_draws(key, pctx.elph.n_phonon, L, N)
        if kpm:
            hd.v_pre0 = t64(_v0(jax.random.split(key, 6)[5], dim))
        draws.append(walkers.WalkerDraws(rd, sd, hd))
    v_shared = t64(_v0(jstates.key[0], dim)) if kpm and shared else None
    pout, st = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=Nt), draws, shared_precond=shared, v_shared=v_shared)
    xj = np64(jout.x)
    for w in range(W):
        assert (st.reflection[w].accepted, st.swap[w].accepted, st.hmc[w].accepted) == (
            bool(jr.accepted[w]), bool(js.accepted[w]), bool(jh.accepted[w]))
        assert all(s[w].converged for s in st) and bool(jh.converged[w])
        assert abs(st.hmc[w].delta_H - float(jh.delta_H[w])) <= 1e-5, (w, st.hmc[w].delta_H, float(jh.delta_H[w]))
        assert np.max(np.abs(pout.x[w].numpy() - xj[w])) <= 1e-6 * np.max(np.abs(xj[w]))
    assert np.max(np.abs(xj - np64(jstates.x))) > 1e-3
    return jout, pout, st


@pytest.mark.parametrize("shared", MODES)
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_walker_sweep_matches_jax_draws(symmetric, shared, matrix_free):
    """W = 2 on the honeycomb L=2 with the matrix-free KPM preconditioner:
    each walker's flags, Delta H and field; the walkers' preconditioners
    after the sweep are the JAX package's (one shared refresh, or each
    walker's own trajectory-start refresh); the solves ran K1's and K6 /
    K7's plain versions and K3 stayed off."""
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", L=2, beta=1.0, alpha=0.5)
    opts = dict(symmetric=symmetric, mixed_precision=True, force_dtype="float32", preconditioner="kpm")
    jctx, jstates, pctx, pstates = walker_chains(jtbp, jelph, 2, 4, **opts)
    assert pstates.precond[0].matrix_free and pstates.precond[0].active
    kpm_calls = (KPM_MF if symmetric else KPM_MF_ASYM).plain_calls
    k1, k3 = mtm.MTM[torch.float32].plain_calls, PCG_FORCE.plain_calls
    jout, pout, _ = replay_walker_sweep(jctx, jstates, pctx, pstates, 4, shared)
    assert (KPM_MF if symmetric else KPM_MF_ASYM).plain_calls > kpm_calls
    assert mtm.MTM[torch.float32].plain_calls > k1 and PCG_FORCE.plain_calls == k3
    assert (pout.precond[0] is pout.precond[1]) == shared
    for w in range(2):
        _check_state(pout.precond[w], jax.tree_util.tree_map(lambda a: a[w], jout.precond))


def test_fold_kpm_diagnostics_matches_jax(matrix_free):
    """The diagnostics over W = 2 walkers, one inactive and one whose orders
    were clipped: the JAX package's keys and values, and its warnings."""
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", L=2, beta=1.0, alpha=0.5)
    opts = dict(mixed_precision=True, force_dtype="float32", preconditioner="kpm")
    _, jstates, _, pstates = walker_chains(jtbp, jelph, 2, 4, **opts)
    jpre = dataclasses.replace(jstates.precond, active=jnp.asarray([True, False]),
                               order_clip_count=jnp.asarray([3, 0], jnp.int32))
    ppre = [dataclasses.replace(pstates.precond[0], active=True, order_clip_count=3),
            dataclasses.replace(pstates.precond[0], active=False, order_clip_count=0)]
    for jp, pp in ((jpre, ppre), (jstates.precond, pstates.precond)):
        jmd, pmd = {}, {}
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jdriver.fold_kpm_diagnostics(jmd, jp)
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            driver.fold_kpm_diagnostics(pmd, pp)
        assert pmd == jmd and set(pmd) == {"kpm_active", "kpm_inactive_walkers", "kpm_order_clip_count"}
        assert len(pw) == len(jw)
    assert pmd == {"kpm_active": True, "kpm_inactive_walkers": 0, "kpm_order_clip_count": 0}
    no_kpm = {}
    driver.fold_kpm_diagnostics(no_kpm, [None, None])
    assert no_kpm == {}


@pytest.mark.parametrize("symmetric", SYM)
def test_run_updates_kpm_walkers_on_cpu(symmetric, matrix_free):
    """run_updates at W = 2 with 'kpm' in shared mode and per walker: every
    solve converges, every walker's KPM stays active; in per-walker mode
    walker w's chain is the same at W = 2 and W = 3 (its draws come from its
    own generator), and a shared sweep's start vector comes from a stream no
    walker draws from; the two shared sweeps as one batch
    (sweeps_per_dispatch=2) end at the same fields."""
    _, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    kw = dict(beta=1.0, dtau=0.1, Nt=4, seed=3, preconditioner="kpm", n_walkers=2, symmetric=symmetric)
    shared_md = None
    for shared in (True, False):
        cfg = SimulationConfig(**kw, shared_precond=shared)
        md = run_updates(tbm, em, cfg, 2, device="cpu")
        shared_md = shared_md or md
        assert md["all_converged"] and md["walker_converged"] == [True, True]
        assert np.isfinite(md["hmc_delta_H"]).all() and np.asarray(md["hmc_delta_H"]).shape == (2, 2)
        assert (md["kpm_active"], md["kpm_inactive_walkers"], md["kpm_order_clip_count"]) == (True, 0, 0)
        assert md["precond_fallback_sweeps"] == (0 if shared else 2)
        md3 = run_updates(tbm, em, dataclasses.replace(cfg, n_walkers=3), 2, device="cpu")
        assert md3["all_converged"]
        if not shared:
            assert torch.equal(md3["x_final"][:2], md["x_final"])
    # one batch of both sweeps: the controller's one choice (shared) gives k = 1's chain
    batched = run_updates(tbm, em, SimulationConfig(**kw, sweeps_per_dispatch=2), 2, device="cpu")
    assert torch.equal(batched["x_final"], shared_md["x_final"])


def test_measured_kpm_walkers_resume_is_bit_identical(tmp_path, matrix_free):
    """run_simulation at W = 2 with the matrix-free KPM preconditioner: every
    solve converges, every walker's KPM stays active, both walkers' bins are
    written; interrupted after its first sweep and resumed, the run writes
    the uninterrupted run's bins bit for bit (the checkpoint carries the
    walkers' preconditioners and the shared refresh's stream)."""
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    spec = holstein_honeycomb_spec(geo)
    cfg = SimulationConfig(beta=0.6, dtau=0.1, N_therm=1, N_measurements=2, N_bins=1, Nt=3, Nrv=3, tol=1e-7,
                           seed=9, n_walkers=2, preconditioner="kpm")
    ref_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="ref", sID=1)
    md = run_simulation(ref_info, tbm, em, spec, cfg, device="cpu")
    ref = _outputs(ref_info.datafolder)
    assert md["all_converged"] and md["kpm_active"] and md["kpm_inactive_walkers"] == 0
    assert {k[0] for k in ref} == {"bin-0_pID-0.h5", "bin-0_pID-1.h5"}
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="interrupted", sID=1)
    run_simulation(info, tbm, em, spec, dataclasses.replace(cfg, runtime_limit_hours=0.0), device="cpu")
    assert not os.path.exists(os.path.join(info.datafolder, "bins", "bin-0_pID-0.h5"))
    md2 = run_simulation(info, tbm, em, spec, cfg, device="cpu")
    got = _outputs(info.datafolder)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    for k in ("hmc_acceptance_rate", "hmc_iters", "measurement_iters", "kpm_active", "kpm_order_clip_count"):
        assert md2[k] == md[k], k
