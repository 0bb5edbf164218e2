"""The port's walker path on SSH models: each walker's own hopping tables in
the batched fermion matrix, the shared preconditioner refresh from the
walker mean of every factor (the hopping factors too, as the JAX package's
parallel/walkers.py:79 averages every leaf), and two measured W = 2 sweeps
of the optical-SSH honeycomb fed the JAX package's draws against its
multi-walker measured sweep, with kernel K3 (Holstein planes) never
reached.

Tolerances: the batched tables equal the per-walker ones exactly; the
shared refresh's action 1e-5 (as tests/test_torch_walkers.py holds it);
the sweeps, with f64 trajectory forces solved to 1e-11, flags equal,
Delta H 1e-9 and fields 1e-10 relative (tests/test_torch_ssh_simulation.py
holds the f32 force path at W = 1), bins 1e-4 of each output's largest
magnitude (f32 measurements).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_common import np64, t64
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_ssh_simulation import assert_bins_match, ssh_chains

from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates.context import make_fdm as jmake_fdm
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.measure.container import MeasurementAccumulator
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.models import library
from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral, spectral_apply
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.context import make_fdm
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, k3_trajectory_applies

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import _common as jexamples  # noqa: E402

torch.set_num_threads(2)


def _walker_chains(W, seed, **opts):
    geo, tbm, jctx, jstate, pctx, pstate = ssh_chains(seed=seed, **opts)
    jstates = jwalkers.init_walker_states(jctx, jstate, W, seed=seed + 1)
    pstates = convert.walker_states(jstates.x, precond=pstate.precond, device="cpu")
    return geo, tbm, jctx, jstates, pctx, pstates


def test_batched_fdm_has_per_walker_tables():
    """make_fdm of a (W, n_phonon, Ltau) field with SSH couplings: walker w's
    hopping factors and checkerboard planes are its own, and M on the batch
    is M of each walker."""
    _, _, _, _, pctx, pstates = _walker_chains(3, 5)
    fdm = make_fdm(pctx, pstates.x)
    assert fdm.cosh_hop.shape == (3, pctx.Ltau, pctx.tbp.n_hops) and fdm.cb.C.shape[1:3] == (3, 1)
    v = t64(np.random.default_rng(1).standard_normal((3, 2, pctx.Ltau, pctx.n_sites)))
    Mv = fdm.mul_M(v)
    for w in range(3):
        one = make_fdm(pctx, pstates.x[w])
        assert torch.equal(fdm.cosh_hop[w], one.cosh_hop)
        assert torch.allclose(fdm.cb.S[:, w, 0], one.cb.S, rtol=1e-15, atol=0)
        assert torch.allclose(Mv[w], one.mul_M(v[w]), rtol=0, atol=1e-14)
    assert not torch.equal(fdm.cosh_hop[0], fdm.cosh_hop[1])


def test_shared_precond_refresh_averages_hoppings():
    """The walker-mean refresh with SSH couplings, compared by the
    preconditioner's action with the JAX package's: 1e-5. It averages the
    hopping factors: a refresh from the mean exp(-dtau V) alone (one
    walker's hoppings) is off by more than 1e-4."""
    _, _, jctx, jstates, pctx, pstates = _walker_chains(3, 5)
    jpre = jax.tree_util.tree_map(lambda a: a[0], jwalkers.shared_precond_refresh(jctx, jstates).precond)
    pnew = walkers.shared_precond_refresh(pctx, pstates)
    r = np.random.default_rng(91).standard_normal((2, pctx.Ltau, pctx.n_sites))
    ref = np64(jspectral_apply(jpre, jnp.asarray(r)))
    got = spectral_apply(pnew.precond[0], t64(r)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
    fdm = make_fdm(pctx, pstates.x)
    one = dataclasses.replace(make_fdm(pctx, pstates.x[0]), exp_nV=fdm.exp_nV.mean(dim=0)[0])
    stale = spectral_apply(build_spectral(one), t64(r)).numpy()
    assert np.max(np.abs(stale - ref)) / np.max(np.abs(ref)) > 1e-4


def test_f32_walker_sweep_keeps_k3_off():
    """The W = 2 sweep with the shared preconditioner and f32 forces (where a
    Holstein model's trajectories run through K3): with SSH couplings every
    walker's force runs the plain chain, and the sweep converges."""
    _, _, _, _, pctx, pstates = _walker_chains(2, 3)
    assert not k3_trajectory_applies(pctx, pstates.precond[0])
    gen = torch.Generator().manual_seed(5)
    draws = [walkers.draw_walker(gen, pctx, pstates.precond[w], HMCParams(Nt=3)) for w in range(2)]
    k3 = PCG_FORCE.plain_calls
    pstates, st = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=3), draws)
    assert PCG_FORCE.plain_calls == k3
    assert all(s.converged for ups in st for s in ups) and all(np.isfinite(h.delta_H) for h in st.hmc)


def test_measured_ssh_walker_sweeps_match_jax_draws():
    """Two measured sweeps at W = 2 from the same fields with each walker's
    JAX draws, the trajectory forces in f64 solved to 1e-11 (so that the
    two packages' chains agree to rounding): the same accept flags, Delta H
    to 1e-9, the fields to 1e-10 relative, and each walker's bin; the
    trajectories run walker by walker (no K3 launch)."""
    W, Nt, Nrv, tol = 2, 4, 3, 1e-10
    geo, tbm, jctx, jstates, pctx, pstates = _walker_chains(W, 4, force_dtype="float64", tol_force=1e-11)
    jspec = jexamples.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    pspec = library.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    jest = jge.build_greens_estimator(jctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32")
    pest = build_greens_estimator(pctx.Ltau, 2, geo.L, Nrv=Nrv, dtype="float32", device="cpu")
    hp = jhmc.HMCParams(Nt=Nt, refresh_precond_at_start=False, fused_step_force=True)

    @jax.jit
    def jax_measured(s, key):
        s = jwalkers.shared_precond_refresh(jctx, s)

        def one(s1):
            s1, r = jglobal.reflection_update(jctx, s1)
            s1, sw = jglobal.swap_update(jctx, s1)
            s1, h = jhmc.hmc_update(jctx, s1, hp)
            return s1, jnp.stack([r.accepted, sw.accepted, h.accepted]), h.delta_H

        s, flags, dH = jax.vmap(one)(s)
        key, sub = jax.random.split(key)

        def meas(s1, k):
            upd = jge.update_greens_estimator(jest, jmake_fdm(jctx, s1.x), k, precond=s1.precond, tol=tol,
                                              maxiter=10_000, mixed=True, solve_dtype="float32")
            return jcontainer.make_measurements(jctx, jspec, upd.estimator, s1.x)

        return s, key, jax.vmap(meas)(s, jax.random.split(sub, W)), flags, dH

    n_cands, n_pairs = len(_candidate_modes(pctx, None)), len(_type_pairs(pctx, None))
    L, N, n_ph, n_cells = pctx.Ltau, pctx.n_sites, pctx.elph.n_phonon, pctx.elph.n_cells
    key_host = jax.random.PRNGKey(17)
    keys = list(jstates.key)
    jaccs = [jcontainer.MeasurementAccumulator(jspec) for _ in range(W)]
    paccs = [MeasurementAccumulator(pspec) for _ in range(W)]
    k3 = PCG_FORCE.plain_calls
    for _ in range(2):
        draws = []
        for w in range(W):
            rd, keys[w] = _reflection_draws(keys[w], n_cands, L, N)
            sd, keys[w] = _swap_draws(keys[w], n_pairs, n_cells, L, N)
            hd, keys[w] = _hmc_draws(keys[w], n_ph, L, N)
            draws.append(walkers.WalkerDraws(rd, sd, hd))
        _, sub = jax.random.split(key_host)
        thetas = [t64(np64(jax.random.uniform(k, (Nrv, L, N), maxval=2.0 * np.pi))) for k in jax.random.split(sub, W)]
        jstates, key_host, jout, jflags, jdH = jax_measured(jstates, key_host)
        pstates, st = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=Nt), draws)
        m = walkers.walker_measure(pctx, pspec, pstates, pest, thetas, tol=tol, maxiter=10_000, mixed=True,
                                   solve_dtype="float32")
        for w in range(W):
            assert [s[w].accepted for s in st] == [bool(f) for f in np.asarray(jflags[w])]
            assert all(s[w].converged for s in st) and bool(m.updates[w].converged)
            assert abs(st.hmc[w].delta_H - float(jdH[w])) <= 1e-9
            jaccs[w].accumulate(jax.tree_util.tree_map(lambda a: a[w], jout))
            paccs[w].accumulate(m.outs[w])
    assert PCG_FORCE.plain_calls == k3
    for w in range(W):
        np.testing.assert_array_equal(np.asarray(keys[w]), np.asarray(jstates.key[w]))
        xj = np64(jstates.x[w])
        assert np.max(np.abs(pstates.x[w].numpy() - xj)) <= 1e-10 * np.max(np.abs(xj))
        assert_bins_match(jaccs[w].finalize_bin(), paccs[w].finalize_bin(), tag=w)
