"""Parity of the port's sampler options with the JAX package: the mu tuner,
the radial update, the Omelyan integrator, the recenter hook, the per-step
and per-move preconditioner refreshes, and the acceptance-targeted timestep
law.

Tolerances: the tuner is an f64 chain in the same order of operations
(1e-12 over 50 updates; a checkpoint round trip changes no bit); a radial
move is one f64 solve and an elementwise scaling (x to 1e-12, the accept
flag equal, frozen modes bit for bit unscaled); a trajectory or a global
move fed the JAX package's draws holds the accept flag and the end field to
1e-6 relative (tests/test_torch_hmc.py's bound, f32 forces solved to 1e-5 in
both), and Delta H to 1e-8 of H0: the JAX package's own two force paths
(its fused kernels in interpret mode and its XLA chain) part by 2.5e-6 on
the Omelyan trajectory here (H0 = 471), beyond the 1e-6 absolute bound that
tests/test_torch_hmc.py's leapfrog case meets. Iterations per solve are compared where
both packages apply the same bf16 preconditioner (the JAX package's fused
kernels in interpret mode against the port's plain K2 / K3): within one
iteration per solve, the f32 sums running in another order. The timestep
law is exact: the same IEEE operations on the same flags.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smoqyelphqmc_tpu as J
import smoqyelphqmc_tpu_torch as P
from _torch_common import np64, t64
from test_torch_hmc import _both_chains, _hmc_draws, _jax_normal_pair, _reflection_draws

from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu.updates import mu_tuner as jtuner
from smoqyelphqmc_tpu_torch.driver import dt_law
from smoqyelphqmc_tpu_torch.io.checkpoint import _to_host
from smoqyelphqmc_tpu_torch.ops import pcg_force
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.context import QMCState, initialize_qmc
from smoqyelphqmc_tpu_torch.updates.global_updates import (
    RadialDraws,
    _candidate_modes,
    _type_pairs,
    radial_update,
    reflection_update,
)
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update
from smoqyelphqmc_tpu_torch.updates.mu_tuner import init_mu_tuner, mu_tuner_update, update_chemical_potential

OPTS = dict(mixed_precision=True, force_dtype="float32", preconditioner="spectral")


@pytest.fixture
def fused_env(monkeypatch):
    """The JAX package's fused kernels in interpret mode: its solves then
    apply the bf16 preconditioner, as the port's K2 and K3 do."""
    monkeypatch.setenv("SMOQY_FUSED_CG", "interpret")
    monkeypatch.setenv("SMOQY_FUSED_FORCE", "1")


# ----------------------------------------------------------------------
# the mu tuner
# ----------------------------------------------------------------------


def _measurements(seed, n_updates, W, V):
    """A seeded (n, <N^2>) sequence as the driver feeds it (f32 values)."""
    rng = np.random.default_rng(seed)
    n = (0.9 + 0.1 * rng.standard_normal((n_updates, W))).astype(np.float32)
    N2 = ((n.astype(np.float64) * V) ** 2 + 2.0 + rng.random((n_updates, W))).astype(np.float32)
    return n, N2


@pytest.mark.parametrize("W", [1, 2], ids=["W1-floats", "W2-tensors"])
def test_mu_tuner_matches_jax(W):
    """50 updates on a seeded sequence: every leaf to 1e-12 after each
    update (one tuner a walker at W = 2, as the JAX driver vmaps them)."""
    V, target, beta, mu0 = 8, 0.8, 4.0, 0.1
    n, N2 = _measurements(3, 50, W, V)
    jt = jtuner.init_mu_tuner(target, beta, V, mu0)
    jt = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (W,)), jt)
    jstep = jax.jit(jax.vmap(jtuner.mu_tuner_update))
    pt = init_mu_tuner(target, beta, V, mu0, n_walkers=W if W > 1 else 0)
    for k in range(50):
        jt = jstep(jt, jnp.asarray(n[k]), jnp.asarray(N2[k]))
        pt = mu_tuner_update(pt, float(n[k, 0]) if W == 1 else torch.as_tensor(n[k]),
                             float(N2[k, 0]) if W == 1 else torch.as_tensor(N2[k]))
        for name, got in pt.leaves().items():
            ref = np64(getattr(jt, name))
            got = np.atleast_1d(np.asarray(got, dtype=np.float64))
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, err_msg=f"{name} after {k + 1}")
    assert isinstance(pt.mu, float) if W == 1 else pt.mu.dtype == torch.float64
    if W == 1:  # the functional form, one more update
        jr = jtuner.update_chemical_potential(jax.tree_util.tree_map(lambda a: a[0], jt), n[0, 0], N2[0, 0])
        pr = update_chemical_potential(pt, float(n[0, 0]), float(N2[0, 0]))
        assert pr.mu == pr.tuner.mu and abs(pr.mu - float(jr.mu)) <= 1e-12


@pytest.mark.parametrize("W", [1, 2], ids=["W1-floats", "W2-tensors"])
def test_mu_tuner_checkpoint_round_trip_is_bit_identical(W):
    """A tuner pickled through the checkpoint's host conversion and restored
    continues bit for bit."""
    V = 8
    n, N2 = _measurements(4, 20, W, V)
    feed = (lambda k, a: float(a[k, 0])) if W == 1 else (lambda k, a: torch.as_tensor(a[k]))
    pt = init_mu_tuner(1.0, 4.0, V, 0.0, n_walkers=W if W > 1 else 0)
    for k in range(10):
        pt = mu_tuner_update(pt, feed(k, n), feed(k, N2))
    restored = pt.with_leaves(pickle.loads(pickle.dumps(_to_host(pt.leaves()))))
    for k in range(10, 20):
        pt = mu_tuner_update(pt, feed(k, n), feed(k, N2))
        restored = mu_tuner_update(restored, feed(k, n), feed(k, N2))
    for name, v in pt.leaves().items():
        assert np.array_equal(np.asarray(v), np.asarray(restored.leaves()[name])), name


# ----------------------------------------------------------------------
# the radial update
# ----------------------------------------------------------------------


def _frozen_honeycomb(pkg, L=2, beta=0.6, dtau=0.1, alpha=0.5, **kw):
    """The honeycomb Holstein model with its second phonon mode frozen
    (M = inf), built with either package's classes from one seed."""
    geo = pkg.ModelGeometry(pkg.UnitCell(lattice_vecs=[[1.5, np.sqrt(3) / 2], [1.5, -np.sqrt(3) / 2]],
                                         basis_vecs=[[0.0, 0.0], [1.0, 0.0]]),
                            pkg.Lattice(L=[L, L], periodic=[True, True]))
    bonds = [pkg.Bond(orbitals=(0, 1), displacement=d) for d in ([0, 0], [-1, 0], [0, -1])]
    for b in bonds:
        geo.add_bond(b)
    tbm = pkg.TightBindingModel(model_geometry=geo, t_bonds=bonds, t_mean=[1.0] * 3, eps_mean=[0.0, 0.0], mu=0.0)
    em = pkg.ElectronPhononModel(model_geometry=geo, tight_binding_model=tbm)
    p1 = em.add_phonon_mode(pkg.PhononMode(basis_vec=[0.0, 0.0], Omega_mean=1.0))
    p2 = em.add_phonon_mode(pkg.PhononMode(basis_vec=[1.0, 0.0], Omega_mean=1.0, M=np.inf))
    for p, orb in ((p1, 0), (p2, 1)):
        em.add_holstein_coupling(pkg.HolsteinCoupling(phonon_id=p, orbital_id=orb, displacement=[0, 0],
                                                      alpha_mean=alpha, ph_sym_form=True))
    rng = np.random.default_rng(0)
    tbp = pkg.TightBindingParameters.from_model(tbm, rng, **kw)
    return tbp, pkg.ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, **kw)


@pytest.mark.parametrize("seed,sigma", [(5, 1.0), (6, 1.0), (7, 2.0)])
def test_radial_update_matches_jax_draws(seed, sigma):
    """One radial move from the same field (every mode non-zero, the frozen
    ones too) with the JAX package's draws: the same accept flag, x to
    1e-12, the frozen modes' rows bit for bit unscaled."""
    jtbp, jelph = _frozen_honeycomb(J)
    ptbp, pelph = _frozen_honeycomb(P, device="cpu")
    assert pelph.frozen_mask.any() and not pelph.frozen_mask.all()
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **OPTS)
    pctx, pstate = initialize_qmc(ptbp, pelph, **OPTS)
    x0 = 0.5 * np.random.default_rng(seed).standard_normal(np64(jstate.x).shape)
    jstate = jstate.replace(x=jnp.asarray(x0))
    pstate = QMCState(x=t64(x0), precond=pstate.precond)
    jnew, jst = jax.jit(lambda s: jglobal.radial_update(jctx, s, sigma=sigma))(jstate)
    _, k_gamma, k_phi, k_acc, _ = jax.random.split(jstate.key, 5)
    draws = RadialDraws(z=float(jax.random.normal(k_gamma)), R=_jax_normal_pair(k_phi, pctx.Ltau, pctx.n_sites),
                        u_acc=float(jax.random.uniform(k_acc)))
    pnew, pst = radial_update(pctx, pstate, draws, sigma=sigma)
    assert pst.accepted == bool(jst.accepted) and pst.converged and bool(jst.converged)
    assert abs(pst.delta_S - float(jst.delta_S)) <= 1e-8 * max(1.0, abs(float(jst.delta_S)))
    np.testing.assert_allclose(pnew.x.numpy(), np64(jnew.x), rtol=1e-12, atol=1e-12)
    frozen = pelph.frozen_mask
    assert np.array_equal(pnew.x.numpy()[frozen], x0[frozen])
    if pst.accepted:
        assert not np.array_equal(pnew.x.numpy()[~frozen], x0[~frozen])


def test_radial_update_rejects_empty_selection():
    _, _, pctx, pstate = _both_chains(L=2, beta=0.4)
    pctx.elph.frozen_mask = np.ones_like(pctx.elph.frozen_mask)
    with pytest.raises(ValueError, match="no unfrozen"):
        radial_update(pctx, pstate, RadialDraws(z=0.1, R=None, u_acc=0.5))


# ----------------------------------------------------------------------
# trajectories and global moves fed the JAX package's draws
# ----------------------------------------------------------------------


# the mean over the whole of one walker's field: applied to a walker batch
# at once instead of walker by walker, it would mix the walkers
def _jax_recenter(x):
    return x - 0.1 * jnp.mean(x)


def _torch_recenter(x):
    return x - 0.1 * x.mean()


TRAJECTORIES = [
    pytest.param(dict(integrator="omelyan"), {}, id="omelyan"),
    pytest.param({}, dict(recenter=True), id="recenter"),
    pytest.param(dict(refresh_precond_every_step=True), {}, id="refresh-every-step"),
    pytest.param(dict(integrator="omelyan", refresh_precond_every_step=True), dict(recenter=True),
                 id="omelyan-recenter-refresh"),
]


@pytest.mark.parametrize("params,extra", TRAJECTORIES)
def test_trajectory_options_match_jax_draws(params, extra, fused_env):
    """One trajectory (Nt=4) from the same field and draws: the same accept
    flag, Delta H (1e-8 of H0), end field (1e-6 relative) and iterations per
    solve (within 1, both with the bf16 preconditioner)."""
    jctx, jstate, pctx, pstate = _both_chains(seed=8, L=2, beta=1.0, alpha=0.5)
    recenter = extra.get("recenter", False)
    jp = jhmc.HMCParams(Nt=4, **params)
    jnew, jst = jax.jit(lambda s: jhmc.hmc_update(jctx, s, jp, recenter=_jax_recenter if recenter else None))(jstate)
    draws, _ = _hmc_draws(jstate.key, pctx.elph.n_phonon, pctx.Ltau, pctx.n_sites)
    pnew, pst = hmc_update(pctx, pstate, HMCParams(Nt=4, **params), draws,
                           recenter=_torch_recenter if recenter else None)
    assert pst.converged and bool(jst.converged) and pst.accepted == bool(jst.accepted)
    assert abs(pst.delta_H - float(jst.delta_H)) <= 1e-8 * abs(pst.H0)
    xj = np64(jnew.x)
    assert np.max(np.abs(pnew.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    assert abs(pst.iters_avg - float(jst.iters_avg)) <= 1.0
    if params.get("refresh_precond_every_step"):
        assert pnew.precond is not pstate.precond
    assert pst.accepted and np.max(np.abs(xj - np64(jstate.x))) > 1e-3


def test_omelyan_warm_starts_cut_iterations():
    """Omelyan's linear warm starts with the alternating spacing ratios take
    fewer iterations over the 2 Nt + 1 solves than cold starts (their
    counts against the JAX package's are held above)."""
    _, jstate, pctx, pstate = _both_chains(seed=9, L=2, beta=1.0, alpha=0.5)
    draws, _ = _hmc_draws(jstate.key, pctx.elph.n_phonon, pctx.Ltau, pctx.n_sites)
    from smoqyelphqmc_tpu_torch.updates import hmc as phmc

    counts, orig = {}, phmc._linear_warm_start
    for name, fn in (("warm", orig), ("cold", lambda hist, c: torch.zeros_like(hist[0]))):
        phmc._linear_warm_start = fn
        try:
            _, st = hmc_update(pctx, pstate, HMCParams(Nt=6, integrator="omelyan"), draws)
        finally:
            phmc._linear_warm_start = orig
        assert st.converged
        counts[name] = st.iters_avg
    assert counts["warm"] < counts["cold"]


@pytest.mark.parametrize("recenter", [False, True], ids=["omelyan", "omelyan-recenter"])
def test_omelyan_walker_sweep_matches_jax_draws(recenter, fused_env):
    """One W = 2 walker sweep with Omelyan (shared refresh, both kicks of each
    step through K3's plain version: 2 Nt calls) from each walker's JAX
    draws, with and without a recenter (walker by walker in the port, vmapped
    in the JAX package): the same flags, Delta H (1e-8 of H0), iterations per
    solve (within 1) and end fields (1e-6 relative)."""
    from test_torch_walkers import _both_walker_chains

    W, Nt = 2, 3
    jctx, jstates, pctx, pstates = _both_walker_chains(W, 2, L=2, beta=1.0, alpha=0.5)
    jp = jhmc.HMCParams(Nt=Nt, integrator="omelyan")
    jrc, prc = (_jax_recenter, _torch_recenter) if recenter else (None, None)
    jout, (jr, js, jh) = jax.jit(lambda s: jwalkers.walker_sweep(jctx, s, jp, recenter=jrc))(jstates)
    n_cands, n_pairs = len(_candidate_modes(pctx, None)), len(_type_pairs(pctx, None))
    L, N, n_ph, n_cells = pctx.Ltau, pctx.n_sites, pctx.elph.n_phonon, pctx.elph.n_cells
    from test_torch_hmc import _swap_draws

    draws = []
    for w in range(W):
        rd, key = _reflection_draws(jstates.key[w], n_cands, L, N)
        sd, key = _swap_draws(key, n_pairs, n_cells, L, N)
        hd, key = _hmc_draws(key, n_ph, L, N)
        draws.append(walkers.WalkerDraws(rd, sd, hd))
    plain = pcg_force.PCG_FORCE.plain_calls
    pout, st = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=Nt, integrator="omelyan"), draws, recenter=prc)
    assert pcg_force.PCG_FORCE.plain_calls == plain + 2 * Nt
    xj = np64(jout.x)
    for w in range(W):
        assert tuple(s[w].accepted for s in st) == (bool(jr.accepted[w]), bool(js.accepted[w]), bool(jh.accepted[w]))
        assert st.hmc[w].converged and bool(jh.converged[w])
        assert abs(st.hmc[w].delta_H - float(jh.delta_H[w])) <= 1e-8 * abs(st.hmc[w].H0)
        assert abs(st.hmc[w].iters_avg - float(jh.iters_avg[w])) <= 1.0
        assert np.max(np.abs(pout.x[w].numpy() - xj[w])) <= 1e-6 * np.max(np.abs(xj[w]))


def test_refresh_precond_every_step_refused_in_shared_batch():
    from test_torch_walkers import _both_walker_chains

    _, _, pctx, pstates = _both_walker_chains(2, 2, L=2, beta=0.4, alpha=0.5)
    params = HMCParams(Nt=2, refresh_precond_at_start=False, refresh_precond_every_step=True)
    with pytest.raises(ValueError, match="shares one preconditioner"):
        hmc_update(pctx, QMCState(x=pstates.x, precond=pstates.precond[0]), params, [None, None])


def test_refresh_precond_global_matches_jax_draws():
    """One reflection with refresh_precond_global: the JAX package's flag,
    Delta S and field, and the preconditioner refreshed at the proposal."""
    jctx, jstate, pctx, pstate = _both_chains(seed=10, L=2, beta=1.0, alpha=0.5)
    jctx = jctx.replace(refresh_precond_global=True)
    pctx.refresh_precond_global = True
    jnew, jst = jax.jit(lambda s: jglobal.reflection_update(jctx, s))(jstate)
    draws, _ = _reflection_draws(jstate.key, len(_candidate_modes(pctx, None)), pctx.Ltau, pctx.n_sites)
    pnew, pst = reflection_update(pctx, pstate, draws)
    assert pst.accepted == bool(jst.accepted) and pst.converged
    assert abs(pst.delta_S - float(jst.delta_S)) <= 1e-8 * max(1.0, abs(float(jst.delta_S)))
    np.testing.assert_allclose(pnew.x.numpy(), np64(jnew.x), rtol=0, atol=1e-12)
    assert pnew.precond is not pstate.precond
    r = np.random.default_rng(11).standard_normal((2, pctx.Ltau, pctx.n_sites))
    from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import spectral_apply

    ref = np64(jspectral_apply(jnew.precond, jnp.asarray(r)))
    got = spectral_apply(pnew.precond, t64(r)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


# ----------------------------------------------------------------------
# the timestep law
# ----------------------------------------------------------------------


@pytest.mark.parametrize("W", [1, 2])
def test_dt_law_matches_jax_exactly(W):
    """The driver's law (JAX driver.py:345-347 at W = 1, the walker-mean
    flag at W >= 2, :815-818) over a fixed flag sequence that reaches both
    clamps: every dt equal, bit for bit."""
    target, dt0 = 0.7, float(np.pi / (2 * 8))
    flags = np.concatenate([np.zeros((45, W)), np.ones((200, W)), np.tile([[1.0] + [0.0] * (W - 1)], (20, 1))])

    @jax.jit
    def jstep(dt, f):
        step = 0.08 * (jnp.mean(f) - target)
        return jnp.clip(dt * jnp.exp(step), dt0 / 8.0, 8.0 * dt0)

    jdt, pdt, seen = jnp.asarray(dt0, jnp.float64), dt0, set()
    for f in flags:
        jdt = jstep(jdt, jnp.asarray(f))
        pdt = dt_law(pdt, sum(float(v) for v in f) / W, target, dt0)
        assert pdt == float(jdt)
        seen.add(pdt)
    assert dt0 / 8.0 in seen and 8.0 * dt0 in seen
