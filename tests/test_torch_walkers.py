"""Parity of the port's walker path with the JAX package: kernel K3 (solve +
force epilogue), kernel K4 (the epilogue alone), the force from the product
planes, the shared preconditioner refresh, the fallback controller and one
walker sweep given the JAX package's draws.

The JAX side runs its Pallas kernels in interpret mode (SMOQY_FUSED_CG=
interpret, SMOQY_FUSED_FORCE=1, as tests/test_pallas.py:139-141, :178-179).
Tolerances (tests/test_pallas.py:182-195): solutions rtol 2e-4 / atol 2e-5;
forces rtol 2e-4 with atol 2e-4 max|F|; Sf 2e-5. With the JAX package's Q and
filt carried over, both K3 versions apply the same bf16 preconditioner, so
their iteration counts may differ only by the f32 summation order (at most
one). The force assembly from given planes is an f64 chain (1e-12); the
preconditioner refresh is compared by its action (1e-5, f32 eigh in both,
bases differ); one sweep at W = 2 holds each walker's accept flags, Delta H
(1e-6) and end field (1e-6 relative), as tests/test_torch_hmc.py does at W = 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import both_models, fdm_pair, np64, t32, t64
from test_torch_hmc import FORCE_CASES, _hmc_draws, _reflection_draws, _swap_draws

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral as jbuild_pi
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct
from smoqyelphqmc_tpu.ops.derivatives import build_force_plan as jplan
from smoqyelphqmc_tpu.ops.derivatives import holstein_force_from_planes as jforce_from_planes
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix as JFdm
from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_force, build_fused_pcg
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
from smoqyelphqmc_tpu.parallel import walkers as jwalkers
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.ops import force as pforce
from smoqyelphqmc_tpu_torch.ops import pcg_force
from smoqyelphqmc_tpu_torch.ops.derivatives import build_force_plan, holstein_force_from_planes
from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda, ldiv_lambda_T
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral, spectral_apply
from smoqyelphqmc_tpu_torch.parallel import walkers
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

TOL, MAXITER = 1e-5, 400


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("SMOQY_FUSED_CG", "interpret")
    monkeypatch.setenv("SMOQY_FUSED_FORCE", "1")


def _forces(P1j, P2j, P1p, P2p, jelph, pelph, x, Lam, plan_j, plan_p):
    """Both packages' forces from their own planes, assembled in f64."""
    fj = np64(jforce_from_planes(jnp.asarray(np64(P1j)), jnp.asarray(np64(P2j)), jelph, jnp.asarray(x),
                                 jnp.asarray(np64(Lam)), plan_j))
    fp = holstein_force_from_planes(t64(P1p), t64(P2p), pelph, t64(x), t64(np64(Lam)), plan_p).numpy()
    return fj, fp


def _assert_force_close(fp, fj):
    np.testing.assert_allclose(fp, fj, rtol=2e-4, atol=2e-4 * float(np.max(np.abs(fj))))


def _walker_fields(x, W, seed):
    return x[None] + 0.1 * np.random.default_rng(seed).standard_normal((W,) + x.shape)


def _problem(name, kw, W, seed):
    """A K3 problem: fields of W walkers, their Lambda planes (f32) and the
    right-hand sides Lambda^{-T} Phi (f32), with the JAX preconditioner."""
    jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), x = fdm_pair(name, kw, x_seed=seed)
    xs = _walker_fields(x, W, seed + 1)
    L, N = jfdm.Ltau, jfdm.n_sites
    Lam = build_lambda(pelph, t64(xs), N).to(torch.float32)
    Phi = torch.as_tensor(np.random.default_rng(seed + 2).standard_normal((W, 2, L, N)), dtype=torch.float32)
    b = ldiv_lambda_T(Lam[:, None], Phi)
    return jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), xs, Lam.numpy(), b.numpy()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name,kw", FORCE_CASES)
def test_pcg_force_plain_matches_pallas_interpret(name, kw, warm):
    """K3's plain version against `FusedPCG.solve_force` (_pcg_force_kernel in
    interpret mode) on one channel pair, cold and warm-started from a
    perturbed solution."""
    jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), xs, Lam, b = _problem(name, kw, 1, seed=41)
    jpre = jbuild_spectral(jfdm)
    fused = build_fused_pcg(jfdm, jpre, interpret=True)
    assert fused is not None and fused.can_force
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jfdm.Ltau, device="cpu")
    want_p2 = bool(np.any(pelph.hol_ph_sym))
    x0 = None
    if warm:
        xc, *_ = fused.solve_force(jnp.asarray(b[0]), jnp.asarray(Lam[0]), tol=TOL, maxiter=MAXITER, want_p2=want_p2)
        x0 = np.asarray(xc) + 0.05 * np.random.default_rng(43).standard_normal(b[0].shape).astype(np.float32)
    xj, P1j, P2j, sj = fused.solve_force(jnp.asarray(b[0]), jnp.asarray(Lam[0]),
                                         x0=None if x0 is None else jnp.asarray(x0), tol=TOL, maxiter=MAXITER,
                                         want_p2=want_p2)
    xp, P1p, P2p, sp = pcg_force.solve_force(pfdm, ppre, t32(b[0]), t32(Lam[0]),
                                             x0=None if x0 is None else t32(x0), tol=TOL, maxiter=MAXITER,
                                             want_p2=want_p2)
    assert bool(sj.converged) and bool(sp.converged) and sp.converged.shape == ()
    assert abs(int(sp.iters) - int(sj.iters)) <= 1
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)
    plan_p = build_force_plan(pelph, pfdm.structure)
    plan_j = jplan(jelph, jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites))
    fj, fp = _forces(P1j, P2j, P1p, P2p, jelph, pelph, xs[0], Lam[0], plan_j, plan_p)
    _assert_force_close(fp, fj)
    if not want_p2:
        assert not P2p.any()
    np.testing.assert_allclose(float(torch.sum(t32(b[0]) * xp)), float(jnp.sum(jnp.asarray(b[0]) * xj)),
                               rtol=2e-5)


def test_pcg_force_plain_walker_batch_matches_vmap():
    """K3's plain version on W = 2 walkers (per-walker expV and Lambda, shared
    preconditioner) against jax.vmap of solve_force: solutions, forces and
    per-walker iteration counts."""
    name, kw = "honeycomb", dict(L=2, beta=0.6, alpha=0.3)
    jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), xs, Lam, b = _problem(name, kw, 2, seed=51)
    jpre = jbuild_spectral(jfdm)
    structure = jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites)

    def one(xw, bw, lw, x0w):
        f = JFdm.from_path_integral(jbuild_pi(jtbp, jelph, x=xw), structure, symmetric=True)
        return build_fused_pcg(f, jpre, interpret=True).solve_force(bw, lw, x0=x0w, tol=TOL, maxiter=MAXITER)

    x0 = 0.1 * np.random.default_rng(52).standard_normal(b.shape).astype(np.float32)
    xj, P1j, P2j, sj = jax.vmap(one)(jnp.asarray(xs), jnp.asarray(b), jnp.asarray(Lam), jnp.asarray(x0))
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix

    pf = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(xs)), pfdm.structure)
    pf = dataclasses.replace(pf, exp_nV=pf.exp_nV[:, None])
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jfdm.Ltau, device="cpu")
    xp, P1p, P2p, sp = pcg_force.solve_force(pf, ppre, t32(b), t32(Lam), x0=t32(x0), tol=TOL, maxiter=MAXITER)
    assert np.asarray(sj.converged).all() and sp.converged.shape == (2,) and bool(sp.converged.all())
    assert sp.iters.shape == (2,) and np.max(np.abs(sp.iters.numpy() - np.asarray(sj.iters))) <= 1
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)
    plan_p = build_force_plan(pelph, pfdm.structure)
    plan_j = jplan(jelph, structure)
    for w in range(2):
        fj, fp = _forces(P1j[w], P2j[w], P1p[w], P2p[w], jelph, pelph, xs[w], Lam[w], plan_j, plan_p)
        _assert_force_close(fp, fj)


@pytest.mark.parametrize("name,kw", FORCE_CASES)
def test_force_planes_plain_matches_fused_force(name, kw):
    """K4's plain version against `FusedForce` (_force_kernel in interpret
    mode) on the same psi_raw: planes and forces."""
    jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), xs, Lam, b = _problem(name, kw, 1, seed=61)
    want_p2 = bool(np.any(pelph.hol_ph_sym))
    psi = np.random.default_rng(62).standard_normal(b[0].shape).astype(np.float32)
    fused = build_fused_force(jfdm, jnp.asarray(Lam[0]), want_p2, interpret=True)
    assert fused is not None
    P1j, P2j = fused(jnp.asarray(psi))
    launches, plain = pforce.FORCE.launches, pforce.FORCE.plain_calls
    P1p, P2p = pforce.force_planes(pfdm.astype(torch.float32), t32(Lam[0]), t32(psi), want_p2)
    assert (pforce.FORCE.launches, pforce.FORCE.plain_calls) == (launches, plain + 1)
    for got, ref in ((P1p, P1j), (P2p, P2j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4 * max(float(np.max(np.abs(ref))), 1e-30))
    plan_p = build_force_plan(pelph, pfdm.structure)
    plan_j = jplan(jelph, jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites))
    fj, fp = _forces(P1j, P2j, P1p, P2p, jelph, pelph, xs[0], Lam[0], plan_j, plan_p)
    _assert_force_close(fp, fj)


@pytest.mark.parametrize("fused", ["step", "force"])
def test_fused_forces_match_jax_force_path(fused, fused_env, monkeypatch):
    """fermionic_action_and_force on the 'k3' route (K3) and on the 'k4'
    route (K2 + K4) against the JAX package's fused paths on the same Phi."""
    from smoqyelphqmc_tpu.ops.pff import fermionic_action_and_force as jforce
    from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force

    monkeypatch.setenv("SMOQY_FUSED_STEP", "1" if fused == "step" else "0")
    jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), x = fdm_pair("honeycomb", dict(L=2, beta=0.6, alpha=0.3), x_seed=71)
    Phi = np.random.default_rng(72).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    jpre = jbuild_spectral(jfdm)
    jres = jforce(jnp.asarray(Phi), jelph, jfdm, jnp.asarray(x),
                  jplan(jelph, jstruct(np.asarray(jtbp.neighbor_table), jtbp.n_sites)), precond=jpre, tol=TOL,
                  maxiter=MAXITER, solve_dtype="float32")
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jfdm.Ltau, device="cpu")
    pres = fermionic_action_and_force(t64(Phi), pelph, pfdm, t64(x), build_force_plan(pelph, pfdm.structure),
                                      precond=ppre, tol=TOL, maxiter=MAXITER, solve_dtype="float32",
                                      route={"step": "k3", "force": "k4"}[fused])
    assert bool(jres.stats.converged) and bool(pres.stats.converged) and pres.force.dtype == torch.float64
    _assert_force_close(pres.force.numpy(), np64(jres.force))
    np.testing.assert_allclose(float(pres.Sf), float(jres.Sf), rtol=2e-5)


@pytest.mark.parametrize("flag", ["fused_step_force", "fused_force", "walker_sweep_fused_force"])
def test_hmc_update_fused_paths_match_plain_chain(flag):
    """Trajectories with their forces through K3 (fused_step_force: a W = 2
    batch, both walkers' solves in one K3 call per leapfrog step, as the
    walker sweep runs them), K2 + K4 (fused_force, one chain) or K2 + K4
    walker by walker (a W = 2 walker_sweep without the shared refresh, each
    walker's trajectory on its own with fused_force) against each walker's
    trajectory through the plain force chain (K2 + the eager chain, held to
    the JAX package in test_torch_hmc.py): the same accept decisions, Delta
    H to 1e-6 and end field to 1e-6 relative."""
    from smoqyelphqmc_tpu_torch.updates.context import QMCState
    from smoqyelphqmc_tpu_torch.updates.hmc import hmc_update

    W = 1 if flag == "fused_force" else 2
    _, jstates, pctx, pstates = _both_walker_chains(W, 3, L=2, beta=1.0, alpha=0.5)
    draws = [_hmc_draws(jstates.key[w], pctx.elph.n_phonon, pctx.Ltau, pctx.n_sites)[0] for w in range(W)]
    params = HMCParams(Nt=8, refresh_precond_at_start=False, fused_force=False)
    if flag == "walker_sweep_fused_force":
        gen = torch.Generator().manual_seed(31)
        wdraws = [dataclasses.replace(walkers.draw_walker(gen, pctx, pstates.precond[w]), hmc=draws[w])
                  for w in range(W)]
        sweep = lambda p: walkers.walker_sweep(pctx, pstates, p, wdraws, shared_precond=False)  # noqa: E731
        ref_states, ref_stats = sweep(params)
        refs = [(ref_states.walker(w), h) for w, h in enumerate(ref_stats.hmc)]
    else:
        refs = [hmc_update(pctx, pstates.walker(w), params, draws[w]) for w in range(W)]
    plain = (pcg_force.PCG_FORCE.plain_calls, pforce.FORCE.plain_calls)
    fused = dataclasses.replace(params, **{flag.replace("walker_sweep_", ""): True})
    if flag == "walker_sweep_fused_force":
        got_states, got_stats = sweep(fused)
        got, got_x = got_stats.hmc, got_states.x
        assert [(r.accepted, s.accepted) for r, s in zip(got_stats.reflection, got_stats.swap)] == [
            (r.accepted, s.accepted) for r, s in zip(ref_stats.reflection, ref_stats.swap)]
    elif W > 1:
        got_state, got = hmc_update(pctx, QMCState(x=pstates.x, precond=pstates.precond[0]), fused, draws)
        got_x = got_state.x
    else:
        got_state, got = hmc_update(pctx, pstates.walker(0), fused, draws[0])
        got, got_x = [got], got_state.x[None]
    k3, k4 = pcg_force.PCG_FORCE.plain_calls - plain[0], pforce.FORCE.plain_calls - plain[1]
    assert (k3, k4) == ((8, 0) if flag == "fused_step_force" else (0, 8 * W))
    assert len(got) == W
    for w, (ref_state, ref) in enumerate(refs):
        assert ref.converged and got[w].converged and got[w].accepted == ref.accepted
        assert abs(got[w].delta_H - ref.delta_H) < 1e-6
        xr = ref_state.x.numpy()
        assert np.max(np.abs(got_x[w].numpy() - xr)) <= 1e-6 * np.max(np.abs(xr))


def test_holstein_force_from_planes_f64():
    """The force assembly from given planes, f64, with and without a walker axis: 1e-12."""
    (_, _, jtbp, _, jelph), (_, _, ptbp, _, pelph) = both_models("honeycomb", L=2, beta=0.6, alpha=0.3)
    jelph = jelph.replace(hol_alpha3=jnp.full_like(jelph.hol_alpha3, 0.07),
                          hol_alpha2=jnp.full_like(jelph.hol_alpha2, 0.05))
    pelph.hol_alpha3 = torch.full_like(pelph.hol_alpha3, 0.07)
    pelph.hol_alpha2 = torch.full_like(pelph.hol_alpha2, 0.05)
    rng = np.random.default_rng(81)
    W, L, N = 2, jelph.Ltau, jtbp.n_sites
    P1, P2, Lam = rng.standard_normal((3, W, L, N))
    x = rng.standard_normal((W,) + np64(jelph.x).shape)
    plan_j = jplan(jelph, jstruct(np.asarray(jtbp.neighbor_table), N))
    plan_p = build_force_plan(pelph, None)
    batched = holstein_force_from_planes(t64(P1), t64(P2), pelph, t64(x), t64(Lam), plan_p).numpy()
    for w in range(W):
        ref = np64(jforce_from_planes(jnp.asarray(P1[w]), jnp.asarray(P2[w]), jelph, jnp.asarray(x[w]),
                                      jnp.asarray(Lam[w]), plan_j))
        got = holstein_force_from_planes(t64(P1[w]), t64(P2[w]), pelph, t64(x[w]), t64(Lam[w]), plan_p).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.max(np.abs(ref)))
        np.testing.assert_allclose(batched[w], ref, rtol=1e-12, atol=1e-12 * np.max(np.abs(ref)))


def _both_walker_chains(W, seed, **kw):
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", **kw)
    opts = dict(mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    jstates = jwalkers.init_walker_states(jctx, jstate, W, seed=seed + 1)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"),
                                  **opts)
    pstates = convert.walker_states(jstates.x, precond=pstate.precond, device="cpu")
    return jctx, jstates, pctx, pstates


def test_shared_precond_refresh_action():
    """The walker-mean refresh, compared by the preconditioner's action: 1e-5."""
    jctx, jstates, pctx, pstates = _both_walker_chains(3, 5, L=2, beta=0.6, alpha=0.5)
    jpre = jax.tree_util.tree_map(lambda a: a[0], jwalkers.shared_precond_refresh(jctx, jstates).precond)
    pnew = walkers.shared_precond_refresh(pctx, pstates)
    assert all(p is pnew.precond[0] for p in pnew.precond) and pnew.precond[0] is not pstates.precond[0]
    r = np.random.default_rng(91).standard_normal((2, pctx.Ltau, pctx.n_sites))
    ref = np64(jspectral_apply(jpre, jnp.asarray(r)))
    got = spectral_apply(pnew.precond[0], t64(r)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
    # the refresh comes from the walker mean, not from one walker
    one = spectral_apply(build_spectral(make_fdm(pctx, pstates.x[0])), t64(r)).numpy()
    assert np.max(np.abs(one - ref)) / np.max(np.abs(ref)) > 1e-4


# (iteration count fed, sweep was shared) sequences of tests/test_precond_fallback.py
CONTROLLER_CASES = [
    pytest.param(dict(ratio=1.5, retry_every=8), [10.0, 11.0, 20.0, 10.0, 10.0], id="demote"),
    pytest.param(dict(ratio=1.5, retry_every=4), [10.0, 30.0, 10.0, 10.0, 10.0, 10.0, 10.0], id="promote"),
    pytest.param(dict(ratio=1.5, retry_every=2), [10.0, 30.0, 10.0, 25.0, 10.0], id="probe-fails"),
    pytest.param(dict(ratio=1.5, retry_every=2), [10.0, 100.0] + [100.0] * 6, id="fallback-count"),
    pytest.param(dict(ratio=1.5), [float("nan"), 10.0], id="non-finite"),
    pytest.param(dict(ratio=float("inf")), [10.0, 20.0], id="disabled"),
]


@pytest.mark.parametrize("kw,its", CONTROLLER_CASES)
def test_fallback_controller_matches(kw, its):
    """The port's controller and the JAX package's, fed the same counts: the
    same choice, mode, floor, pw_count and fallback_sweeps after every step,
    and a state_dict round trip."""
    cj, cp = jwalkers.PrecondFallbackController(**kw), walkers.PrecondFallbackController(**kw)

    def same():
        for k in ("mode", "floor", "pw_count", "fallback_sweeps", "enabled"):
            assert getattr(cp, k) == getattr(cj, k), k

    for it in its:
        shared = cj.choose()
        assert cp.choose() == shared
        cj.record(it, shared)
        cp.record(torch.tensor(it), shared)
        same()
    assert cp.state_dict() == cj.state_dict()
    restored = convert.fallback_controller(cj.state_dict(), **kw)
    assert restored.state_dict() == cj.state_dict() and restored.choose() == cj.choose()


def test_walker_sweep_matches_jax_draws(fused_env):
    """One walker_sweep at W = 2 (shared refresh, K3 trajectories) from the same
    fields and each walker's draws replayed from its JAX key: the same accept
    flags, Delta H (1e-6) and end field (1e-6 relative) per walker."""
    W, Nt = 2, 4
    jctx, jstates, pctx, pstates = _both_walker_chains(W, 2, L=2, beta=1.0, alpha=0.5)
    jout, (jr, js, jh) = jax.jit(lambda s: jwalkers.walker_sweep(jctx, s, jhmc.HMCParams(Nt=Nt)))(jstates)
    n_cands, n_pairs = len(_candidate_modes(pctx, None)), len(_type_pairs(pctx, None))
    L, N, n_ph, n_cells = pctx.Ltau, pctx.n_sites, pctx.elph.n_phonon, pctx.elph.n_cells
    draws = []
    for w in range(W):
        rd, key = _reflection_draws(jstates.key[w], n_cands, L, N)
        sd, key = _swap_draws(key, n_pairs, n_cells, L, N)
        hd, key = _hmc_draws(key, n_ph, L, N)
        draws.append(walkers.WalkerDraws(rd, sd, hd))
    plain = pcg_force.PCG_FORCE.plain_calls
    pout, (pr, ps, ph) = walkers.walker_sweep(pctx, pstates, HMCParams(Nt=Nt), draws)
    assert pcg_force.PCG_FORCE.plain_calls == plain + Nt
    xj = np64(jout.x)
    for w in range(W):
        assert (pr[w].accepted, ps[w].accepted, ph[w].accepted) == (
            bool(jr.accepted[w]), bool(js.accepted[w]), bool(jh.accepted[w]))
        assert pr[w].converged and ps[w].converged and ph[w].converged and bool(jh.converged[w])
        assert abs(ph[w].delta_H - float(jh.delta_H[w])) < 1e-6
        assert np.max(np.abs(pout.x[w].numpy() - xj[w])) <= 1e-6 * np.max(np.abs(xj[w]))
    assert all(h.accepted for h in ph) and np.max(np.abs(xj - np64(jstates.x))) > 1e-3


@pytest.mark.parametrize("mode", ["shared", "perwalker", "shared-f64-forces"])
def test_run_updates_walkers_on_cpu(mode):
    """The W >= 2 driver on CPU tensors in each trajectory mode: shared refresh
    with K3's plain version (one call per leapfrog step for all walkers),
    per-walker refresh (no K3; walker w's chain is the same at W = 2 and
    W = 3, since its draws come from its own generator), and shared refresh
    with f64 forces (no K3; each walker's force solved on its own)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model

    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    kw = dict(beta=1.0, dtau=0.1, Nt=4, seed=3, preconditioner="spectral", n_walkers=2,
              shared_precond=mode != "perwalker",
              force_dtype="float64" if mode == "shared-f64-forces" else "float32")
    k3 = pcg_force.PCG_FORCE.plain_calls
    md = run_updates(tbm, em, SimulationConfig(**kw), 2, device="cpu")
    assert pcg_force.PCG_FORCE.plain_calls - k3 == (2 * 4 if mode == "shared" else 0)
    assert md["all_converged"] and md["walker_converged"] == [True, True]
    assert np.isfinite(md["hmc_delta_H"]).all() and np.asarray(md["hmc_delta_H"]).shape == (2, 2)
    assert md["x_final"].shape == (2, 8, 10) and bool(md["x_final"].isfinite().all())
    assert md["precond_fallback_sweeps"] == (2 if mode == "perwalker" else 0)
    if mode == "perwalker":
        md3 = run_updates(tbm, em, SimulationConfig(**dict(kw, n_walkers=3)), 2, device="cpu")
        assert torch.equal(md3["x_final"][:2], md["x_final"])
        assert md3["hmc_delta_H"][:2] == md["hmc_delta_H"]
