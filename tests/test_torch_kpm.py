"""Parity of the port's KPM preconditioner (ops/kpm.py, ops/kpm_mf.py) with the
JAX package, on honeycomb L=2 and chain L=4 models.

The JAX package draws the Lanczos start vector from a key; the port takes it
as an argument, so every test hands the port jax.random.normal(key, (N,)).
The matrix-free path is forced on the JAX side with matrix_free=True (or
SMOQY_KPM_MATRIX_FREE=1 where initialize_qmc builds it) and its fused Pallas
kernels K6 / K7 run in interpret mode (SMOQY_FUSED_KPM=interpret), as
tests/test_kpm_matrix_free.py runs them.

Tolerances: Lanczos bounds 1e-10 relative (the same f64 steps); the
coefficient fit 1e-6 of its largest value (an f64 fit rounded to f32); the
applies 2e-4 (symmetric) and 5e-4 (asymmetric, two passes), relative to
max|z| (f32 recurrences summed in another order; the tolerances of
tests/test_kpm_matrix_free.py); CG with the KPM operator: solutions rtol 1e-5
/ atol 1e-7 and iterations within 2 (ibid.); one sweep fed the JAX package's
draws: the same accept flags, Delta H to 1e-6 and the end field to 1e-6
relative (tests/test_torch_hmc.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import both_models, fdm_pair, np64, t64

from smoqyelphqmc_tpu.ops import kpm as jkpm
from smoqyelphqmc_tpu.ops.cg import cg_solve as jcg
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu_torch.ops.cg import cg_solve
from smoqyelphqmc_tpu_torch.ops.fourier import TauFourier
from smoqyelphqmc_tpu_torch.ops.kpm import (
    KPMPreconditioner,
    averaged_propagator,
    kpm_apply,
    kpm_update,
    lanczos_bounds,
)
from smoqyelphqmc_tpu_torch.ops.kpm_mf import KPM_MF, KPM_MF_ASYM, build_kpm_mf_plan
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs, reflection_update, swap_update
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update

HONEYCOMB = dict(L=2, beta=2.0, alpha=0.4)
SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]


def _v0(key, n):
    """The JAX package's Lanczos start vector of a key (ops/kpm.py:110)."""
    return np64(jax.random.normal(key, (n,)))


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("name,kw", [("honeycomb", HONEYCOMB), ("chain", dict(L=4, beta=1.0))])
def test_lanczos_bounds_match(name, kw, symmetric):
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=1, symmetric=symmetric)
    key = jax.random.PRNGKey(3)
    jb, pb = jkpm.averaged_propagator(jfdm), averaged_propagator(pfdm)
    v0 = t64(_v0(key, jfdm.n_sites))
    for japply, papply in ((jb.apply, pb.apply), (lambda v: jb.apply_T(jb.apply(v)), lambda v: pb.apply_T(pb.apply(v)))):
        jlo, jhi = jkpm.lanczos_bounds(japply, jfdm.n_sites, key, 20)
        plo, phi = lanczos_bounds(papply, v0, 20)
        np.testing.assert_allclose([plo, phi], [float(jlo), float(jhi)], rtol=1e-10)


def _check_state(ppre, jpre):
    assert ppre.active == bool(jpre.active)
    np.testing.assert_allclose([ppre.lo, ppre.hi], [float(jpre.lo), float(jpre.hi)], rtol=1e-10)
    jre, jim = np.asarray(jpre.coefs_re[0]), np.asarray(jpre.coefs_im[0])
    # the JAX planes are masked beyond each frequency's live order
    np.testing.assert_array_equal(ppre.orders, np.count_nonzero((jre != 0) | (jim != 0), axis=1))
    assert ppre.order_clip_count == int(jpre.order_clip_count)
    for got, ref in ((ppre.coefs_re, jre), (ppre.coefs_im, jim)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.max(np.abs(jre)))


@pytest.mark.parametrize("matrix_free", [pytest.param(False, id="dense"), pytest.param(True, id="mf")])
@pytest.mark.parametrize("symmetric", SYM)
def test_build_and_update_match(symmetric, matrix_free):
    """build, then kpm_update at another field, from the same start vectors."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", HONEYCOMB, symmetric=symmetric)
    key = jax.random.PRNGKey(4)
    jpre = jkpm.KPMPreconditioner.build(jfdm, key, matrix_free=matrix_free)
    ppre = KPMPreconditioner.build(pfdm, t64(_v0(key, jfdm.n_sites)), matrix_free=matrix_free)
    assert ppre.matrix_free == matrix_free and ppre.active
    _check_state(ppre, jpre)
    jfdm2, pfdm2, *_ = fdm_pair("honeycomb", HONEYCOMB, x_seed=5, symmetric=symmetric)
    key2 = jax.random.PRNGKey(6)
    _check_state(kpm_update(ppre, pfdm2, t64(_v0(key2, jfdm2.n_sites))), jkpm.kpm_update(jpre, jfdm2, key2))


def test_order_clip_count_matches():
    """A tight build-time cap estimate clips live orders in both packages."""
    jfdm, pfdm, *_ = fdm_pair("chain", dict(L=4, beta=4.0, alpha=0.4))
    key = jax.random.PRNGKey(4)
    jpre = jkpm.KPMPreconditioner.build(jfdm, key, cap_delta_eps=0.3)
    ppre = KPMPreconditioner.build(pfdm, t64(_v0(key, jfdm.n_sites)), cap_delta_eps=0.3)
    assert ppre.order_clip_count == int(jpre.order_clip_count) > 0
    _check_state(ppre, jpre)


@pytest.mark.parametrize("matrix_free", [pytest.param(False, id="dense"), pytest.param(True, id="mf")])
def test_positivity_guard_deactivates_capped_fit(matrix_free):
    """cap_max=32 at Ltau=240 makes the truncated fit non-positive: both
    packages deactivate, the uncapped fit stays active, and the inactive
    preconditioner is the identity (CG converges unpreconditioned)."""
    jfdm, pfdm, *_ = fdm_pair("chain", dict(L=4, beta=24.0, dtau=0.1, alpha=0.4))
    assert pfdm.Ltau == 240
    key = jax.random.PRNGKey(3)
    v0 = t64(_v0(key, jfdm.n_sites))
    capped = KPMPreconditioner.build(pfdm, v0, cap_max=32, matrix_free=matrix_free)
    jcapped = jkpm.KPMPreconditioner.build(jfdm, key, cap_max=32, matrix_free=matrix_free)
    assert not capped.active and not bool(jcapped.active)
    uncapped = KPMPreconditioner.build(pfdm, v0, matrix_free=matrix_free)
    assert uncapped.active and bool(jkpm.KPMPreconditioner.build(jfdm, key, matrix_free=matrix_free).active)
    b = t64(np.random.default_rng(7).standard_normal((pfdm.Ltau, pfdm.n_sites)))
    assert kpm_apply(capped, b) is b
    x, st = cg_solve(pfdm.mul_MtM, b, precond=capped.as_operator(), tol=1e-8, maxiter=4000)
    assert bool(st.converged)
    assert float(torch.linalg.vector_norm(pfdm.mul_MtM(x) - b) / torch.linalg.vector_norm(b)) < 1e-6


def _fused_mode(monkeypatch, mode):
    monkeypatch.setenv("SMOQY_FUSED_KPM", mode)


@pytest.mark.parametrize("symmetric", SYM)
def test_mf_apply_matches_jax(symmetric, monkeypatch):
    """The plain K6 / K7 (through kpm_apply) on the JAX preconditioner's state
    against the JAX XLA recurrence and the interpret-mode Pallas kernel."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", HONEYCOMB, symmetric=symmetric)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(8), matrix_free=True)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    r = np.random.default_rng(9).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    counter = KPM_MF if symmetric else KPM_MF_ASYM
    plain, launches = counter.plain_calls, counter.launches
    got = kpm_apply(ppre, t64(r)).numpy()
    assert (counter.plain_calls, counter.launches) == (plain + 1, launches)
    tol = 2e-4 if symmetric else 5e-4
    for mode in ("0", "interpret"):
        _fused_mode(monkeypatch, mode)
        ref = np64(jkpm.kpm_apply(jpre, jnp.asarray(r)))
        assert _rel(got, ref) <= tol, mode


@pytest.mark.parametrize("symmetric", SYM)
def test_dense_apply_matches_jax(symmetric):
    jfdm, pfdm, *_ = fdm_pair("honeycomb", HONEYCOMB, symmetric=symmetric)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(10), matrix_free=False)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    r = np.random.default_rng(11).standard_normal((3, jfdm.Ltau, jfdm.n_sites))
    assert _rel(kpm_apply(ppre, t64(r)).numpy(), np64(jkpm.kpm_apply(jpre, jnp.asarray(r)))) <= 2e-4


def test_mf_plan_sorts_by_descending_order():
    jfdm, pfdm, *_ = fdm_pair("honeycomb", HONEYCOMB)
    pre = KPMPreconditioner.build(pfdm, t64(_v0(jax.random.PRNGKey(0), pfdm.n_sites)), matrix_free=True)
    perm = build_kpm_mf_plan(pre.phi)
    np.testing.assert_array_equal(np.sort(perm), np.arange(pfdm.Ltau))
    assert np.all(np.diff(pre.orders[perm]) <= 0) and np.all(np.diff(pre.caps[perm]) <= 0)


@pytest.mark.parametrize("symmetric,matrix_free", [(True, True), (False, True), (True, False)],
                         ids=["sym-mf", "asym-mf", "sym-dense"])
def test_cg_with_kpm_matches_jax(symmetric, matrix_free):
    """f64 CG with the KPM operator (the XLA apply on the JAX side)."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", HONEYCOMB, symmetric=symmetric)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(12), matrix_free=matrix_free)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    b = np.random.default_rng(13).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    xj, sj = jcg(jfdm.mul_MtM, jnp.asarray(b), precond=jpre.as_operator(), tol=1e-10, maxiter=2000)
    xp, sp = cg_solve(pfdm.mul_MtM, t64(b), precond=ppre.as_operator(), tol=1e-10, maxiter=2000)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=1e-5, atol=1e-7)
    assert abs(int(sp.iters) - int(sj.iters)) <= 2, (int(sp.iters), int(sj.iters))


# ----------------------------------------------------------------------
# one sweep fed the JAX package's draws
# ----------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_sweep_matches_jax_draws(symmetric, monkeypatch):
    """reflection + swap + HMC with the matrix-free KPM preconditioner from the
    same state and draws, the Lanczos vectors included: the same accept flags,
    the field after every update (1e-12 after the global moves, 1e-6 relative
    after HMC) and Delta H to 1e-6."""
    from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws

    monkeypatch.setenv("SMOQY_KPM_MATRIX_FREE", "1")
    seed, Nt = 4, 8
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", L=2, beta=1.0, alpha=0.5)
    opts = dict(symmetric=symmetric, mixed_precision=True, force_dtype="float32", preconditioner="kpm")
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    assert jstate.precond.matrix_free and bool(jstate.precond.active)
    N = jctx.n_sites
    v_init = t64(_v0(jax.random.split(jax.random.PRNGKey(seed))[1], N))
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), lanczos_v0=v_init, **opts)
    # the port picks the dense apply at this size (no environment switch): rebuild matrix-free
    pstate.precond = KPMPreconditioner.build(make_fdm(pctx, pstate.x), v_init, matrix_free=True)
    _check_state(pstate.precond, jstate.precond)
    params = jhmc.HMCParams(Nt=Nt)

    @jax.jit
    def jax_sweep(s):
        s, r = jglobal.reflection_update(jctx, s)
        s1, sw = jglobal.swap_update(jctx, s)
        s2, h = jhmc.hmc_update(jctx, s1, params)
        return s.x, s1.x, s2, r.accepted, sw.accepted, h

    jx_r, jx_s, jfinal, ja_r, ja_s, jh = jax_sweep(jstate)
    L, n_ph, n_cells = jctx.Ltau, jctx.elph.n_phonon, jctx.elph.n_cells
    rd, key = _reflection_draws(jstate.key, len(_candidate_modes(pctx, None)), L, N)
    sd, key = _swap_draws(key, len(_type_pairs(pctx, None)), n_cells, L, N)
    hd, _ = _hmc_draws(key, n_ph, L, N)
    hd.v_pre0 = t64(_v0(jax.random.split(key, 6)[5], N))
    plain = (KPM_MF if symmetric else KPM_MF_ASYM).plain_calls
    pstate, pr = reflection_update(pctx, pstate, rd)
    assert pr.accepted == bool(ja_r)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_r), rtol=0, atol=1e-12)
    pstate, ps = swap_update(pctx, pstate, sd)
    assert ps.accepted == bool(ja_s)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_s), rtol=0, atol=1e-12)
    pstate, ph = hmc_update(pctx, pstate, HMCParams(Nt=Nt), hd)
    assert (KPM_MF if symmetric else KPM_MF_ASYM).plain_calls > plain
    assert pr.converged and ps.converged and ph.converged and bool(jh.converged)
    assert ph.accepted == bool(jh.accepted)
    assert abs(ph.delta_H - float(jh.delta_H)) < 1e-6
    xj = np64(jfinal.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    # the trajectory-start refresh came from the replayed Lanczos vector
    _check_state(pstate.precond, jfinal.precond)


# ----------------------------------------------------------------------
# entry points and the driver
# ----------------------------------------------------------------------


def test_entry_points_default_to_cuda():
    """The port's entry points run on the card unless asked for the CPU."""
    fns = [run_updates, TightBindingParameters.from_model, ElectronPhononParameters.from_model, TauFourier,
           convert.tight_binding_parameters, convert.electron_phonon_parameters, convert.phonon_field,
           convert.spectral_preconditioner, convert.kpm_preconditioner, convert.walker_states]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_run_updates_kpm_on_cpu():
    """preconditioner='kpm' through the driver on CPU tensors (the dense apply
    at this size): every solve converges, the diagnostics are recorded, and
    the walker path with KPM is refused."""
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=3, preconditioner="kpm")
    md = run_updates(tbm, em, cfg, 2, device="cpu")
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert md["kpm_active"] is True and md["kpm_inactive_walkers"] == 0 and md["kpm_order_clip_count"] == 0
    spectral = run_updates(tbm, em, SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=3), 1, device="cpu")
    assert "kpm_active" not in spectral
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_updates(tbm, em, SimulationConfig(beta=1.0, dtau=0.1, Nt=4, preconditioner="kpm", n_walkers=2), 1,
                    device="cpu")
