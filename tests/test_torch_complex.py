"""Parity of the port's complex-hopping path with the JAX package: the
channel-mixing checkerboard, M and its products on (re, im) channel pairs,
the joint-channel CG (sys_ndim = 3), the doubled-basis spectral and KPM
preconditioners (dense and matrix-free, the plain version of kernel K8), the
Holstein force on pairs and one sweep per factorization fed the JAX
package's draws. Also the asymmetric factorization's spectral preconditioner
for real hoppings, and the refusal of complex input by the real-hopping
kernels K1-K4, K6 and K7.

The model is the JAX package's complex chain (tests/test_complex_hoppings.py:
t e^{i 0.7}, mu = 0.1, Omega = 1, alpha = 0.5), with an O(1) imaginary part
so a sign slip in S_im shows. Tolerances: f64 operator chains 1e-12
relative; CG 1e-8; spectral actions 2e-5 (f32 eigh and applies); KPM bounds
1e-10, coefficients 1e-6 of their largest value, the dense apply 5e-4, the
matrix-free applies 2e-4 (symmetric) and 5e-4 (asymmetric) of max|z>
(tests/test_torch_kpm.py); CG with KPM within 2 iterations; f32 forces 2e-4
and actions 2e-5 (tests/test_torch_hmc.py); a sweep: the same accept flags
and Delta H within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import both_models, fdm_pair, np64, t64
from test_complex_hoppings import complex_chain_model as jax_complex_chain
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_kpm import _check_state, _rel, _v0

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral as jbuild_fpi
from smoqyelphqmc_tpu.ops import kpm as jkpm
from smoqyelphqmc_tpu.ops.cg import cg_solve as jcg
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct
from smoqyelphqmc_tpu.ops.derivatives import build_force_plan as jplan
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix as JFdm
from smoqyelphqmc_tpu.ops.pff import fermionic_action_and_force as jforce
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.models.library import complex_chain_model
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import force, kpm_mf, mtm, pcg, pcg_force
from smoqyelphqmc_tpu_torch.ops.cg import cg_solve
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.derivatives import build_force_plan
from smoqyelphqmc_tpu_torch.ops.fermion_det import CPLX_MTM, FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner, kpm_apply, kpm_update
from smoqyelphqmc_tpu_torch.ops.kpm_mf import KPM_MF_CPLX, build_operands, kpm_mf_cplx_plain
from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda
from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral, spectral_apply
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs, reflection_update, swap_update
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]
CHAIN = dict(L=6, beta=1.0, dtau=0.1)
KPM_CHAIN = dict(L=6, beta=1.5, dtau=0.1)


def cplx_models(L=6, beta=1.0, dtau=0.1, phase=0.7, alpha=0.5, seed=0):
    """(JAX tbp, elph), (port tbp, elph) of the complex chain from one seed."""
    *_, jtbp, _, jelph = jax_complex_chain(L=L, phase=phase, alpha=alpha, beta=beta, dtau=dtau, seed=seed)
    _, tbm, em = complex_chain_model(L, t=1.0, phase=phase, mu=0.1, Omega=1.0, alpha=alpha)
    rng = np.random.default_rng(seed)
    ptbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    pelph = ElectronPhononParameters.from_model(beta, dtau, em, ptbp, rng, device="cpu")
    return (jtbp, jelph), (ptbp, pelph)


def cplx_fdm_pair(symmetric=True, x_seed=None, **kw):
    """JAX and port complex fermion matrices (f64) at the initial field or a
    field drawn from x_seed."""
    (jtbp, jelph), (ptbp, pelph) = cplx_models(**kw)
    x = np64(jelph.x)
    if x_seed is not None:
        x = 0.3 * np.random.default_rng(x_seed).standard_normal(x.shape)
    nt, n = np.asarray(ptbp.neighbor_table), ptbp.n_sites
    jfdm = JFdm.from_path_integral(jbuild_fpi(jtbp, jelph, x=jnp.asarray(x)), jstruct(nt, n), symmetric=symmetric)
    pfdm = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(x)),
                                               build_checkerboard_structure(nt, n), symmetric=symmetric)
    assert jfdm.complex_hops and pfdm.complex_hops
    return jfdm, pfdm, (jtbp, jelph), (ptbp, pelph), x


def _pair(fdm, seed, lead=()):
    return np.random.default_rng(seed).standard_normal(lead + (2, fdm.Ltau, fdm.n_sites))


# ----------------------------------------------------------------------
# models, checkerboard and M
# ----------------------------------------------------------------------


def test_complex_parameters_match():
    """t0, t0_im and the path integral's t_im: the same rng draws, exactly."""
    (jtbp, jelph), (ptbp, pelph) = cplx_models(**CHAIN)
    np.testing.assert_array_equal(ptbp.t0.numpy(), np64(jtbp.t0))
    np.testing.assert_array_equal(ptbp.t0_im.numpy(), np64(jtbp.t0_im))
    assert float(np.max(np.abs(np64(jtbp.t0_im)))) > 0.5
    np.testing.assert_array_equal(pelph.x.numpy(), np64(jelph.x))
    jfpi, pfpi = jbuild_fpi(jtbp, jelph), build_path_integral(ptbp, pelph)
    np.testing.assert_array_equal(pfpi.t_im.numpy(), np64(jfpi.t_im))
    np.testing.assert_allclose(pfpi.V.numpy(), np64(jfpi.V), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("symmetric", SYM)
def test_complex_operators_match(symmetric):
    """Checkerboard apply, transpose and inverse, mul_M, mul_Mt and mul_MtM on
    channel pairs (f64, 1e-12 relative); the complex M^dag M counts on
    CPLX_MTM[float64] and never reaches K1's plain version."""
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, x_seed=1, **CHAIN)
    v = _pair(pfdm, 2)
    for kw in (dict(), dict(transpose=True), dict(inverse=True), dict(transpose=True, inverse=True)):
        got = pfdm.cb.apply(t64(v), **kw).numpy()
        assert _rel(got, np64(jfdm.cb.apply(jnp.asarray(v), **kw))) <= 1e-12, kw
    for name in ("mul_M", "mul_Mt"):
        got = getattr(pfdm, name)(t64(v)).numpy()
        assert _rel(got, np64(getattr(jfdm, name)(jnp.asarray(v)))) <= 1e-12, name
    k1 = mtm.MTM[torch.float64].plain_calls
    calls = CPLX_MTM[torch.float64].plain_calls
    got = pfdm.mul_MtM(t64(v)).numpy()
    assert (CPLX_MTM[torch.float64].plain_calls, mtm.MTM[torch.float64].plain_calls) == (calls + 1, k1)
    assert _rel(got, np64(jfdm.mul_MtM(jnp.asarray(v)))) <= 1e-12
    # a genuinely complex operator: the channels mix
    assert np.max(np.abs(np64(jfdm.mul_M(jnp.asarray(v * np.array([1.0, 0.0])[:, None, None])))[1])) > 1e-2


def test_complex_cg_sys_ndim3_matches():
    jfdm, pfdm, *_ = cplx_fdm_pair(x_seed=3, **CHAIN)
    b = _pair(pfdm, 4, lead=(2,))
    xj, sj = jcg(jfdm.mul_MtM, jnp.asarray(b), tol=1e-12, maxiter=2000, sys_ndim=3)
    xp, sp = cg_solve(pfdm.mul_MtM, t64(b), tol=1e-12, maxiter=2000, sys_ndim=3)
    assert bool(sj.converged) and bool(sp.converged)
    assert sp.eps.shape == (2,)
    assert _rel(xp.numpy(), np64(xj)) <= 1e-8


# ----------------------------------------------------------------------
# spectral preconditioners: doubled basis, and the asymmetric half-angle build
# ----------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", SYM)
def test_complex_spectral_action_matches(symmetric):
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, x_seed=5, **CHAIN)
    jpre, ppre = jbuild_spectral(jfdm), build_spectral(pfdm)
    assert ppre.complex_pair and ppre.Q.shape == (2 * pfdm.n_sites,) * 2
    r = _pair(pfdm, 6, lead=(2,))
    assert _rel(spectral_apply(ppre, t64(r)).numpy(), np64(jspectral_apply(jpre, jnp.asarray(r)))) <= 2e-5
    with pytest.raises(ValueError, match="doubled-basis"):
        ppre.pcg_operands()


@pytest.mark.parametrize("name,kw", [("chain", dict(L=6, beta=1.0, alpha=0.4)),
                                     ("honeycomb", dict(L=2, beta=0.6, alpha=0.3))])
def test_real_asymmetric_spectral_action_matches(name, kw):
    """The asymmetric factorization's half-angle surrogate, real hoppings."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=7, symmetric=False)
    jpre, ppre = jbuild_spectral(jfdm), build_spectral(pfdm)
    assert not ppre.complex_pair
    r = np.random.default_rng(8).standard_normal((2, pfdm.Ltau, pfdm.n_sites))
    assert _rel(spectral_apply(ppre, t64(r)).numpy(), np64(jspectral_apply(jpre, jnp.asarray(r)))) <= 2e-5


# ----------------------------------------------------------------------
# KPM on the doubled basis, and the plain version of K8
# ----------------------------------------------------------------------


@pytest.mark.parametrize("matrix_free", [pytest.param(False, id="dense"), pytest.param(True, id="mf")])
@pytest.mark.parametrize("symmetric", SYM)
def test_complex_kpm_state_matches(symmetric, matrix_free):
    """build, then kpm_update at another field, from JAX's (2N,) Lanczos draws:
    bounds, orders, coefficients and activation."""
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, **KPM_CHAIN)
    dim = 2 * pfdm.n_sites
    key = jax.random.PRNGKey(4)
    jpre = jkpm.KPMPreconditioner.build(jfdm, key, matrix_free=matrix_free)
    ppre = KPMPreconditioner.build(pfdm, t64(_v0(key, dim)), matrix_free=matrix_free)
    assert ppre.complex_pair and ppre.matrix_free == matrix_free and ppre.active
    _check_state(ppre, jpre)
    if not matrix_free:
        assert ppre.BpT.shape == (dim, dim)
    jfdm2, pfdm2, *_ = cplx_fdm_pair(symmetric=symmetric, x_seed=5, **KPM_CHAIN)
    key2 = jax.random.PRNGKey(6)
    _check_state(kpm_update(ppre, pfdm2, t64(_v0(key2, dim))), jkpm.kpm_update(jpre, jfdm2, key2))
    with pytest.raises(ValueError, match="Lanczos start vector"):
        kpm_update(ppre, pfdm2, t64(_v0(key2, pfdm.n_sites)))


@pytest.mark.parametrize("symmetric", SYM)
def test_complex_kpm_dense_apply_matches(symmetric):
    """The doubled-basis blocked recurrence (_block_cheb_pair)."""
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, **KPM_CHAIN)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(10), matrix_free=False)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    r = _pair(pfdm, 11, lead=(2,))
    assert _rel(kpm_apply(ppre, t64(r)).numpy(), np64(jkpm.kpm_apply(jpre, jnp.asarray(r)))) <= 5e-4


@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_plain_matches_jax(symmetric, monkeypatch):
    """K8's plain version, through kpm_apply on the JAX preconditioner's state,
    against the JAX recurrence _mf_cheb_pair and the interpret-mode Pallas
    kernel _kpm_mf_cplx_kernel; and kpm_mf_cplx_plain on frequency-space
    input against _mf_cheb_pair directly."""
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, x_seed=2, **KPM_CHAIN)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(8), matrix_free=True)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    assert ppre.complex_pair and ppre.matrix_free and ppre.active
    r = _pair(pfdm, 9, lead=(2,))
    plain, launches = KPM_MF_CPLX.plain_calls, KPM_MF_CPLX.launches
    k6, k7 = kpm_mf.KPM_MF.plain_calls, kpm_mf.KPM_MF_ASYM.plain_calls
    got = kpm_apply(ppre, t64(r)).numpy()
    assert (KPM_MF_CPLX.plain_calls, KPM_MF_CPLX.launches) == (plain + 1, launches)
    assert (kpm_mf.KPM_MF.plain_calls, kpm_mf.KPM_MF_ASYM.plain_calls) == (k6, k7)
    tol = 2e-4 if symmetric else 5e-4
    for mode in ("0", "interpret"):
        monkeypatch.setenv("SMOQY_FUSED_KPM", mode)
        assert _rel(got, np64(jkpm.kpm_apply(jpre, jnp.asarray(r)))) <= tol, mode
    # the recurrence alone, on a channel pair in frequency space
    w = np.random.default_rng(12).standard_normal((2, 2, pfdm.Ltau, pfdm.n_sites)).astype(np.float32)
    ops = build_operands(ppre)
    yre, yim = kpm_mf_cplx_plain(ops, torch.as_tensor(w[:, 0]), torch.as_tensor(w[:, 1]))
    cre, cim = jpre.coefs_re[0], jpre.coefs_im[0]
    bbar32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jpre.bbar)
    jw = jnp.asarray(w)
    if symmetric:
        ref = jkpm._mf_cheb_pair(jpre, jw, cre, cim, bbar32)
    else:
        ref = jkpm._mf_cheb_pair(jpre, jkpm._mf_cheb_pair(jpre, jw, cre, -cim, bbar32), cre, cim, bbar32)
    assert _rel(torch.stack([yre, yim], dim=1).numpy(), np64(ref)) <= tol


@pytest.mark.parametrize("symmetric,matrix_free", [(True, True), (False, True), (True, False)],
                         ids=["sym-mf", "asym-mf", "sym-dense"])
def test_complex_cg_with_kpm_matches_jax(symmetric, matrix_free):
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, **KPM_CHAIN)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(12), matrix_free=matrix_free)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    b = _pair(pfdm, 13)
    xj, sj = jcg(jfdm.mul_MtM, jnp.asarray(b), precond=jpre.as_operator(), tol=1e-10, maxiter=2000, sys_ndim=3)
    xp, sp = cg_solve(pfdm.mul_MtM, t64(b), precond=ppre.as_operator(), tol=1e-10, maxiter=2000, sys_ndim=3)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=1e-5, atol=1e-7)
    assert abs(int(sp.iters) - int(sj.iters)) <= 2, (int(sp.iters), int(sj.iters))


# ----------------------------------------------------------------------
# forces
# ----------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", SYM)
def test_complex_force_matches(symmetric):
    """The plain force chain on channel pairs (f32 solve, spectral
    preconditioner): the K3 / K4 planes stay off for complex hoppings."""
    jfdm, pfdm, (_, jelph), (_, pelph), x = cplx_fdm_pair(symmetric=symmetric, x_seed=14, **CHAIN)
    R = _pair(pfdm, 15) / np.sqrt(2.0)
    pPhi, _ = sample_pseudofermion_fields(t64(R), pelph, pfdm, t64(x))
    jres = jforce(jnp.asarray(pPhi.numpy()), jelph, jfdm, jnp.asarray(x),
                  jplan(jelph, jstruct(np.asarray(jfdm.structure.neighbor_table), jfdm.n_sites)),
                  precond=jbuild_spectral(jfdm), tol=1e-5, maxiter=400, solve_dtype="float32")
    k3k4 = [(c.launches, c.plain_calls) for c in (pcg_force.PCG_FORCE, force.FORCE, pcg.PCG)]
    pres = fermionic_action_and_force(pPhi, pelph, pfdm, t64(x), build_force_plan(pelph, pfdm.structure),
                                      precond=build_spectral(pfdm), tol=1e-5, maxiter=400, solve_dtype="float32",
                                      fused_step=True, fused_force=True)
    assert [(c.launches, c.plain_calls) for c in (pcg_force.PCG_FORCE, force.FORCE, pcg.PCG)] == k3k4
    assert bool(pres.stats.converged)
    ref = np64(jres.force)
    np.testing.assert_allclose(pres.force.numpy(), ref, rtol=2e-4, atol=2e-4 * float(np.max(np.abs(ref))))
    np.testing.assert_allclose(float(pres.Sf), float(jres.Sf), rtol=2e-5)


# ----------------------------------------------------------------------
# one sweep fed the JAX package's draws
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["kpm", "spectral"])
@pytest.mark.parametrize("symmetric", SYM)
def test_complex_sweep_matches_jax_draws(symmetric, kind, monkeypatch):
    """reflection + swap + HMC on the complex chain from the same state and
    draws (the (2N,) Lanczos vectors included): the same accept flags, the
    field after every update and Delta H within 1e-6. KPM runs matrix-free
    (the plain K8 on the port's side)."""
    monkeypatch.setenv("SMOQY_KPM_MATRIX_FREE", "1")
    seed, Nt = 4, 6
    (jtbp, jelph), _ = cplx_models(**CHAIN)
    opts = dict(symmetric=symmetric, mixed_precision=True, force_dtype="float32", preconditioner=kind)
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    N = jctx.n_sites
    v_init = t64(_v0(jax.random.split(jax.random.PRNGKey(seed))[1], 2 * N)) if kind == "kpm" else None
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), lanczos_v0=v_init, **opts)
    assert pctx.complex_hops and pctx.lanczos_dim == 2 * N
    if kind == "kpm":
        assert jstate.precond.matrix_free and bool(jstate.precond.active)
        pstate.precond = KPMPreconditioner.build(make_fdm(pctx, pstate.x), v_init, matrix_free=True)
        _check_state(pstate.precond, jstate.precond)
    else:
        assert pstate.precond.complex_pair and jstate.precond.complex_pair
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
    if kind == "kpm":
        hd.v_pre0 = t64(_v0(jax.random.split(key, 6)[5], 2 * N))
    real_kernels = [mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE,
                    kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM]
    before = [c.plain_calls for c in real_kernels]
    k8, cplx = KPM_MF_CPLX.plain_calls, [c.plain_calls for c in CPLX_MTM.values()]
    pstate, pr = reflection_update(pctx, pstate, rd)
    assert pr.accepted == bool(ja_r)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_r), rtol=0, atol=1e-12)
    pstate, ps = swap_update(pctx, pstate, sd)
    assert ps.accepted == bool(ja_s)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_s), rtol=0, atol=1e-12)
    pstate, ph = hmc_update(pctx, pstate, HMCParams(Nt=Nt), hd)
    assert pr.converged and ps.converged and ph.converged and bool(jh.converged)
    assert ph.accepted == bool(jh.accepted)
    assert abs(ph.delta_H - float(jh.delta_H)) < 1e-6
    xj = np64(jfinal.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    # the complex path reaches none of the real-hopping kernels' plain versions
    assert [c.plain_calls for c in real_kernels] == before
    assert all(c.plain_calls > c0 for c, c0 in zip(CPLX_MTM.values(), cplx))
    assert (KPM_MF_CPLX.plain_calls > k8) == (kind == "kpm")
    if kind == "kpm":
        _check_state(pstate.precond, jfinal.precond)


def test_real_asymmetric_spectral_sweep_matches_jax_draws():
    """Item 13 on the real path: an asymmetric sweep with the spectral
    preconditioner, its f32 solves through K2's asymmetric plain version."""
    seed, Nt = 2, 6
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", L=2, beta=1.0, alpha=0.5)
    opts = dict(symmetric=False, mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), **opts)
    params = jhmc.HMCParams(Nt=Nt)

    @jax.jit
    def jax_sweep(s):
        s, r = jglobal.reflection_update(jctx, s)
        s1, sw = jglobal.swap_update(jctx, s)
        s2, h = jhmc.hmc_update(jctx, s1, params)
        return s2, r.accepted, sw.accepted, h

    jfinal, ja_r, ja_s, jh = jax_sweep(jstate)
    L, N, n_ph, n_cells = jctx.Ltau, jctx.n_sites, jctx.elph.n_phonon, jctx.elph.n_cells
    rd, key = _reflection_draws(jstate.key, len(_candidate_modes(pctx, None)), L, N)
    sd, key = _swap_draws(key, len(_type_pairs(pctx, None)), n_cells, L, N)
    hd, _ = _hmc_draws(key, n_ph, L, N)
    k2 = pcg.PCG.plain_calls
    pstate, pr = reflection_update(pctx, pstate, rd)
    pstate, ps = swap_update(pctx, pstate, sd)
    pstate, ph = hmc_update(pctx, pstate, HMCParams(Nt=Nt), hd)
    assert pcg.PCG.plain_calls > k2
    assert (pr.accepted, ps.accepted, ph.accepted) == (bool(ja_r), bool(ja_s), bool(jh.accepted))
    assert pr.converged and ps.converged and ph.converged
    assert abs(ph.delta_H - float(jh.delta_H)) < 1e-6
    xj = np64(jfinal.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))


# ----------------------------------------------------------------------
# convert, the kernels' refusals, the driver
# ----------------------------------------------------------------------


@pytest.mark.parametrize("matrix_free", [pytest.param(False, id="dense"), pytest.param(True, id="mf")])
def test_convert_complex_round_trips(matrix_free):
    """Complex parameters, the path integral, the fermion matrix and both
    complex_pair preconditioners carried across from the JAX package."""
    jfdm, pfdm, (jtbp, jelph), (ptbp, _), x = cplx_fdm_pair(x_seed=3, **KPM_CHAIN)
    ctbp = convert.tight_binding_parameters(jtbp, device="cpu")
    np.testing.assert_array_equal(ctbp.t0_im.numpy(), ptbp.t0_im.numpy())
    cfpi = convert.path_integral(jbuild_fpi(jtbp, jelph, x=jnp.asarray(x)), device="cpu")
    np.testing.assert_array_equal(cfpi.t_im.numpy(), np64(jbuild_fpi(jtbp, jelph, x=jnp.asarray(x)).t_im))
    cfdm = convert.fermion_det_matrix(jfdm, device="cpu")
    assert cfdm.complex_hops
    for a, b in ((cfdm.cb.S_im, pfdm.cb.S_im), (cfdm.sinh_hop_im, pfdm.sinh_hop_im), (cfdm.exp_nV, pfdm.exp_nV)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14, atol=1e-15)
    v = _pair(pfdm, 1)
    assert _rel(cfdm.mul_MtM(t64(v)).numpy(), pfdm.mul_MtM(t64(v)).numpy()) <= 1e-13
    jsp = jbuild_spectral(jfdm)
    csp = convert.spectral_preconditioner(np64(jsp.Q), np64(jsp.filt), jsp.Ltau, device="cpu", complex_pair=True)
    assert csp.complex_pair and csp.n_sites == pfdm.n_sites
    r = _pair(pfdm, 2)
    assert _rel(spectral_apply(csp, t64(r)).numpy(), np64(jspectral_apply(jsp, jnp.asarray(r)))) <= 1e-6
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(1), matrix_free=matrix_free)
    cpre = convert.kpm_preconditioner(jpre, device="cpu")
    assert cpre.complex_pair and cpre.matrix_free == matrix_free
    _check_state(cpre, jpre)
    np.testing.assert_allclose(cpre.bbar.cb.S_im.numpy(), np64(jpre.bbar.cb.S_im), rtol=1e-14, atol=1e-15)


def test_real_kernels_refuse_complex_fermion_matrix():
    """K1-K4, K6 and K7 (wrappers and plain versions) raise on a complex
    fermion matrix; K8's raise on a real one."""
    _, pfdm, _, (_, pelph), x = cplx_fdm_pair(**KPM_CHAIN)
    f32 = pfdm.astype(torch.float32)
    v = torch.zeros((2, pfdm.Ltau, pfdm.n_sites), dtype=torch.float32)
    Lam = build_lambda(pelph, t64(x), pfdm.n_sites).to(torch.float32)
    real_fdm = fdm_pair("chain", dict(L=4, beta=1.0))[1]
    spec = build_spectral(real_fdm)
    calls = [
        lambda: mtm.mtm_plain(f32, v), lambda: mtm.mtm_cuda(f32, v),
        lambda: pcg.pcg_plain(f32, spec, v, 1e-5, 10), lambda: pcg.pcg_cuda(f32, spec, v, 1e-5, 10),
        lambda: pcg.SpectralPCG(f32, spec),
        lambda: pcg_force.pcg_force_plain(f32, spec, v[None], v[None], Lam[None], 1e-5, 10, True),
        lambda: pcg_force.pcg_force_cuda(f32, spec, v[None], v[None], Lam[None], 1e-5, 10, True),
        lambda: force.force_planes_plain(f32, Lam, v, True), lambda: force.force_planes_cuda(f32, Lam, v, True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="real hoppings only"):
            call()
    pre = KPMPreconditioner.build(pfdm, t64(np.ones(2 * pfdm.n_sites)), matrix_free=True)
    ops = build_operands(pre)
    u = torch.zeros((pfdm.Ltau, pfdm.n_sites), dtype=torch.float32)
    for fn in (kpm_mf.kpm_mf_plain, kpm_mf.kpm_mf_asym_plain, kpm_mf.kpm_mf_cuda):
        with pytest.raises(ValueError, match="real hoppings only"):
            fn(ops, u, u)
    real_ops = dataclasses.replace(ops, S_im=None)
    for fn in (kpm_mf.kpm_mf_cplx_plain, kpm_mf.kpm_mf_cplx_cuda):
        with pytest.raises(ValueError, match="complex hoppings only"):
            fn(real_ops, u, u)


@pytest.mark.parametrize("symmetric", SYM)
def test_run_updates_complex_on_cpu(symmetric, monkeypatch):
    """The complex chain through the driver on CPU tensors, matrix-free KPM:
    every solve converges, KPM stays active, the complex M^dag M and K8's
    plain version run and no real-hopping kernel is reached; 'auto' (the
    doubled-basis spectral preconditioner) converges at W = 1 and on the
    walker path at W = 2."""
    from smoqyelphqmc_tpu_torch.ops import kpm as pkpm

    _, tbm, em = complex_chain_model(8)
    cfg = SimulationConfig(beta=2.0, dtau=0.1, Nt=4, seed=3, preconditioner="kpm", symmetric=symmetric)
    real_kernels = [mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM]
    before = [c.plain_calls for c in real_kernels]
    k8, cplx = KPM_MF_CPLX.plain_calls, [c.plain_calls for c in CPLX_MTM.values()]
    monkeypatch.setattr(pkpm, "MATRIX_FREE_MIN_SITES", 0)
    md = run_updates(tbm, em, cfg, 1, device="cpu")
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all() and md["kpm_active"] is True
    assert [c.plain_calls for c in real_kernels] == before
    assert KPM_MF_CPLX.plain_calls > k8 and all(c.plain_calls > c0 for c, c0 in zip(CPLX_MTM.values(), cplx))
    auto = run_updates(tbm, em, dataclasses.replace(cfg, preconditioner="auto"), 1, device="cpu")
    assert auto["all_converged"] and "kpm_active" not in auto
    walk = run_updates(tbm, em, dataclasses.replace(cfg, preconditioner="auto", n_walkers=2), 1, device="cpu")
    assert walk["all_converged"] and walk["walker_converged"] == [True, True]
    assert np.isfinite(walk["hmc_delta_H"]).all() and "kpm_active" not in walk
