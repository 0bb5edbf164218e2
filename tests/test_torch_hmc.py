"""Parity of the port's action, forces, Fourier acceleration and updates with the
JAX package, and of one HMC trajectory and one full sweep given the JAX
package's exact random draws.

Tolerances: the bosonic action and the EFA tables are f64 chains (1e-12);
f32 forces 2e-4 and actions 2e-5 (test_pallas.py:143-146), the solves in the
two packages stopping at 1e-5 with different preconditioner arithmetic (bf16
in K2's plain version, f32 in the JAX XLA path). A trajectory integrates
those forces for Nt steps: its end field is held to 1e-6 relative and its
Delta H to 1e-6 absolute (measured 8e-8 and 1e-8 on the Nt=8 case), and the
accept decision must be the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, both_models, fdm_pair, np64, t64

from smoqyelphqmc_tpu.ops import bosonic as jbos
from smoqyelphqmc_tpu.ops.derivatives import build_force_plan as jplan
from smoqyelphqmc_tpu.ops.efa import FourierAccelerator as JEFA
from smoqyelphqmc_tpu.ops.pff import fermionic_action as jaction
from smoqyelphqmc_tpu.ops.pff import fermionic_action_and_force as jforce
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
from smoqyelphqmc_tpu_torch.ops import bosonic as pbos
from smoqyelphqmc_tpu_torch.ops.derivatives import build_force_plan
from smoqyelphqmc_tpu_torch.ops.efa import FourierAccelerator
from smoqyelphqmc_tpu_torch.ops.mtm import MTM
from smoqyelphqmc_tpu_torch.ops.pcg import PCG
from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action, fermionic_action_and_force, sample_pseudofermion_fields
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.global_updates import (
    ReflectionDraws,
    SwapDraws,
    _candidate_modes,
    _type_pairs,
    reflection_update,
    swap_update,
)
from smoqyelphqmc_tpu_torch.updates.hmc import HMCDraws, HMCParams, hmc_update

FORCE_CASES = CASES + [pytest.param("honeycomb", dict(L=2, beta=0.6, alpha=0.3, ph_sym=False), id="honeycomb-noph")]


def test_bosonic_action_and_anharmonic_force():
    (_, _, _, _, jelph), (_, _, _, _, pelph) = both_models("honeycomb", L=2, beta=0.6)
    jelph = jelph.replace(Omega4=jnp.full_like(jelph.Omega4, 0.1))
    pelph.Omega4 = torch.full_like(pelph.Omega4, 0.1)
    x = 0.4 * np.random.default_rng(1).standard_normal(np64(jelph.x).shape)
    assert abs(float(pbos.bosonic_action(pelph, t64(x))) - float(jbos.bosonic_action(jelph, jnp.asarray(x)))) < 1e-12
    got = pbos.add_anharmonic_force(torch.zeros_like(t64(x)), pelph, t64(x)).numpy()
    ref = np64(jbos.add_anharmonic_force(jnp.zeros_like(jnp.asarray(x)), jelph, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(pbos.harmonic_curvature(pelph).numpy(), np64(jbos.harmonic_curvature(jelph)),
                               rtol=1e-14)


def test_fourier_accelerator_matches():
    """Masses, rotation tables, momentum sampling, kinetic energy and the
    omega <-> tau transforms (f64; the f32 step transforms to 1e-6)."""
    (_, _, _, _, jelph), (_, _, _, _, pelph) = both_models("chain", L=4, beta=1.0)
    je, pe = JEFA.build(jelph, eta=0.2), FourierAccelerator.build(pelph, eta=0.2)
    np.testing.assert_allclose(pe.m.numpy(), np64(je.m), rtol=1e-14)
    for a, b in zip(pe.rotation(0.37), je.rotation(0.37)):
        np.testing.assert_allclose(a.numpy(), np64(b), rtol=1e-12, atol=1e-14)
    rng = np.random.default_rng(2)
    xi, x, f = rng.standard_normal((3,) + np64(jelph.x).shape)
    pw, K = pe.sample_momentum_omega(t64(xi))
    xr, xi_im = je.fwd.apply(jnp.asarray(xi), None, axis=1)
    s = jnp.sqrt(je.m)
    jpw = (s * xr, s * xi_im)
    for a, b in zip(pw, jpw):
        np.testing.assert_allclose(a.numpy(), np64(b), rtol=1e-12, atol=1e-12)
    assert abs(float(K) - float(je.kinetic_energy_omega(jpw))) < 1e-12 * abs(float(K))
    xw = pe.to_omega(t64(x))
    np.testing.assert_allclose(pe.to_tau(*xw).numpy(), x, atol=1e-13)
    jxw = je.to_omega(jnp.asarray(x))
    np.testing.assert_allclose(pe.to_tau_f32(*xw).numpy(), np64(je.to_tau_f32(*jxw)), atol=1e-6)
    for a, b in zip(pe.kick_omega_f32(pw, t64(f), 0.1), je.kick_omega_f32(jpw, jnp.asarray(f), 0.1)):
        np.testing.assert_allclose(a.numpy(), np64(b), atol=2e-6)


@pytest.mark.parametrize("name,kw", FORCE_CASES)
def test_pseudofermion_sampling_and_f64_action(name, kw):
    """Phi = Lambda^T M^T R (1e-12) and the f64 action at tol 1e-10 (1e-8)."""
    jfdm, pfdm, (_, jelph), (_, pelph), x = fdm_pair(name, kw, x_seed=3)
    R = np.random.default_rng(4).standard_normal((2, jfdm.Ltau, jfdm.n_sites)) / np.sqrt(2.0)
    pPhi, pSf = sample_pseudofermion_fields(t64(R), pelph, pfdm, t64(x))
    from smoqyelphqmc_tpu.ops.lambda_shift import build_lambda, mul_lambda_T

    jPhi = mul_lambda_T(build_lambda(jelph, jnp.asarray(x), jfdm.n_sites), jfdm.mul_Mt(jnp.asarray(R)))
    np.testing.assert_allclose(pPhi.numpy(), np64(jPhi), rtol=1e-12, atol=1e-12)
    assert abs(float(pSf) - float(np.sum(R * R))) < 1e-12 * float(pSf)
    jres = jaction(jPhi, jelph, jfdm, jnp.asarray(x), precond=jbuild_spectral(jfdm), tol=1e-10, maxiter=400)
    pres = fermionic_action(pPhi, pelph, pfdm, t64(x), precond=build_spectral(pfdm), tol=1e-10, maxiter=400,
                            mixed=True)
    assert bool(pres.stats.converged)
    assert abs(float(pres.Sf) - float(jres.Sf)) <= 1e-8 * abs(float(jres.Sf))


@pytest.mark.parametrize("name,kw", FORCE_CASES)
def test_f32_force_and_action_match(name, kw):
    """The f32 trajectory force path (K2 plain solve + plain force chain):
    force 2e-4 (atol 2e-4 of its scale), action 2e-5."""
    jfdm, pfdm, (_, jelph), (_, pelph), x = fdm_pair(name, kw, x_seed=5)
    R = np.random.default_rng(6).standard_normal((2, jfdm.Ltau, jfdm.n_sites)) / np.sqrt(2.0)
    pPhi, _ = sample_pseudofermion_fields(t64(R), pelph, pfdm, t64(x))
    from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct

    jres = jforce(jnp.asarray(pPhi.numpy()), jelph, jfdm, jnp.asarray(x),
                  jplan(jelph, jstruct(np.asarray(jfdm.structure.neighbor_table), jfdm.n_sites)),
                  precond=jbuild_spectral(jfdm), tol=1e-5, maxiter=400, solve_dtype="float32")
    pres = fermionic_action_and_force(pPhi, pelph, pfdm, t64(x), build_force_plan(pelph, pfdm.structure),
                                      precond=build_spectral(pfdm), tol=1e-5, maxiter=400, solve_dtype="float32")
    assert bool(pres.stats.converged) and pres.force.dtype == torch.float64
    ref = np64(jres.force)
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(pres.force.numpy(), ref, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(float(pres.Sf), float(jres.Sf), rtol=2e-5)


def test_f64_force_matches():
    """The f64 force chain (mixed solve at 1e-10): 1e-7 relative to its scale."""
    jfdm, pfdm, (_, jelph), (_, pelph), x = fdm_pair("honeycomb", dict(L=2, beta=0.6, alpha=0.3), x_seed=7)
    R = np.random.default_rng(8).standard_normal((2, jfdm.Ltau, jfdm.n_sites)) / np.sqrt(2.0)
    pPhi, _ = sample_pseudofermion_fields(t64(R), pelph, pfdm, t64(x))
    from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct

    jres = jforce(jnp.asarray(pPhi.numpy()), jelph, jfdm, jnp.asarray(x),
                  jplan(jelph, jstruct(np.asarray(jfdm.structure.neighbor_table), jfdm.n_sites)),
                  precond=jbuild_spectral(jfdm), tol=1e-10, maxiter=400)
    pres = fermionic_action_and_force(pPhi, pelph, pfdm, t64(x), build_force_plan(pelph, pfdm.structure),
                                      precond=build_spectral(pfdm), tol=1e-10, maxiter=400, mixed=True)
    ref = np64(jres.force)
    np.testing.assert_allclose(pres.force.numpy(), ref, rtol=1e-7, atol=1e-7 * float(np.max(np.abs(ref))))


# ----------------------------------------------------------------------
# whole updates, fed the JAX package's exact draws
# ----------------------------------------------------------------------

def _jax_normal_pair(key, Ltau, N):
    return t64(np64(jax.random.normal(key, (2, Ltau, N)) / jnp.sqrt(2.0)))


def _hmc_draws(key, n_ph, Ltau, N):
    """Replays the key splits of hmc.py:116 (and pff.py:50, efa.py:191)."""
    key, k_dt, k_phi, k_mom, k_acc, _ = jax.random.split(key, 6)
    return HMCDraws(u_dt=float(jax.random.uniform(k_dt)), R=_jax_normal_pair(k_phi, Ltau, N),
                    xi=t64(np64(jax.random.normal(k_mom, (n_ph, Ltau)))), u_acc=float(jax.random.uniform(k_acc))), key


def _reflection_draws(key, n_cands, Ltau, N):
    """Replays global_updates.py:104-106."""
    key, k_mode, k_phi, k_acc, _ = jax.random.split(key, 5)
    return ReflectionDraws(mode=int(jax.random.randint(k_mode, (), 0, n_cands)), R=_jax_normal_pair(k_phi, Ltau, N),
                           u_acc=float(jax.random.uniform(k_acc))), key


def _swap_draws(key, n_pairs, n_cells, Ltau, N):
    """Replays global_updates.py:141-149."""
    key, k_pair, k_c1, k_c2, k_phi, k_acc, _ = jax.random.split(key, 7)
    return SwapDraws(pair=int(jax.random.randint(k_pair, (), 0, n_pairs)),
                     c1=int(jax.random.randint(k_c1, (), 0, n_cells)),
                     shift=int(jax.random.randint(k_c2, (), 1, max(n_cells, 2))),
                     c2_other=int(jax.random.randint(k_c2, (), 0, n_cells)),
                     R=_jax_normal_pair(k_phi, Ltau, N), u_acc=float(jax.random.uniform(k_acc))), key


def _both_chains(seed=2, **kw):
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", **kw)
    opts = dict(mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=seed, **opts)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp), convert.electron_phonon_parameters(jelph),
                                  **opts)
    return jctx, jstate, pctx, pstate


def _jax_H0(jctx, jstate, x0):
    """H0 = |R|^2 + S_b(x0) + K0 from the trajectory's own keys (hmc.py:116-137)."""
    _, _, k_phi, k_mom, _, _ = jax.random.split(jstate.key, 6)
    R = jax.random.normal(k_phi, (2, jctx.Ltau, jctx.n_sites)) / jnp.sqrt(2.0)
    _, K0 = jctx.efa.sample_momentum_omega(k_mom)
    return float(jnp.sum(R * R) + jbos.bosonic_action(jctx.elph, x0) + K0)


def test_hmc_trajectory_matches_jax_draws():
    """One leapfrog trajectory (Nt=8) from the same field and draws: the same
    H0 (1e-12), end field (1e-6 relative), Delta H (1e-6) and accept decision."""
    jctx, jstate, pctx, pstate = _both_chains(L=2, beta=1.0, alpha=0.5)
    x0 = jnp.asarray(jstate.x)
    params = jhmc.HMCParams(Nt=8)
    draws, _ = _hmc_draws(jstate.key, jctx.elph.n_phonon, jctx.Ltau, jctx.n_sites)
    jnew, jst = jax.jit(lambda s: jhmc.hmc_update(jctx, s, params))(jstate)
    pnew, pst = hmc_update(pctx, pstate, HMCParams(Nt=8), draws)
    assert bool(jst.converged) and pst.converged
    assert abs(pst.H0 - _jax_H0(jctx, jstate, x0)) <= 1e-12 * abs(pst.H0)
    assert abs(pst.delta_H - float(jst.delta_H)) < 1e-6
    assert pst.accepted == bool(jst.accepted)
    xj = np64(jnew.x)
    assert np.max(np.abs(pnew.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    # a trajectory moves the field when accepted: this case exercises a real move
    assert pst.accepted and np.max(np.abs(xj - np64(x0))) > 1e-3


def test_sweep_matches_jax_draws():
    """reflection + swap + HMC from the same state and draws: the same accept
    flags, and the same field after every update (1e-6 relative)."""
    jctx, jstate, pctx, pstate = _both_chains(seed=4, L=2, beta=1.0, alpha=0.5)
    n_cands = len(_candidate_modes(pctx, None))
    n_pairs = len(_type_pairs(pctx, None))
    L, N, n_ph, n_cells = jctx.Ltau, jctx.n_sites, jctx.elph.n_phonon, jctx.elph.n_cells
    params = jhmc.HMCParams(Nt=8)

    @jax.jit
    def jax_sweep(s):
        s, r = jglobal.reflection_update(jctx, s)
        s1, sw = jglobal.swap_update(jctx, s)
        s2, h = jhmc.hmc_update(jctx, s1, params)
        return s.x, s1.x, s2, r.accepted, sw.accepted, h.accepted

    jx_r, jx_s, jfinal, ja_r, ja_s, ja_h = jax_sweep(jstate)
    key = jstate.key
    rd, key = _reflection_draws(key, n_cands, L, N)
    sd, key = _swap_draws(key, n_pairs, n_cells, L, N)
    hd, key = _hmc_draws(key, n_ph, L, N)
    pstate, pr = reflection_update(pctx, pstate, rd)
    assert pr.accepted == bool(ja_r)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_r), rtol=0, atol=1e-12)
    pstate, ps = swap_update(pctx, pstate, sd)
    assert ps.accepted == bool(ja_s)
    np.testing.assert_allclose(pstate.x.numpy(), np64(jx_s), rtol=0, atol=1e-12)
    pstate, ph = hmc_update(pctx, pstate, HMCParams(Nt=8), hd)
    assert ph.accepted == bool(ja_h) and pr.converged and ps.converged and ph.converged
    xj = np64(jfinal.x)
    assert np.max(np.abs(pstate.x.numpy() - xj)) <= 1e-6 * np.max(np.abs(xj))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jfinal.key))


def test_run_updates_on_cpu_uses_plain_versions():
    """The driver's sweep loop on CPU tensors: plain versions only, no launch."""
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    counters = (MTM[torch.float32], MTM[torch.float64], PCG)
    before = [(c.launches, c.plain_calls) for c in counters]
    md = run_updates(tbm, em, SimulationConfig(beta=1.0, dtau=0.1, Nt=6, seed=7), 2)
    after = [(c.launches, c.plain_calls) for c in counters]
    assert md["all_converged"] and all(np.isfinite(md["hmc_delta_H"]))
    assert md["x_final"].shape == (8, 10) and md["x_final"].dtype == torch.float64
    for (l0, p0), (l1, p1) in zip(before, after):
        assert l1 == l0 and p1 > p0
    for k in ("reflection", "swap", "hmc"):
        assert 0.0 <= md[f"{k}_acceptance_rate"] <= 1.0 and md[f"{k}_iters"] > 0


def test_draw_helpers_shapes():
    from smoqyelphqmc_tpu_torch.updates.global_updates import draw_reflection, draw_swap
    from smoqyelphqmc_tpu_torch.updates.hmc import draw_hmc

    _, _, pctx, _ = _both_chains(L=2, beta=0.4)
    gen = torch.Generator().manual_seed(0)
    h = draw_hmc(gen, pctx)
    assert h.R.shape == (2, pctx.Ltau, pctx.n_sites) and h.xi.shape == (pctx.elph.n_phonon, pctx.Ltau)
    assert 0.0 <= h.u_dt < 1.0 and 0.0 <= h.u_acc < 1.0
    r = draw_reflection(gen, pctx)
    assert 0 <= r.mode < pctx.elph.n_phonon
    s = draw_swap(gen, pctx)
    assert 0 <= s.c1 < pctx.elph.n_cells and 1 <= s.shift < pctx.elph.n_cells
