"""Parity of the port's transforms, spectral preconditioner and solvers, and
of kernel K2 (the whole-solve spectral PCG).

Tolerances: the Fourier transforms are exact up to f64 rounding (1e-12); the
preconditioner's action, both built in f64, to 1e-10 (eigh differs in signs
and degenerate bases, so the action is compared, never Q); K2's plain version
against `_pcg_kernel` in interpret mode on solutions, rtol 2e-4 / atol 2e-5,
both converged (test_pallas.py:96); a warm start from the solution takes at
most one iteration (test_pallas.py:99-108); mixed-precision f64 solves agree
to 1e-8 (test_pallas.py:276). Iteration counts are not compared: the bf16
preconditioner of K2 and the f32 XLA one take different paths.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, fdm_pair, np64, t32, t64

from smoqyelphqmc_tpu.ops.fermion_det import solve_MtM as jsolve
from smoqyelphqmc_tpu.ops.fourier import AxisDFT as JAxisDFT
from smoqyelphqmc_tpu.ops.fourier import TauFourier as JTauFourier
from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_pcg
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.ops import pcg
from smoqyelphqmc_tpu_torch.ops.cg import cg_solve
from smoqyelphqmc_tpu_torch.ops.fermion_det import solve_MtM
from smoqyelphqmc_tpu_torch.ops.fourier import AxisDFT, TauFourier
from smoqyelphqmc_tpu_torch.ops.preconditioner import build_preconditioner
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral, spectral_apply


@pytest.mark.parametrize("Ltau", [8, 9, 240])
def test_tau_fourier_matches(Ltau):
    rng = np.random.default_rng(Ltau)
    vre, vim = rng.standard_normal((2, 3, Ltau, 5))
    jf, pf = JTauFourier.build(Ltau), TauFourier(Ltau)
    for pair, jpair in ((pf.forward(t64(vre), t64(vim)), jf.forward(jnp.asarray(vre), jnp.asarray(vim))),
                        (pf.forward(t64(vre)), jf.forward(jnp.asarray(vre))),
                        (pf.inverse(t64(vre), t64(vim)), jf.inverse(jnp.asarray(vre), jnp.asarray(vim)))):
        for got, ref in zip(pair, jpair):
            np.testing.assert_allclose(got.numpy(), np64(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_axis_dft_matches(inverse):
    rng = np.random.default_rng(3)
    vre, vim = rng.standard_normal((2, 4, 10))
    jd, pd = JAxisDFT.build(10, inverse=inverse), AxisDFT(10, inverse=inverse)
    for got, ref in zip(pd.apply(t64(vre), t64(vim), axis=1), jd.apply(jnp.asarray(vre), jnp.asarray(vim), axis=1)):
        np.testing.assert_allclose(got.numpy(), np64(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,kw", CASES)
def test_spectral_apply_action_f64(name, kw):
    """P^{-1} r with both preconditioners built in f64 (own eigh each): 1e-10."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=10)
    jpre, ppre = jbuild_spectral(jfdm, dtype="float64"), build_spectral(pfdm, dtype="float64")
    r = np.random.default_rng(11).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    ref = np64(jspectral_apply(jpre, jnp.asarray(r)))
    got = spectral_apply(ppre, t64(r)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-10


@pytest.mark.parametrize("name,kw", CASES)
def test_pcg_plain_matches_pallas_interpret(name, kw):
    """K2's plain version against `_pcg_kernel` in interpret mode, on the JAX
    preconditioner's Q and filt carried over with convert.py."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=12)
    jpre = jbuild_spectral(jfdm)
    fused = build_fused_pcg(jfdm, jpre, interpret=True)
    assert fused is not None
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jfdm.Ltau)
    b = np.random.default_rng(13).standard_normal((2, jfdm.Ltau, jfdm.n_sites)).astype(np.float32)
    xj, sj = fused(jnp.asarray(b), tol=1e-5, maxiter=200)
    xp, sp = pcg.SpectralPCG(pfdm, ppre)(t32(b), tol=1e-5, maxiter=200)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,kw", CASES)
def test_pcg_plain_with_port_preconditioner(name, kw):
    """The same against the port's own f32 eigh: solutions at rtol 2e-4 / atol 2e-5."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=14)
    fused = build_fused_pcg(jfdm, jbuild_spectral(jfdm), interpret=True)
    b = np.random.default_rng(15).standard_normal((2, jfdm.Ltau, jfdm.n_sites)).astype(np.float32)
    xj, sj = fused(jnp.asarray(b), tol=1e-5, maxiter=200)
    xp, sp = pcg.SpectralPCG(pfdm, build_spectral(pfdm))(t32(b), tol=1e-5, maxiter=200)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)


def test_pcg_warm_start_from_solution():
    """A warm start from the solution converges in at most one iteration."""
    _, pfdm, *_ = fdm_pair("chain", dict(L=6, beta=0.8, alpha=0.4), x_seed=16)
    solver = pcg.SpectralPCG(pfdm, build_spectral(pfdm))
    b = torch.randn((2, pfdm.Ltau, pfdm.n_sites), dtype=torch.float32, generator=torch.Generator().manual_seed(2))
    x, s = solver(b, tol=1e-5, maxiter=200)
    x2, s2 = solver(b, x0=x, tol=1e-5, maxiter=200)
    assert bool(s.converged) and bool(s2.converged)
    assert int(s2.iters) <= 1
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


def test_pcg_dispatch_cpu_counts_plain():
    _, pfdm, *_ = fdm_pair("honeycomb", dict(L=2, beta=0.4))
    pre = build_spectral(pfdm)
    launches, plain = pcg.PCG.launches, pcg.PCG.plain_calls
    b = torch.ones((2, pfdm.Ltau, pfdm.n_sites), dtype=torch.float32)
    x, s = solve_MtM(pfdm, b, precond=pre, tol=1e-5, maxiter=100)
    assert bool(s.converged) and x.dtype == torch.float32
    assert (pcg.PCG.launches, pcg.PCG.plain_calls) == (launches, plain + 1)


@pytest.mark.parametrize("name,kw", CASES)
def test_solve_mtm_f32_matches_jax(name, kw):
    """f32 solves through solve_MtM (K2 plain) against the JAX XLA path."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=17)
    b = np.random.default_rng(18).standard_normal((2, jfdm.Ltau, jfdm.n_sites)).astype(np.float32)
    xj, sj = jsolve(jfdm.astype("float32"), jnp.asarray(b), precond=jbuild_spectral(jfdm), tol=1e-5, maxiter=200)
    xp, sp = solve_MtM(pfdm, t32(b), precond=build_spectral(pfdm), tol=1e-5, maxiter=200)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,kw", CASES)
def test_solve_mtm_mixed_matches_jax(name, kw):
    """f64 mixed-precision defect correction (K2 inner solves, K1 residuals)
    against the JAX package's plain f64 solve: 1e-8."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=19)
    b = np.random.default_rng(20).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    xj, sj = jsolve(jfdm, jnp.asarray(b), precond=jbuild_spectral(jfdm), tol=1e-10, maxiter=400, mixed=False)
    xp, sp = solve_MtM(pfdm, t64(b), precond=build_spectral(pfdm), tol=1e-10, maxiter=400, mixed=True)
    assert bool(sj.converged) and bool(sp.converged) and xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=1e-8, atol=1e-9)


def test_cg_solve_f64_matches_jax():
    """The generic batched CG in f64 (spectral f32 apply) against the JAX one."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", dict(L=2, beta=0.6, alpha=0.3), x_seed=21)
    b = np.random.default_rng(22).standard_normal((3, jfdm.Ltau, jfdm.n_sites))
    from smoqyelphqmc_tpu.ops.cg import cg_solve as jcg

    xj, sj = jcg(jfdm.mul_MtM, jnp.asarray(b), precond=jbuild_spectral(jfdm).as_operator(), tol=1e-10, maxiter=400)
    xp, sp = cg_solve(pfdm.mul_MtM, t64(b), precond=build_spectral(pfdm).as_operator(), tol=1e-10, maxiter=400)
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=1e-8, atol=1e-9)


def test_preconditioner_kinds():
    """spectral and auto are ported; kpm, and auto above 4000 sites, raise."""
    _, pfdm, *_ = fdm_pair("chain", dict(L=4, beta=0.4))
    assert build_preconditioner("auto", pfdm) is not None
    assert build_preconditioner("none", pfdm) is None and build_preconditioner(None, pfdm) is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_preconditioner("kpm", pfdm)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_preconditioner("auto", SimpleNamespace(n_sites=4001))
    with pytest.raises(ValueError):
        build_preconditioner("cheb", pfdm)
