"""Kernels K1 and K2 on SSH models, whose hopping tables differ from one tau
row to the next (the kernels' tau-table forms): K2's plain version against
the JAX package's `_pcg_kernel` in interpret mode on the SSH chain (as
tests/test_pallas.py:298-310 runs it), K1's tau-blocked pair algebra against
`_mtm_kernel_roll` in interpret mode, and the f64 solve of the
mixed-precision defect correction (K2 inner solves, K1 residuals) against
the JAX package's solve_MtM.

Tolerances: K2 solutions at rtol 2e-4 / atol 2e-5, both converged
(test_pallas.py:96); the interpret-mode K1 computes in f32: 2e-6
(test_pallas.py:65); the mixed f64 solves at tol 1e-10 to 1e-8 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import np64, t32, t64
from test_torch_ssh_models import both, fdms, field

from smoqyelphqmc_tpu.ops.fermion_det import solve_MtM as jsolve
from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_mtm, build_fused_pcg
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.ops import mtm, pcg
from smoqyelphqmc_tpu_torch.ops.fermion_det import solve_MtM

torch.set_num_threads(2)


def _pair(kind, symmetric, seed, L=None):
    """JAX and port fermion matrices of one model at a seeded field."""
    (_, _, _, _, jelph), _ = both(kind, L=L)
    jf, pf, _, _ = fdms(kind, field(jelph, seed), symmetric, L=L)
    return jf, pf


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
def test_pcg_plain_matches_pallas_interpret_ssh(symmetric):
    """K2's plain version on the SSH chain's tau tables against `_pcg_kernel`
    in interpret mode, with the JAX preconditioner's Q and filt."""
    jf, pf = _pair("ossh_chain", symmetric, 1)
    assert not jf.static_hops and not pf.static_hops
    jpre = jbuild_spectral(jf)
    fused = build_fused_pcg(jf, jpre, interpret=True)
    assert fused is not None
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jf.Ltau, device="cpu")
    b = np.random.default_rng(13).standard_normal((2, jf.Ltau, jf.n_sites)).astype(np.float32)
    xj, sj = fused(jnp.asarray(b), tol=1e-5, maxiter=400)
    calls = pcg.PCG.plain_calls
    xp, sp = pcg.SpectralPCG(pf, ppre)(t32(b), tol=1e-5, maxiter=400)
    assert pcg.PCG.plain_calls == calls + 1
    assert bool(sj.converged) and bool(sp.converged)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("T", [pytest.param(2, id="T-2"), pytest.param(5, id="T-5-ragged"),
                               pytest.param(None, id="T-Ltau")])
def test_mtm_pairs_plain_matches_pallas_interpret_ssh(T, symmetric):
    """K1's pair algebra on the SSH honeycomb's tau tables (L=3) against
    `_mtm_kernel_roll` in interpret mode, ragged last tau block included."""
    jf, pf = _pair("ossh_honeycomb", symmetric, 2, L=3)
    fused = build_fused_mtm(jf, interpret=True)
    assert fused is not None
    L = pf.Ltau
    v = np.random.default_rng(3).standard_normal((2, L, pf.n_sites)).astype(np.float32)
    ref = np.asarray(fused(jnp.asarray(v)), dtype=np.float64)
    got, _ = mtm.mtm_blocked_plain(pf, t64(v), L if T is None else T, pairs=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["ossh_honeycomb", "bssh_square_disp"])
def test_mixed_solve_matches_jax_ssh(kind):
    """The mixed-precision f64 solve on SSH tables (K2 inner solves, K1 f64
    residuals in plain versions) against the JAX package's solve_MtM."""
    jf, pf = _pair(kind, True, 4)
    jpre = jbuild_spectral(jf)
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jf.Ltau, device="cpu")
    b = np.random.default_rng(5).standard_normal((2, jf.Ltau, jf.n_sites))
    xj, sj = jsolve(jf, jnp.asarray(b), precond=jpre, tol=1e-10, maxiter=2000, mixed=True)
    calls = (mtm.MTM[torch.float64].plain_calls, pcg.PCG.plain_calls)
    xp, sp = solve_MtM(pf, t64(b), precond=ppre, tol=1e-10, maxiter=2000, mixed=True)
    assert mtm.MTM[torch.float64].plain_calls > calls[0] and pcg.PCG.plain_calls > calls[1]
    assert bool(sj.converged) and bool(sp.converged)
    ref = np64(xj)
    assert np.max(np.abs(xp.numpy() - ref)) <= 1e-8 * np.max(np.abs(ref))
