"""Parity of the port's fermion matrix M and of kernel K1 (M^T M).

Tolerances (tests/test_pallas.py): f64 propagator chains agree to 1e-12
relative (the same operations in another library, so only the last bits of
exp/cosh/sinh differ); K1's plain f32 version is held to the Pallas kernel
`_mtm_kernel_roll` in interpret mode at 2e-6 (test_pallas.py:65). The CUDA
kernel is held to its plain version on the GPU (tests/test_torch_gpu.py). On a
lattice whose partner maps need more than 8 lane-shift classes the JAX package
switches to `_mtm_kernel_mm` (exact bf16 permutation matmuls); K1's partner
gather computes the same function, held to it at the same 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, fdm_pair, np64, t32, t64

from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_mtm
from smoqyelphqmc_tpu_torch.ops import mtm

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("name,kw", CASES)
def test_propagator_chain_f64(name, kw, symmetric):
    """apply_B, apply_Bt, mul_M, mul_Mt and mul_MtM in f64 at 1e-12 relative."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=4, symmetric=symmetric)
    v = np.random.default_rng(5).standard_normal((2, jfdm.Ltau, jfdm.n_sites))
    for op in ("apply_B", "apply_Bt", "mul_M", "mul_Mt", "mul_MtM"):
        got = getattr(pfdm, op)(t64(v)).numpy()
        ref = np64(getattr(jfdm, op)(jnp.asarray(v)))
        assert _rel(got, ref) < 1e-12, op


@pytest.mark.parametrize("name,kw", CASES)
def test_propagator_factors_f64(name, kw):
    """exp(-dtau V) and the checkerboard planes at 1e-14 relative."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=6)
    np.testing.assert_allclose(pfdm.exp_nV.numpy(), np64(jfdm.exp_nV), rtol=1e-14)
    np.testing.assert_allclose(pfdm.cb.C.numpy(), np64(jfdm.cb.C), rtol=1e-14)
    np.testing.assert_allclose(pfdm.cb.S.numpy(), np64(jfdm.cb.S), rtol=1e-14, atol=1e-300)
    np.testing.assert_array_equal(pfdm.cb.partner.numpy(), np.asarray(jfdm.cb.partner))


@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("name,kw", CASES)
def test_mtm_plain_f32_matches_pallas_interpret(name, kw, symmetric):
    """K1's plain version in f32 against `_mtm_kernel_roll` in interpret mode: 2e-6."""
    jfdm, pfdm, *_ = fdm_pair(name, kw, x_seed=7, symmetric=symmetric)
    fused = build_fused_mtm(jfdm, interpret=True)
    assert fused is not None and fused.mode == "roll"
    v = np.random.default_rng(8).standard_normal((2, jfdm.Ltau, jfdm.n_sites)).astype(np.float32)
    ref = np.asarray(fused(jnp.asarray(v)), dtype=np.float32)
    got = mtm.mtm_plain(pfdm.astype(torch.float32), t32(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("symmetric", SYM)
def test_mtm_plain_f32_matches_pallas_matmul_variant(symmetric):
    """An irregular lattice (honeycomb L=3, site labels permuted): the JAX
    package takes `_mtm_kernel_mm`; K1's plain version matches it at 2e-6."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", dict(L=3, beta=0.5, alpha=0.4), x_seed=9, symmetric=symmetric,
                              perm_seed=10)
    fused = build_fused_mtm(jfdm, interpret=True)
    assert fused is not None and fused.mode == "matmul"
    v = np.random.default_rng(11).standard_normal((2, jfdm.Ltau, jfdm.n_sites)).astype(np.float32)
    ref = np.asarray(fused(jnp.asarray(v)), dtype=np.float32)
    got = mtm.mtm_plain(pfdm.astype(torch.float32), t32(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


def test_mtm_dispatch_cpu_takes_plain_version():
    """A CPU tensor takes the plain version and launches nothing; the dtype of
    the fermion matrix selects the f32 or f64 counter."""
    _, pfdm, *_ = fdm_pair("chain", dict(L=4, beta=0.4))
    v = torch.ones((2, pfdm.Ltau, pfdm.n_sites), dtype=torch.float64)
    c64, c32 = mtm.MTM[torch.float64], mtm.MTM[torch.float32]
    before = (c64.plain_calls, c64.launches, c32.plain_calls)
    out = pfdm.mul_MtM(v)
    assert out.shape == v.shape and out.dtype == torch.float64
    assert (c64.plain_calls, c64.launches, c32.plain_calls) == (before[0] + 1, before[1], before[2])


def test_mtm_kernel_tables_compress_static_hops():
    """Without SSH couplings the C/S tables are one tau row: (n_colors, 1, N)."""
    _, pfdm, *_ = fdm_pair("honeycomb", dict(L=2, beta=0.4))
    C, S, partner, expV = mtm.mtm_tables(pfdm)
    nc = pfdm.cb.n_colors
    assert C.shape == (nc, 1, pfdm.n_sites) and S.shape == C.shape
    assert partner.dtype == torch.int32 and partner.shape == (nc, pfdm.n_sites)
    assert expV.shape == (pfdm.Ltau, pfdm.n_sites)
    np.testing.assert_array_equal(C[:, 0].numpy(), pfdm.cb.C[:, -1].numpy())
