"""The algebra of K4's tau blocks (ops/force.py:force_blocked_plain): the
force planes P1, P2 computed block by block of T rows, as csrc/force.cu
computes them (T+1 B applications a block, the half sweep of P1 carried on
through expV and CB for P2's B^T A), against the plain version
`force.planes` and the JAX package's `FusedForce` (_force_kernel in
interpret mode); and the host's choice of T. CPU only.

Tolerances: against `force.planes` 1e-5 relative to max|P| (the same f32
operations, B A grouped as CB (expV (CB^T A))); against FusedForce rtol 2e-4
with atol 2e-4 max|P| (tests/test_torch_walkers.py, tests/test_pallas.py:
182-195).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import fdm_pair, t32, t64

from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_force
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.ops import force, mtm, pcg_force
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda

# honeycomb L = 2 at Ltau 9 (odd) and 6; chain L = 6 at Ltau 8; no
# particle-hole-symmetric form (want_p2 off on the JAX side)
CASES = {
    "honeycomb-Ltau-9": ("honeycomb", dict(L=2, beta=0.9, alpha=0.3)),
    "honeycomb-Ltau-6": ("honeycomb", dict(L=2, beta=0.6, alpha=0.3)),
    "chain-Ltau-8": ("chain", dict(L=6, beta=0.8, alpha=0.4)),
    "honeycomb-noph": ("honeycomb", dict(L=2, beta=0.6, alpha=0.3, ph_sym=False)),
}
# T: one row, two (ragged at odd Ltau), three, four (ragged), all of Ltau
TS = [1, 2, 3, 4, None]


@functools.lru_cache(maxsize=None)
def _problem(case, W):
    """(fdm32, Lam (f32), psi_raw (f32), want_p2, JAX FusedForce's planes at
    W = 1 else None): the case's model at a field from a seed, W walkers
    jittered from it."""
    name, kw = CASES[case]
    jfdm, pfdm, _, (ptbp, pelph), x = fdm_pair(name, kw, x_seed=81)
    want_p2 = bool(np.any(pelph.hol_ph_sym))
    L, N = pfdm.Ltau, pfdm.n_sites
    rng = np.random.default_rng(82)
    if W == 1:
        xs, fdm = x, pfdm
    else:
        xs = x[None] + 0.1 * rng.standard_normal((W,) + x.shape)
        fdm = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(xs)), pfdm.structure)
        fdm = dataclasses.replace(fdm, exp_nV=fdm.exp_nV[:, None])
    Lam = build_lambda(pelph, t64(xs), N).to(torch.float32)
    psi = rng.standard_normal(((W,) if W > 1 else ()) + (2, L, N)).astype(np.float32)
    ref = None
    if W == 1:
        fused = build_fused_force(jfdm, jnp.asarray(Lam.numpy()), want_p2, interpret=True)
        assert fused is not None
        ref = tuple(np.asarray(p) for p in fused(jnp.asarray(psi)))
    return fdm.astype(torch.float32), Lam, t32(psi), want_p2, ref


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("T", TS, ids=[f"T-{t}" if t else "T-Ltau" for t in TS])
@pytest.mark.parametrize("case", ["honeycomb-Ltau-9", "chain-Ltau-8"])
def test_force_blocks_match_planes(case, T, W, want_p2):
    """Blocks of T rows against the row-at-a-time plain version, one and two
    walkers; a block of T rows takes T + 1 B applications."""
    fdm32, Lam, psi, _, _ = _problem(case, W)
    L = fdm32.Ltau
    T = L if T is None else T
    P1, P2, n_apply = force.force_blocked_plain(fdm32, Lam, psi, want_p2, T)
    ref = force.planes(fdm32, Lam, psi, want_p2)
    for got, r in zip((P1, P2), ref):
        assert got.shape == r.shape
        assert float((got - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-30)
    if not want_p2:
        assert not P2.any()
    assert n_apply == sum(min(T, L - l0) + 1 for l0 in range(0, L, T))


@pytest.mark.parametrize("T", TS, ids=[f"T-{t}" if t else "T-Ltau" for t in TS])
@pytest.mark.parametrize("case", list(CASES))
def test_force_blocks_match_fused_force(case, T):
    """Blocks of T rows against FusedForce (the JAX package's _force_kernel
    in interpret mode) on one channel pair; want_p2 as the model has it."""
    fdm32, Lam, psi, want_p2, ref = _problem(case, 1)
    P1, P2, _ = force.force_blocked_plain(fdm32, Lam, psi, want_p2, fdm32.Ltau if T is None else T)
    for got, r in zip((P1, P2), ref):
        np.testing.assert_allclose(got.numpy(), r, rtol=2e-4, atol=2e-4 * max(float(np.max(np.abs(r))), 1e-30))


@pytest.mark.parametrize("N", [18, 288, 3300, 4608, 7200])
def test_force_tau_block_rows_cover_and_fit(N):
    """K4's choice of T: each walker's blocks cover its tau rows once, in
    order; the fewest rows whose blocks make one round of the resident CTAs,
    else the most that fit a CTA (227 KB). The shared memory is 3T + 1 rows
    of 8-byte values at a 16-byte aligned stride past the spare site and, in
    the staged form (taken where a block of one row fits it), the block's x
    (two channels) and Lambda, 3T + 6 rows of N floats; the other form takes
    N up to the row-at-a-time design's ~7260."""
    ld = mtm.row_ld(N, 8)
    assert ld > N and (ld * 8) % 16 == 0 and ld - N <= 2
    assert force.smem_bytes(N, 3, False) == 10 * ld * 8
    assert force.smem_bytes(N, 3, True) == 10 * ld * 8 + 15 * N * 4
    staged = force.staged_form(N)
    assert staged == (N <= 3300)
    for W, L, per_sm in ((1, 240, 2), (1, 240, 1), (8, 240, 8), (8, 240, 2), (1, 9, 1), (2, 10, 4)):
        def resident(T):  # per_sm CTAs an SM of 132 while they fit its 228 KB
            return 132 * max(1, min(per_sm, 228 * 1024 // force.smem_bytes(N, T, staged)))
        T = force.tau_block_rows(W, L, N, resident, staged)
        assert 1 <= T <= L and force.smem_bytes(N, T, staged) <= 227 * 1024
        rows = [l0 + i for l0, nr in pcg_force.tau_blocks(L, T) for i in range(nr)]
        assert rows == list(range(L))
        if W * -(-L // T) <= resident(T):
            assert T == 1 or W * -(-L // (T - 1)) > resident(T - 1)  # the fewest that make a round
        else:
            assert T == L or force.smem_bytes(N, T + 1, staged) > 227 * 1024  # the most that fit
    # the fused_force path: one walker of 240 rows, two CTAs an SM: T = 1
    if N == 288:
        assert force.tau_block_rows(1, 240, N, lambda T: 264) == 1
        assert force.tau_block_rows(8, 240, N, lambda T: 1056) == 2
    with pytest.raises(ValueError, match="does not fit"):
        force.tau_block_rows(1, 240, 7300, lambda T: 132, False)


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
@pytest.mark.parametrize("n_colors", [0, 2, 3])
def test_force_phase_names(n_colors, want_p2):
    """The timed instantiation's phases: staging, B's 2 n_colors stages (one
    if no color), A, n_colors half-sweep stages, then P1 and the output, or
    P1, n_colors forward stages (one if no color) and P2."""
    names = force.phase_names(n_colors, want_p2)
    nb = 2 * n_colors if n_colors else 1
    assert names[0] == "stage" and names[nb + 1] == "A"
    assert len(names) == 1 + nb + 1 + n_colors + (1 + max(n_colors, 1) + 1 if want_p2 else 1)
    assert len(set(names)) == len(names)
