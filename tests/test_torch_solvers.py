"""Parity of the port's transforms, spectral preconditioner and solvers, of
kernel K2 (the whole-solve spectral PCG), of the tau-blocked M^T M rows of
K3's matvec phases with the host's choice of their block size, and of K1's
algebra (checkerboard pairs updated in place on tau blocks) with its host
side (pair tables, launch form, T).

Tolerances: the Fourier transforms are exact up to f64 rounding (1e-12); the
preconditioner's action, both built in f64, to 1e-10 (eigh differs in signs
and degenerate bases, so the action is compared, never Q); K2's plain version
against `_pcg_kernel` in interpret mode on solutions, rtol 2e-4 / atol 2e-5,
both converged (test_pallas.py:96); a warm start from the solution takes at
most one iteration (test_pallas.py:99-108); mixed-precision f64 solves agree
to 1e-8 (test_pallas.py:276). Iteration counts are not compared: the bf16
preconditioner of K2 and the f32 XLA one take different paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CASES, fdm_pair, np64, port_chain_model, t32, t64

from smoqyelphqmc_tpu.ops.fermion_det import solve_MtM as jsolve
from smoqyelphqmc_tpu.ops.fourier import AxisDFT as JAxisDFT
from smoqyelphqmc_tpu.ops.fourier import TauFourier as JTauFourier
from smoqyelphqmc_tpu.ops.pallas_fused import build_fused_mtm, build_fused_pcg
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral as jbuild_spectral
from smoqyelphqmc_tpu.ops.spectral_precond import spectral_apply as jspectral_apply
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.ops import mtm, pcg, pcg_force
from smoqyelphqmc_tpu_torch.ops.cg import cg_solve
from smoqyelphqmc_tpu_torch.ops.fermion_det import solve_MtM
from smoqyelphqmc_tpu_torch.ops.fourier import AxisDFT, TauFourier
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
from smoqyelphqmc_tpu_torch.ops.preconditioner import build_preconditioner
from smoqyelphqmc_tpu_torch.ops.spectral_precond import SpectralPreconditioner, build_spectral, spectral_apply
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc


@pytest.mark.parametrize("Ltau", [8, 9, 240])
def test_tau_fourier_matches(Ltau):
    rng = np.random.default_rng(Ltau)
    vre, vim = rng.standard_normal((2, 3, Ltau, 5))
    jf, pf = JTauFourier.build(Ltau), TauFourier(Ltau, device="cpu")
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
    ppre = convert.spectral_preconditioner(jpre.Q, jpre.filt, jfdm.Ltau, device="cpu")
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


@pytest.mark.parametrize("Ltau_beta", [1.0, 0.9], ids=["even-Ltau", "odd-Ltau"])
def test_pcg_operands_transposes(Ltau_beta):
    """K2 / K3's Wt and Qt are W and Q transposed, exactly, bf16 and contiguous."""
    _, pfdm, *_ = fdm_pair("honeycomb", dict(L=3, beta=Ltau_beta), x_seed=23)
    ops = build_spectral(pfdm).pcg_operands()
    for m, mt in ((ops.W, ops.Wt), (ops.Q, ops.Qt)):
        assert mt.dtype == torch.bfloat16 and mt.is_contiguous() and m.is_contiguous()
        assert torch.equal(mt, m.T)
    assert ops.W.shape == (2 * ops.Lh, pfdm.Ltau) and ops.filt.shape == (ops.Lh, pfdm.n_sites)


@pytest.mark.parametrize("name,kw", CASES)
def test_precond_plain_bf16_intermediates_exact(name, kw):
    """The plain preconditioner, which stores U, Am and Bm in bf16 as the
    kernels do, equals the form that rounds them to bf16 on every read, bit
    for bit (the f32 sums are the same; only the storage changed)."""
    _, pfdm, *_ = fdm_pair(name, kw, x_seed=24)
    pre = build_spectral(pfdm)
    r = t32(np.random.default_rng(25).standard_normal((3, pfdm.Ltau, pfdm.n_sites)))
    ops = pre.pcg_operands()
    Wf, Qf = ops.W.to(torch.float32), ops.Q.to(torch.float32)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    U = torch.einsum("ml,bln->bmn", Wf, bf16(r))
    A = (bf16(U) @ Qf) * torch.cat([ops.filt, ops.filt])
    ref = torch.einsum("ml,bmn->bln", Wf, bf16(bf16(A) @ Qf.T))
    assert torch.equal(pcg.precond_plain(pre, r), ref)


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
    """spectral, auto, kpm and none; auto picks KPM above 4000 sites, and a
    KPM preconditioner needs its Lanczos start vector."""
    _, pfdm, *_ = fdm_pair("chain", dict(L=4, beta=0.4))
    v0 = torch.ones(pfdm.n_sites, dtype=torch.float64)
    assert isinstance(build_preconditioner("auto", pfdm), SpectralPreconditioner)
    assert build_preconditioner("none", pfdm) is None and build_preconditioner(None, pfdm) is None
    pre = build_preconditioner("kpm", pfdm, v0)
    assert isinstance(pre, KPMPreconditioner) and not pre.matrix_free
    with pytest.raises(ValueError, match="start vector"):
        build_preconditioner("kpm", pfdm)
    _, _, tbp, _, elph = port_chain_model(L=4001, beta=0.2)
    _, state = initialize_qmc(tbp, elph, lanczos_v0=torch.ones(4001, dtype=torch.float64))
    assert isinstance(state.precond, KPMPreconditioner) and state.precond.matrix_free
    with pytest.raises(ValueError):
        build_preconditioner("cheb", pfdm)


BLOCK_T = [pytest.param(T, id=f"T-{T}") for T in (1, 2, 3, 4)] + [pytest.param(None, id="T-Ltau")]
LTAU = [pytest.param(0.9, id="Ltau-9"), pytest.param(1.0, id="Ltau-10")]


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("beta", LTAU)
@pytest.mark.parametrize("T", BLOCK_T)
def test_mtm_blocked_plain_matches_mul_MtM(T, beta, symmetric):
    """The tau-blocked algebra of K3's matvec phases (ops/mtm.py:
    mtm_blocked_plain) against M^T M in f64: 1e-12, with 2 nr + 1 B
    applications for each block of nr rows (the last block ragged where T
    does not divide Ltau, the rows wrapping periodically with sgn1 / sgnL at
    rows 0 and Ltau - 1)."""
    _, pfdm, *_ = fdm_pair("honeycomb", dict(L=3, beta=beta, alpha=0.4), x_seed=26, symmetric=symmetric)
    L = pfdm.Ltau
    T = L if T is None else T
    v = t64(np.random.default_rng(27).standard_normal((2, L, pfdm.n_sites)))
    got, n_apply = mtm.mtm_blocked_plain(pfdm, v, T)
    ref = pfdm.mul_Mt(pfdm.mul_M(v))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    assert n_apply == sum(2 * nr + 1 for _, nr in pcg_force.tau_blocks(L, T))


@pytest.mark.parametrize("beta", LTAU)
@pytest.mark.parametrize("T", [pytest.param(1, id="T-1"), pytest.param(3, id="T-3"), pytest.param(None, id="T-Ltau")])
def test_mtm_blocked_plain_matches_pallas_interpret(T, beta):
    """The same blocked algebra against `_mtm_kernel_roll` in interpret mode,
    which computes in f32: 2e-6 (tests/test_pallas.py:65)."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", dict(L=3, beta=beta, alpha=0.4), x_seed=28)
    fused = build_fused_mtm(jfdm, interpret=True)
    assert fused is not None and fused.mode == "roll"
    L = pfdm.Ltau
    v = np.random.default_rng(29).standard_normal((2, L, pfdm.n_sites)).astype(np.float32)
    ref = np.asarray(fused(jnp.asarray(v)), dtype=np.float64)
    got, _ = mtm.mtm_blocked_plain(pfdm, t64(v), L if T is None else T)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("N", [18, 288, 4000])
def test_tau_block_rows_cover_and_fit(N):
    """K3's choice of T: each system's blocks cover its tau rows once, in
    order; the blocks make one round of the grid where the budget allows;
    the shared memory stays within the budget that keeps two CTAs on an SM,
    except at large N, where a block is one row and the launch stays under
    the card's 227 KB a CTA."""
    for n_sys, L, grid in ((16, 240, 264), (2, 240, 264), (2, 9, 264), (6, 10, 132), (16, 240, 132),
                           (512, 10, 264)):
        T = pcg_force.tau_block_rows(n_sys, L, N, grid)
        assert 1 <= T <= L
        rows = [l0 + i for l0, nr in pcg_force.tau_blocks(L, T) for i in range(nr)]
        assert rows == list(range(L))
        smem = pcg_force.smem_bytes(N, T)
        if N <= 288:
            assert smem <= pcg_force.SMEM_BUDGET
            if T < L and n_sys * -(-L // T) > grid:  # more than a round: T at the budget's limit
                assert pcg_force.smem_bytes(N, T + 1) > pcg_force.SMEM_BUDGET
            elif T > 1:  # the fewest rows that make one round
                assert n_sys * -(-L // (T - 1)) > grid
        else:
            assert T == 1 and smem <= 227 * 1024
    # the headline at W = 8: 16 systems of (240, 288), 264 CTAs: 16 blocks of
    # 15 rows a system, 256 blocks
    assert pcg_force.tau_block_rows(16, 240, 288, 264) == 15
    assert pcg_force.smem_bytes(288, 15) == 80 * 288 * 4


PAIR_MODELS = [pytest.param("honeycomb", dict(L=3, beta=0.9, alpha=0.4), None, id="honeycomb-Ltau-9"),
               pytest.param("honeycomb", dict(L=3, beta=1.0, alpha=0.4), None, id="honeycomb-Ltau-10"),
               pytest.param("honeycomb", dict(L=3, beta=1.0, alpha=0.4), 15, id="honeycomb-permuted"),
               pytest.param("chain", dict(L=6, beta=0.8, alpha=0.4), None, id="chain")]


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("tau_tabs", [False, True], ids=["tables-1", "tables-Ltau"])
@pytest.mark.parametrize("T", [pytest.param(1, id="T-1"), pytest.param(3, id="T-3"), pytest.param(None, id="T-Ltau")])
@pytest.mark.parametrize("name,kw,perm", PAIR_MODELS)
def test_mtm_pairs_plain_matches_mul_MtM(name, kw, perm, T, tau_tabs, symmetric):
    """K1's algebra (ops/mtm.py:mtm_blocked_plain with pairs: the padded pair
    tables, in-place pair updates, expV on a color stage, tau blocks of T
    rows) against M^T M in f64: 1e-12, both factorizations, tau-independent
    and tau-dependent tables, a permuted lattice and a chain."""
    import dataclasses

    _, pfdm, *_ = fdm_pair(name, kw, x_seed=30, symmetric=symmetric, perm_seed=perm)
    if tau_tabs:
        pfdm = dataclasses.replace(pfdm, static_hops=False)
    L = pfdm.Ltau
    v = t64(np.random.default_rng(31).standard_normal((2, L, pfdm.n_sites)))
    got, n_apply = mtm.mtm_blocked_plain(pfdm, v, L if T is None else T, pairs=True)
    ref = pfdm.mul_Mt(pfdm.mul_M(v))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    assert n_apply == sum(2 * nr + 1 for _, nr in pcg_force.tau_blocks(L, L if T is None else T))


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("T", [pytest.param(2, id="T-2"), pytest.param(None, id="T-Ltau")])
def test_mtm_pairs_plain_matches_pallas_interpret(T, symmetric):
    """The same pair algebra against `_mtm_kernel_roll` in interpret mode,
    which computes in f32: 2e-6 (tests/test_pallas.py:65), both
    factorizations."""
    jfdm, pfdm, *_ = fdm_pair("honeycomb", dict(L=3, beta=0.9, alpha=0.4), x_seed=32, symmetric=symmetric)
    fused = build_fused_mtm(jfdm, interpret=True)
    assert fused is not None and fused.mode == "roll"
    L = pfdm.Ltau
    v = np.random.default_rng(33).standard_normal((2, L, pfdm.n_sites)).astype(np.float32)
    ref = np.asarray(fused(jnp.asarray(v)), dtype=np.float64)
    got, _ = mtm.mtm_blocked_plain(pfdm, t64(v), L if T is None else T, pairs=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("name,kw,perm", PAIR_MODELS)
def test_mtm_pair_index_covers_each_site_once(name, kw, perm):
    """Each color's pairs, padding aside, hold every site exactly once (so a
    stage's in-place updates never race); the table has K * threads slots a
    color with padding pairs (N, N), and each pair carries one (cosh, sinh):
    the two sites of a bond have the same C and S."""
    _, pfdm, *_ = fdm_pair(name, kw, x_seed=34, perm_seed=perm)
    N = pfdm.n_sites
    for es in (4, 8):
        ab, gather = mtm.pair_index(pfdm.structure, "cpu", es)
        abl = ab.to(torch.int64) & 0xFFFFFFFF
        a, b = (abl & 0xFFFF).numpy(), (abl >> 16).numpy()
        threads, K, _ = mtm.block_form(ab.shape[1], ab.shape[0], False)
        assert ab.shape[1] == K * threads
        for c in range(ab.shape[0]):
            real = a[c] < N
            assert np.array_equal(a[c][~real], np.full((~real).sum(), N)) and np.all(b[c][~real] == N)
            sites = np.concatenate([a[c][real], b[c][real][b[c][real] != a[c][real]]])
            assert np.array_equal(np.sort(sites), np.arange(N))
            p = pfdm.structure.partner[c]
            assert np.array_equal(p[a[c][real]], b[c][real])
        C, S, _, _ = mtm.mtm_tables(pfdm)
        for T_ in (C, S):
            assert torch.equal(T_[:, :, torch.as_tensor(a).clamp(max=N - 1)] * torch.as_tensor(a < N),
                               T_[:, :, torch.as_tensor(b).clamp(max=N - 1)] * torch.as_tensor(a < N))


def test_mtm_pair_index_refuses_a_non_matching():
    """A partner map that is not an involution is not a checkerboard color:
    the pair table refuses it."""
    with pytest.raises(ValueError, match="not a matching"):
        mtm.color_pairs(np.array([[1, 2, 0]]))


@pytest.mark.parametrize("N,nc,tau_tabs,form", [(18, 3, False, (32, 1, 1)), (288, 3, False, (160, 1, 1)),
                                                (1152, 3, False, (512, 2, 2)), (3042, 3, False, (512, 3, 3)),
                                                (4608, 3, False, (512, 5, 5)), (4608, 3, True, (512, 5, 0)),
                                                (288, 4, False, (160, 1, 0)), (6144, 3, False, (512, 6, 0))])
def test_mtm_block_form(N, nc, tau_tabs, form):
    """Threads, pairs a thread and form of K1's launch for N sites (N / 2
    pairs a color): the register form for tau-independent tables, up to 3
    colors and 5 pairs a thread; the memory form otherwise."""
    assert mtm.block_form(N // 2, nc, tau_tabs) == form


@pytest.mark.parametrize("es", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("N", [18, 288, 4608])
def test_mtm_tau_block_rows_cover_and_fit(N, es):
    """K1's choice of T: each system's blocks cover its tau rows once, in
    order; the fewest rows whose blocks make one round of the resident CTAs,
    else the most that fit a CTA (227 KB), f64 at N = 4608 included; the
    shared memory is 2T + 2 rows of a 16-byte aligned stride past the spare
    site."""
    ld = mtm.row_ld(N, es)
    assert ld > N and (ld * es) % 16 == 0 and ld - N <= 16 // es
    assert mtm.smem_bytes(N, 3, es) == 8 * ld * es
    for n_sys, L, per_sm in ((2, 240, 1), (2, 240, 2), (2, 240, 9), (1, 9, 1), (3, 10, 4), (16, 240, 1)):
        def resident(T):  # per_sm CTAs an SM of 132 while they fit its 228 KB
            return 132 * max(1, min(per_sm, 228 * 1024 // mtm.smem_bytes(N, T, es)))
        T = mtm.tau_block_rows(n_sys, L, N, es, resident)
        assert 1 <= T <= L and mtm.smem_bytes(N, T, es) <= mtm.SMEM_MAX
        rows = [l0 + i for l0, nr in pcg_force.tau_blocks(L, T) for i in range(nr)]
        assert rows == list(range(L))
        if n_sys * -(-L // T) <= resident(T):
            assert T == 1 or n_sys * -(-L // (T - 1)) > resident(T - 1)  # the fewest that make a round
        else:
            assert T == L or mtm.smem_bytes(N, T + 1, es) > mtm.SMEM_MAX  # the most that fit
    # the L=48 path: one CTA an SM (the register form's registers) on 132 SMs
    if N == 4608:
        one = lambda T: 132  # noqa: E731
        assert mtm.tau_block_rows(2, 240, N, es, one) == (4 if es == 4 else 2)
        assert mtm.smem_bytes(N, 2, 8) <= 227 * 1024 < mtm.smem_bytes(N, 3, 8)
