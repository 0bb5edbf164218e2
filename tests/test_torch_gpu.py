"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so on the GPU machine it runs without the
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: K1 f32 2e-6 and f64 1e-12 relative (max-norm); K2 and K3
solutions rtol 2e-4 / atol 2e-5, both converged (tests/test_pallas.py:65,
:96); K3's iteration counts within one of the plain version's (same bf16
preconditioner, f32 sums in another order); the force planes of K3 and K4
rtol 1e-4 with atol 1e-5 of their largest value (the same f32 operations,
contracted into FMAs in another order); K6 and K8 symmetric 2e-4, K7 and
K8 asymmetric 5e-4 relative to max|y| (f32 Chebyshev recurrences with the
affine map folded into the tables, tests/test_kpm_matrix_free.py:137,192);
the measurement pass on the card against the CPU from the same estimator to
1e-5 (f32: cuFFT against pocketfft, f32 sums in another order) and 1e-10
(f64) of each output's largest magnitude; a resumed run's bins bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import force, kpm_mf, mtm, pcg, pcg_force
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda, ldiv_lambda_T
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

pytestmark = pytest.mark.gpu

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _fdm(device, symmetric=True, L=3, beta=1.0, alpha=0.4):
    geo, tbm, em = holstein_honeycomb_model(L, 1.0, alpha, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("symmetric", SYM)
def test_mtm_kernel_matches_plain(cuda_device, dtype, tol, symmetric):
    fdm = _fdm(cuda_device, symmetric).astype(dtype)
    gen = torch.Generator().manual_seed(1)
    v = torch.randn((3, fdm.Ltau, fdm.n_sites), dtype=dtype, generator=gen).to(cuda_device)
    launches = mtm.MTM[dtype].launches
    got = fdm.mul_MtM(v)
    assert mtm.MTM[dtype].launches == launches + 1
    ref = mtm.mtm_plain(fdm, v)
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol


DTYPES = [pytest.param(torch.float32, 2e-6, id="f32"), pytest.param(torch.float64, 1e-12, id="f64")]


def _mtm_close(got, ref, tol):
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("T", [2, None], ids=["T-2", "T-Ltau"])
def test_mtm_kernel_tau_dependent_tables(cuda_device, dtype, tol, symmetric, T):
    """Full (n_colors, Ltau, N) C/S tables, the layout of tau-dependent
    hoppings (the memory form, which reads a row's (cosh, sinh) in each row),
    at Ltau 9: a ragged last tau block (T = 2) and one block of all rows."""
    fdm = dataclasses.replace(_fdm(cuda_device, symmetric, beta=0.9), static_hops=False).astype(dtype)
    C, S, _, _ = mtm.mtm_tables(fdm)
    assert C.shape[1] == fdm.Ltau == 9
    assert mtm.launch_shape(fdm, 2)["form"] == 0
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(4)).to(cuda_device)
    got = mtm.mtm_cuda(fdm, v, tau_rows=fdm.Ltau if T is None else T)
    _mtm_close(got, mtm.mtm_plain(fdm, v), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("T", [1, 2, 3, None], ids=["T-1", "T-2", "T-3", "T-Ltau"])
@pytest.mark.parametrize("beta", [0.9, 1.0], ids=["Ltau-9", "Ltau-10"])
@pytest.mark.parametrize("L", [3, 12], ids=["N-18", "N-288"])
def test_mtm_kernel_tau_blocks(cuda_device, L, beta, T, symmetric, dtype, tol):
    """K1 with its tau blocks forced to 1, 2, 3 and Ltau rows (3 leaves a
    ragged last block at Ltau 9 and 10; Ltau wraps the whole system into one
    block, tau 0 at both ends of its m rows) against its plain version."""
    fdm = _fdm(cuda_device, symmetric, L=L, beta=beta).astype(dtype)
    T = fdm.Ltau if T is None else T
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(21)).to(cuda_device)
    _mtm_close(mtm.mtm_cuda(fdm, v, tau_rows=T), mtm.mtm_plain(fdm, v), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("L", [39, 48], ids=["N-3042", "N-4608"])
def test_mtm_kernel_large_n(cuda_device, L, symmetric, dtype, tol):
    """Large N: 3042 sites (1521 pairs a color: a ragged last slot of 512
    threads, K = 3) and the L=48 path's 4608 (K = 5), with the chosen T and
    with T = 1, in the register form and the memory form."""
    fdm = _fdm(cuda_device, symmetric, L=L, alpha=1.5).astype(dtype)
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(22)).to(cuda_device)
    ref = mtm.mtm_plain(fdm, v)
    shape = mtm.launch_shape(fdm, 2)
    assert shape["form"] == shape["K"] and shape["smem"] <= 227 * 1024
    for kw in ({}, {"tau_rows": 1}, {"memory_form": True}):
        _mtm_close(mtm.mtm_cuda(fdm, v, **kw), ref, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("form", ["registers", "memory"])
def test_mtm_kernel_permuted_lattice(cuda_device, dtype, tol, symmetric, form):
    """K5's function: the headline honeycomb's site labels permuted (an
    irregular partner map), N = 288, Ltau = 10."""
    geo, tbm, em = holstein_honeycomb_model(12, 1.0, 0.6, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=cuda_device)
    elph = ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, device=cuda_device)
    perm = np.random.default_rng(15).permutation(tbp.n_sites)
    nt = perm[np.asarray(tbp.neighbor_table)].astype(np.int32)
    structure = build_checkerboard_structure(nt, tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure,
                                              symmetric=symmetric).astype(dtype)
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(23)).to(cuda_device)
    got = mtm.mtm_cuda(fdm, v, memory_form=form == "memory")
    _mtm_close(got, mtm.mtm_plain(fdm, v), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_sys", [1, 3], ids=["1-system", "3-systems"])
def test_mtm_kernel_batches(cuda_device, n_sys, dtype, tol):
    """A batch of one system and of three, with a leading axis to flatten."""
    fdm = _fdm(cuda_device, L=12).astype(dtype)
    v = torch.randn((n_sys, 1, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(24)).to(cuda_device)
    got = mtm.mtm_cuda(fdm, v)
    assert got.shape == v.shape
    _mtm_close(got, mtm.mtm_plain(fdm, v), tol)


@pytest.mark.parametrize("symmetric", SYM)
def test_mtm_kernel_bit_identical_and_timed(cuda_device, symmetric):
    """Two launches give the same bits, and so does the timed instantiation
    (its stamps add barriers, not arithmetic); it stamps the staging, 2
    n_colors (symmetric) or n_colors color stages for B and for B^T, m and
    the output, on CTA 0 and on the last CTA to finish."""
    fdm = _fdm(cuda_device, symmetric, L=12).astype(torch.float32)
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(25)).to(cuda_device)
    one, two = mtm.mtm_cuda(fdm, v), mtm.mtm_cuda(fdm, v)
    stamps = torch.zeros(mtm.stamp_slots(), dtype=torch.int64, device=cuda_device)
    timed = mtm.mtm_cuda(fdm, v, stamps=stamps)
    assert torch.equal(one, two) and torch.equal(one, timed)
    names = mtm.phase_names_for(fdm, 2)
    assert len(names) == 3 + 2 * (2 if symmetric else 1) * fdm.cb.n_colors
    us = mtm.phase_times(stamps, names)
    assert us["kernel"] > 0 and all(us[w]["us"] > 0 for w in ("cta0", "last"))
    assert set(us["cta0"]["groups"]) == {"stage", "B", "m", "Bt", "out"}


@pytest.mark.parametrize("N", [18, 288, 3042, 4608])
def test_mtm_smem_matches_host_mirror(cuda_device, N):
    """The kernel's row stride and shared memory for a block size are what the
    host's choice of T assumes (ops/mtm.py:row_ld, smem_bytes)."""
    lib = mtm._build.load_library()
    for es in (4, 8):
        assert lib.smoqy_mtm_row_ld(N, int(es == 8)) == mtm.row_ld(N, es)
        for T in (1, 2, 3, 4, 10):
            assert lib.smoqy_mtm_smem_bytes(N, T, int(es == 8)) == mtm.smem_bytes(N, T, es)


def test_mtm_kernel_rejects_mixed_dtypes(cuda_device):
    fdm = _fdm(cuda_device)
    v = torch.zeros((2, fdm.Ltau, fdm.n_sites), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        fdm.mul_MtM(v)


@pytest.mark.parametrize("warm,beta,n_sys", [(False, 1.0, 2), (True, 1.0, 2), (False, 0.9, 5)],
                         ids=["cold", "warm", "odd-Ltau-5-systems"])
def test_pcg_kernel_matches_plain(cuda_device, warm, beta, n_sys):
    """Cold and warm solves, and an odd Ltau (full spectrum, Lh = Ltau) with
    five systems."""
    fdm = _fdm(cuda_device, beta=beta)
    pre = build_spectral(fdm)
    b = torch.randn((n_sys, fdm.Ltau, fdm.n_sites), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(3)).to(cuda_device)
    x0 = None
    if warm:
        x0, _ = pcg.SpectralPCG(fdm, pre)(b, tol=1e-3, maxiter=200)
    launches = pcg.PCG.launches
    xk, sk = pcg.SpectralPCG(fdm, pre)(b, x0=x0, tol=1e-5, maxiter=200)
    assert pcg.PCG.launches == launches + 1
    fdm32 = fdm.astype(torch.float32)
    nb = torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)
    rhs = b if x0 is None else b - mtm.mtm_plain(fdm32, x0)
    xp, ep, _ = pcg.pcg_plain(fdm32, pre, (rhs / nb).contiguous(), 1e-5, 200)
    xp = xp * nb if x0 is None else x0 + xp * nb
    assert bool(sk.converged) and bool((ep < 1e-5).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)


def _unit_rhs(fdm, n_sys, seed):
    b = torch.randn((n_sys, fdm.Ltau, fdm.n_sites), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(seed)).to(fdm.device)
    return (b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)).contiguous()


@pytest.mark.parametrize("L,beta,n_sys", [(2, 1.0, 2), (3, 1.0, 1), (3, 0.9, 16), (4, 1.0, 16), (4, 0.9, 1)],
                         ids=["N-8", "N-18-B-1", "N-18-odd-Ltau-B-16", "N-32-B-16", "N-32-odd-Ltau-B-1"])
def test_pcg_kernel_shapes(cuda_device, L, beta, n_sys):
    """Small and ragged shapes: N of 8, 18 (products masked at the ragged
    edge, operands staged element by element) and 32 (16-byte staging), odd
    Ltau (Lh = Ltau), one and sixteen systems; K2 against its plain version."""
    fdm = _fdm(cuda_device, L=L, beta=beta)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    b = _unit_rhs(fdm, n_sys, 7)
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 200)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, b, 1e-5, 200)
    assert bool((ek < 1e-5).all()) and bool((ep < 1e-5).all()) and bool(torch.isfinite(xk).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)


def test_pcg_kernel_bit_identical(cuda_device):
    """Two launches on the same input give the same bits: every dot is summed
    in a fixed order."""
    fdm = _fdm(cuda_device, L=4)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    b = _unit_rhs(fdm, 3, 8)
    x1, e1, i1 = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 200)
    x2, e2, i2 = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 200)
    assert torch.equal(x1, x2) and torch.equal(e1, e2) and int(i1) == int(i2)


def test_pcg_kernel_converged_system_beside_active(cuda_device):
    """A zero right-hand side stops before its first iteration (x = 0, eps =
    0) while the system beside it iterates to convergence."""
    fdm = _fdm(cuda_device)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    b = _unit_rhs(fdm, 2, 9)
    b[0] = 0.0
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 200)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, b, 1e-5, 200)
    assert float(ek[0]) == 0.0 and bool((xk[0] == 0).all()) and int(ik) > 0
    assert bool((ek < 1e-5).all()) and bool((ep < 1e-5).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)


def test_pcg_kernel_cut_by_maxiter(cuda_device):
    """A solve cut by maxiter with its systems still active returns the
    iterate of that many iterations, as the plain version does."""
    fdm = _fdm(cuda_device, L=4)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    b = _unit_rhs(fdm, 2, 10)
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, b, 1e-9, 3)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, b, 1e-9, 3)
    assert int(ik) == int(ip) == 3 and bool((ek > 1e-9).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(ek, ep.to(ek.device), rtol=2e-3, atol=0.0)


def test_run_updates_on_gpu_launches_kernels(cuda_device):
    """A short GPU sweep loop goes through both kernels and no plain version."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG)
    for c in counters:
        c.reset()
    md = run_updates(tbm, em, SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2), 2, device=cuda_device)
    assert md["all_converged"] and all(np.isfinite(md["hmc_delta_H"]))
    for c in counters:
        assert c.launches > 0 and c.plain_calls == 0, c.name


def _walker_problem(device, W, beta, seed=5):
    """W jittered walker fields on honeycomb L=3: the f32 walker-batch fermion
    matrix, Lambda (W, Ltau, N), right-hand sides (W, 2, Ltau, N) and a
    spectral preconditioner."""
    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.4, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    gen = torch.Generator().manual_seed(seed)
    xs = elph.x[None] + 0.1 * torch.randn((W,) + tuple(elph.x.shape), generator=gen, dtype=torch.float64).to(device)
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph, xs), structure)
    pre = build_spectral(dataclasses.replace(fdm, exp_nV=fdm.exp_nV[0]))
    fdm32 = dataclasses.replace(fdm, exp_nV=fdm.exp_nV[:, None]).astype(torch.float32)
    Lam = build_lambda(elph, xs, tbp.n_sites).to(torch.float32)
    Phi = torch.randn((W, 2, elph.Ltau, tbp.n_sites), generator=gen, dtype=torch.float32).to(device)
    return fdm32, pre, Lam, ldiv_lambda_T(Lam[:, None], Phi).contiguous()


def _close_planes(got, ref):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("beta", [1.0, 0.9], ids=["Ltau-10", "Ltau-9"])
@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_pcg_force_kernel_matches_plain(cuda_device, W, beta, warm):
    """K3 on W walkers against its plain version on the same tensors:
    solutions, per-walker iteration counts, eps and the force planes."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, W, beta)
    x0 = torch.zeros_like(b)
    if warm:
        x0, *_ = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-3, 200, True)
    launches = pcg_force.PCG_FORCE.launches
    xk, P1k, P2k, sk = pcg_force.solve_force(fdm32, pre, b, Lam, x0=x0, tol=1e-5, maxiter=200)
    assert pcg_force.PCG_FORCE.launches == launches + 1
    xp, P1p, P2p, ep, ip = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    assert sk.converged.shape == (W,) and bool(sk.converged.all()) and bool((ep < 1e-5).all())
    assert int((sk.iters.cpu() - ip.cpu()).abs().max()) <= 1
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)
    _close_planes(P1k, P1p)
    _close_planes(P2k, P2p)


def _check_k3(got, ref, tol=1e-5):
    """K3's outputs (x, P1, P2, eps, iters) against the plain version's."""
    xk, P1k, P2k, ek, ik = got
    xp, P1p, P2p, ep, ip = ref
    assert bool((ek < tol).all()) and bool((ep < tol).all()) and bool(torch.isfinite(xk).all())
    assert int((ik.cpu() - ip.cpu()).abs().max()) <= 1
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)
    _close_planes(P1k, P1p)
    _close_planes(P2k, P2p)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("T", [1, 3, None], ids=["T-1", "T-3", "T-Ltau"])
@pytest.mark.parametrize("beta", [1.0, 0.9], ids=["Ltau-10", "Ltau-9"])
def test_pcg_force_kernel_tau_blocks(cuda_device, beta, T, warm):
    """K3 with its tau blocks forced to 1, 3 and Ltau rows (3 leaves a ragged
    last block at Ltau 9 and 10; Ltau wraps the whole system into one block)
    at N = 18, W = 2, against its plain version."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 2, beta)
    x0 = torch.zeros_like(b)
    if warm:
        x0, *_ = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-3, 200, True)
    T = fdm32.Ltau if T is None else T
    got = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True, tau_rows=T)
    _check_k3(got, pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-5, 200, True))


def _first_converged(fdm32, pre, b, x0, Lam, tol=1e-5):
    """The plain version's iteration at which each channel system first has
    eps < tol (cut by maxiter = k for k = 0, 1, ...)."""
    first = [None] * (2 * b.shape[0])
    for k in range(200):
        eps = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, tol, k, False)[3]
        for s in range(len(first)):
            if first[s] is None and float(eps[s]) < tol:
                first[s] = k
        if all(f is not None for f in first):
            return first
    raise AssertionError("the plain solve did not converge")


def test_pcg_force_kernel_channels_stop_apart(cuda_device):
    """One walker whose channel 1 starts from a tol-1e-3 solution and channel
    0 from zero: the channels stop at different iterations (the walker's count
    is the later one), and the stopped channel keeps its x while the other
    iterates."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 1, 1.0)
    x0 = torch.zeros_like(b)
    x0[:, 1] = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-3, 200, True)[0][:, 1]
    first = _first_converged(fdm32, pre, b, x0, Lam)
    assert first[0] != first[1]
    got = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    ref = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    assert int(ref[4][0]) == max(first)
    _check_k3(got, ref)


def test_pcg_force_kernel_zero_rhs_beside_active(cuda_device):
    """A zero right-hand side (x0 = 0) stops before the first iteration with x
    = 0 and eps = 0, while the other channel of its walker and the other
    walker iterate to convergence."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 2, 1.0)
    b[0, 0] = 0.0
    x0 = torch.zeros_like(b)
    got = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    assert float(got[3][0]) == 0.0 and bool((got[0][0, 0] == 0).all()) and int(got[4][0]) > 0
    _check_k3(got, pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-5, 200, True))


def test_pcg_force_kernel_cut_by_maxiter(cuda_device):
    """A solve cut at maxiter = 3 with every system still active returns the
    iterate of three iterations, as the plain version does, and the force
    planes of that iterate. An iterate short of convergence carries the
    rounding of the bf16 preconditioner's input, which later iterations
    correct: the kernel rounds r - alpha Ap once (fmaf), the plain version
    twice, and on this problem that alone moves the plain version's own
    three-iteration iterate by 1.3e-5 of max|x| (1e-4 allowed here), where
    converged solutions agree to 3.6e-6 absolute. The residual norms after
    three iterations differ by up to 1.25% (2% allowed), the same with K3's
    earlier one-row design on this problem."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 3, 1.0)
    x0 = torch.zeros_like(b)
    xk, P1k, P2k, ek, ik = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-9, 3, True)
    xp, P1p, P2p, ep, ip = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-9, 3, True)
    assert ik.tolist() == ip.tolist() == [3, 3, 3] and bool((ek > 1e-9).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=1e-4 * float(xp.abs().max()))
    torch.testing.assert_close(ek, ep, rtol=2e-2, atol=0.0)
    P1r, P2r = force.planes(fdm32, Lam, xk, True)
    _close_planes(P1k, P1r)
    _close_planes(P2k, P2r)


def test_pcg_force_kernel_bit_identical_and_timed(cuda_device):
    """Two launches give the same bits, and so does the timed instantiation
    (its stamps add barriers, not arithmetic); its phase names count five
    grid syncs a loop iteration."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 3, 0.9)
    x0 = torch.zeros_like(b)
    one = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    two = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    stamps = torch.zeros(pcg_force.stamp_slots(200), dtype=torch.int64, device=cuda_device)
    timed = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True, stamps=stamps)
    for u, v, w in zip(one, two, timed):
        assert torch.equal(u, v) and torch.equal(u, w)
    us = pcg_force.phase_times(stamps, int(one[4].max()))
    assert sum(k.startswith("sync") for k in us if k != "once") == 5
    assert us["iteration"] > 0 and set(us["once"]) >= {"b2", "warm_mtm", "loop", "epilogue"}


@pytest.mark.parametrize("N_L", [3, 12], ids=["N-18", "N-288"])
def test_pcg_force_smem_matches_host_mirror(cuda_device, N_L):
    """The kernel's shared memory for a block size is what the host's choice
    of T assumes (ops/pcg_force.py:smem_bytes)."""
    lib = pcg_force._build.load_library()
    N = 2 * N_L * N_L
    for T in (1, 3, 15, 16):
        assert lib.smoqy_pcg_force_smem_bytes(N, T) == pcg_force.smem_bytes(N, T)


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
def test_force_kernel_matches_plain(cuda_device, want_p2):
    """K4 on a walker batch and on one pair against its plain version."""
    fdm32, pre, Lam, b = _walker_problem(cuda_device, 2, 1.0)
    psi = torch.randn(b.shape, generator=torch.Generator().manual_seed(9), dtype=torch.float32).to(cuda_device)
    launches = force.FORCE.launches
    P1k, P2k = force.force_planes(fdm32, Lam, psi, want_p2)
    assert force.FORCE.launches == launches + 1
    P1p, P2p = force.force_planes_plain(fdm32, Lam, psi, want_p2)
    _close_planes(P1k, P1p)
    if want_p2:
        _close_planes(P2k, P2p)
    else:
        assert not P2k.any()
    one = dataclasses.replace(fdm32, exp_nV=fdm32.exp_nV[0, 0])
    P1k, _ = force.force_planes(one, Lam[0], psi[0], want_p2)
    _close_planes(P1k, force.force_planes_plain(one, Lam[0], psi[0], want_p2)[0])


def _k4_problem(device, W, beta):
    """K4's operands: the walker batch of `_walker_problem` with psi_raw
    from a seed; at W = 1 one channel pair (exp_nV (Ltau, N)), as the
    W = 1 trajectory passes it."""
    fdm32, _, Lam, b = _walker_problem(device, max(W, 2), beta)
    psi = torch.randn(b.shape, generator=torch.Generator().manual_seed(9), dtype=torch.float32).to(device)
    if W == 1:
        return dataclasses.replace(fdm32, exp_nV=fdm32.exp_nV[0, 0]), Lam[0], psi[0]
    return fdm32, Lam, psi


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
@pytest.mark.parametrize("T", [None, 1, 2, 3, 10], ids=["T-path", "T-1", "T-2", "T-3", "T-Ltau"])
@pytest.mark.parametrize("beta", [1.0, 0.9], ids=["Ltau-10", "Ltau-9"])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_force_kernel_tau_blocks(cuda_device, W, beta, T, want_p2):
    """K4 with its tau blocks forced to 1, 2, 3 and Ltau rows (ragged where T
    does not divide Ltau; odd Ltau) and with the path's T, one and more
    walkers, against its plain version; two launches give the same bits."""
    fdm32, Lam, psi = _k4_problem(cuda_device, W, beta)
    T = None if T is None else min(T, fdm32.Ltau)
    launches = force.FORCE.launches
    got = force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T)
    again = force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T)
    torch.cuda.synchronize()
    assert force.FORCE.launches == launches + 2
    ref = force.force_planes_plain(fdm32, Lam, psi, want_p2)
    _close_planes(got[0], ref[0])
    if want_p2:
        _close_planes(got[1], ref[1])
    else:
        assert not got[1].any()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    shape = force.launch_shape(fdm32, W, tau_rows=T)
    assert shape["grid"] == W * -(-fdm32.Ltau // shape["tau_block"]) and shape["form"] > 0


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
def test_force_kernel_memory_form(cuda_device, want_p2):
    """Tau-dependent hopping tables take K4's memory form (K = 0)."""
    fdm32, Lam, psi = _k4_problem(cuda_device, 2, 1.0)
    fdm32 = dataclasses.replace(fdm32, static_hops=False)
    assert force.launch_shape(fdm32, 2)["form"] == 0
    got = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
    ref = force.force_planes_plain(fdm32, Lam, psi, want_p2)
    for g, r in zip(got, ref):
        _close_planes(g, r)


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
def test_force_kernel_timed(cuda_device, want_p2):
    """The timed instantiation gives the same bits and stamps every phase
    (ops/force.py:phase_names) on CTA 0 and on the last CTA."""
    fdm32, Lam, psi = _k4_problem(cuda_device, 8, 1.0)
    one = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
    stamps = torch.zeros(force.stamp_slots(), dtype=torch.int64, device=cuda_device)
    timed = force.force_planes_cuda(fdm32, Lam, psi, want_p2, stamps=stamps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, timed))
    names = force.phase_names(fdm32.cb.n_colors, want_p2)
    us = force.phase_times(stamps, names)
    assert us["kernel"] > 0 and list(us["cta0"]["phases"]) == names
    assert all(v >= 0 for v in us["cta0"]["phases"].values()) and us["last"]["us"] > 0


def test_force_smem_matches_host_mirror(cuda_device):
    """The library's row stride and shared memory (both forms) are what
    ops/force.py's choice of T assumes."""
    lib = force._build.load_library()
    for N in (18, 288, 4608):
        assert lib.smoqy_force_row_ld(N) == mtm.row_ld(N, 8)
        for T in (1, 2, 7):
            for staged in (True, False):
                assert lib.smoqy_force_smem_bytes(N, T, int(staged)) == force.smem_bytes(N, T, staged)


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
@pytest.mark.parametrize("L", [40, 48, 60], ids=["N-3200", "N-4608", "N-7200"])
def test_force_kernel_large_n(cuda_device, L, want_p2):
    """Honeycomb lattices of 3200 sites (x and Lambda staged in shared
    memory), 4608 and 7200 (read from device memory: the staged rows do not
    fit beside the block's) against the plain version."""
    fdm32 = _fdm(cuda_device, True, L=L, beta=0.5).astype(torch.float32)
    geo, tbm, em = holstein_honeycomb_model(L, 1.0, 0.4, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=cuda_device)
    elph = ElectronPhononParameters.from_model(0.5, 0.1, em, tbp, rng, device=cuda_device)
    Lam = build_lambda(elph, elph.x, tbp.n_sites).to(torch.float32)
    psi = torch.randn((2, fdm32.Ltau, fdm32.n_sites), generator=torch.Generator().manual_seed(10),
                      dtype=torch.float32).to(cuda_device)
    assert force.launch_shape(fdm32, 1)["staged"] == (fdm32.n_sites <= 3300)
    got = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
    ref = force.force_planes_plain(fdm32, Lam, psi, want_p2)
    for g, r in zip(got, ref):
        _close_planes(g, r)


def _ssh_k4_problem(device, L=12, beta=4.0):
    """K4's SSH operands at the optical-SSH cell's shape (honeycomb L=12,
    beta 4, dtau 0.05: (2, 80, 288), hop tables on every tau row), f32, one
    chain (a trajectory launches K4 a walker at a time); the field jittered
    from the initial one, psi_raw from a seed."""
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm

    geo, tbm, em = ossh_honeycomb_model(L, 1.0, 0.5, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.05, em, tbp, rng, device=device)
    ctx, state = initialize_qmc(tbp, elph, force_dtype="float32", use_preconditioner=False)
    gen = torch.Generator().manual_seed(11)
    x = state.x + 0.3 * torch.randn(state.x.shape, generator=gen, dtype=torch.float64).to(device)
    fdm32 = make_fdm(ctx, x, dtype="float32")
    Lam = build_lambda(ctx.elph, x, ctx.n_sites).to(torch.float32)
    psi = torch.randn(x.shape[:-2] + (2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=torch.float32).to(device)
    return fdm32, Lam, psi


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
@pytest.mark.parametrize("T", [None, 1, 3], ids=["T-path", "T-1", "T-3"])
def test_force_kernel_ssh_form(cuda_device, T, want_p2):
    """K4's SSH form at (2, 80, 288) with hop tables on every tau row against
    its plain version: P1, P2 and the hop plane H; one launch a call, the
    memory form, two launches the same bits."""
    W = 1
    fdm32, Lam, psi = _ssh_k4_problem(cuda_device)
    launches = force.FORCE.launches
    got = force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T, hops=True)
    again = force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T, hops=True)
    torch.cuda.synchronize()
    assert force.FORCE.launches == launches + 2
    ref = force.force_planes_plain(fdm32, Lam, psi, want_p2, hops=True)
    assert got[2].shape == ref[2].shape == psi.shape[:-3] + (80, 3, force.launch_shape(fdm32, W, T, True)["P"])
    for g, r in zip(got, ref):
        _close_planes(g, r)
    if not want_p2:
        assert not got[1].any()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert force.launch_shape(fdm32, W, T, hops=True)["form"] == 0


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
def test_force_kernel_holstein_form_unchanged(cuda_device, want_p2):
    """The Holstein instantiation's planes against the plain model of its
    tau blocks (`force_blocked_plain` at the launch's T), and the SSH form
    on the same Holstein operands (forced to the memory form) giving the
    memory-form Holstein planes bit for bit, both walks' stages ridden by
    the products."""
    fdm32, Lam, psi = _k4_problem(cuda_device, 8, 1.0)
    T = force.launch_shape(fdm32, 8)["tau_block"]
    P1, P2 = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
    P1b, P2b, _ = force.force_blocked_plain(fdm32.to("cpu"), Lam.cpu(), psi.cpu(), want_p2, T)
    _close_planes(P1.cpu(), P1b)
    _close_planes(P2.cpu(), P2b)
    mem = dataclasses.replace(fdm32, static_hops=False)
    hol = force.force_planes_cuda(mem, Lam, psi, want_p2)
    ssh = force.force_planes_cuda(mem, Lam, psi, want_p2, hops=True)
    torch.cuda.synchronize()
    assert torch.equal(hol[0], ssh[0]) and torch.equal(hol[1], ssh[1])
    _close_planes(ssh[2], force.force_planes_plain(mem, Lam, psi, want_p2, hops=True)[2])


@pytest.mark.parametrize("want_p2", [True, False], ids=["p2", "no-p2"])
def test_force_kernel_ssh_form_timed(cuda_device, want_p2):
    """The SSH form's timed instantiation gives the same bits and stamps every
    phase (ops/force.py:phase_names with hops)."""
    fdm32, Lam, psi = _ssh_k4_problem(cuda_device)
    one = force.force_planes_cuda(fdm32, Lam, psi, want_p2, hops=True)
    stamps = torch.zeros(force.stamp_slots(), dtype=torch.int64, device=cuda_device)
    timed = force.force_planes_cuda(fdm32, Lam, psi, want_p2, stamps=stamps, hops=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, timed))
    names = force.phase_names(fdm32.cb.n_colors, want_p2, hops=True)
    us = force.phase_times(stamps, names)
    assert us["kernel"] > 0 and list(us["cta0"]["phases"]) == names


def test_run_updates_walkers_launch_k3(cuda_device):
    """A short W = 2 run goes through K3 (and K1, K2), never a plain version."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE)
    for c in counters:
        c.reset()
    md = run_updates(tbm, em, SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2, n_walkers=2), 2,
                     device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert md["x_final"].shape == (2, 18, 20)
    assert pcg_force.PCG_FORCE.launches == 2 * 8 and force.FORCE.launches == 0
    assert md["force_routes"] == {"k3": 2 * 2 * 8, "k4": 0, "plain": 0}
    for c in counters:
        assert c.plain_calls == 0, c.name


@pytest.mark.parametrize("n_walkers", [1, 2])
def test_run_updates_default_route_launches_k4(cuda_device, n_walkers):
    """The default route on the card (decided by the input): at W = 1, and at
    W = 2 without the shared refresh (each walker's trajectory on its own),
    every trajectory force is the K2 solve and one K4 launch, a walker a
    kick; no K3, no plain chain, no plain version of a kernel."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE)
    for c in counters:
        c.reset()
    cfg = SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2, n_walkers=n_walkers, shared_precond=False)
    md = run_updates(tbm, em, cfg, 2, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    kicks = 2 * n_walkers * 8
    assert force.FORCE.launches == kicks and pcg_force.PCG_FORCE.launches == 0 and pcg.PCG.launches > kicks
    assert md["force_routes"] == {"k3": 0, "k4": kicks, "plain": 0}
    for c in counters:
        assert c.plain_calls == 0, c.name


@pytest.mark.parametrize("case", ["complex-ssh", "complex", "f64-forces", "asymmetric"])
def test_run_updates_default_route_off_k4(cuda_device, case):
    """The default route on the card keeps the eager chain where K4's planes
    are not the force: complex SSH constants, complex hoppings, f64 forces and
    the asymmetric factorization launch no K4 (and no K3 at W = 1)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    from test_torch_force_route import MODELS as ROUTE_MODELS

    model = {"complex-ssh": ROUTE_MODELS["complex-ssh"], "complex": lambda: complex_chain_model(8)}
    geo, tbm, em = model.get(case, lambda: holstein_honeycomb_model(3, 1.0, 0.6, 0.0))()
    kw = {"f64-forces": {"force_dtype": "float64"}, "asymmetric": {"symmetric": False}}.get(case, {})
    force.FORCE.reset()
    pcg_force.PCG_FORCE.reset()
    md = run_updates(tbm, em, SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2, **kw), 2, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert force.FORCE.launches == 0 and pcg_force.PCG_FORCE.launches == 0
    assert force.FORCE.plain_calls == 0 and md["force_routes"] == {"k3": 0, "k4": 0, "plain": 2 * 8}


@pytest.mark.parametrize("n_walkers", [1, 2])
def test_run_updates_ssh_route_launches_k4(cuda_device, n_walkers):
    """The optical-SSH honeycomb on the card: every trajectory force is the
    K2 solve and one launch of K4's SSH form, a walker a kick, at W = 1 and
    walker by walker in a shared W = 2 trajectory (no K3); no plain chain,
    no plain version of a kernel; a second run from the same seed ends on
    the same field bit for bit (the force's sum onto the phonons has a fixed
    order, which a resumed run relies on)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model

    geo, tbm, em = ossh_honeycomb_model(3, 1.0, 0.5, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE)
    for c in counters:
        c.reset()
    cfg = SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2, n_walkers=n_walkers)
    md = run_updates(tbm, em, cfg, 2, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    kicks = 2 * n_walkers * 8
    assert force.FORCE.launches == kicks and pcg_force.PCG_FORCE.launches == 0
    assert md["force_routes"] == {"k3": 0, "k4": kicks, "plain": 0}
    for c in counters:
        assert c.plain_calls == 0, c.name
    again = run_updates(tbm, em, cfg, 2, device=cuda_device)
    assert torch.equal(torch.as_tensor(md["x_final"]), torch.as_tensor(again["x_final"]))


@pytest.fixture
def forced_k4(monkeypatch):
    """run_updates with HMCParams.fused_force=True: the trajectory forces
    through K2 + K4 wherever the planes apply, whatever the input's route."""
    from smoqyelphqmc_tpu_torch import driver

    make = driver._hmc_params
    monkeypatch.setattr(driver, "_hmc_params", lambda cfg: dataclasses.replace(make(cfg), fused_force=True))


def test_run_updates_fused_force_launches_k4(cuda_device, forced_k4):
    """fused_force=True at W = 1: every trajectory force through K2 + K4."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    force.FORCE.reset()
    pcg_force.PCG_FORCE.reset()
    md = run_updates(tbm, em, SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2), 2, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert force.FORCE.launches == 2 * 8 and force.FORCE.plain_calls == 0 and pcg_force.PCG_FORCE.launches == 0


def _real_fdm(device, symmetric, model, L, beta=1.0, perm_seed=None):
    """A real-hopping fermion matrix: the Holstein honeycomb (N = 2 L^2) or
    the periodic chain (N = L, any L), optionally with the hopping graph's
    site labels permuted (partners anywhere on the lattice)."""
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    if model == "honeycomb":
        geo, tbm, em = holstein_honeycomb_model(L, 1.0, 0.4, 0.0)
    else:
        geo, tbm, em = complex_chain_model(L, phase=0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    assert tbp.t0_im is None
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    nt = np.asarray(tbp.neighbor_table)
    if perm_seed is not None:
        nt = np.random.default_rng(perm_seed).permutation(tbp.n_sites)[nt].astype(np.int32)
    structure = build_checkerboard_structure(nt, tbp.n_sites)
    return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)


def _mf_operands(fdm, seed=6):
    gen = torch.Generator().manual_seed(seed)
    pre = KPMPreconditioner.build(fdm, torch.randn(fdm.n_sites, generator=gen, dtype=torch.float64), matrix_free=True)
    assert pre.active and pre.orders.max() > 1
    return pre.mf_operands()


def _check_kpm_mf(ops, device, n_vectors=2, seed=6, **launch):
    """K6 / K7 on `n_vectors` complex vectors of (Ltau, N) frequency planes
    against the plain version: one launch counted, 2e-4 (K6) or 5e-4 (K7) of
    max|y|."""
    F, N = ops.coefs_re.shape[0], ops.n_sites
    gen = torch.Generator().manual_seed(seed)
    ure, uim = torch.randn((2, n_vectors, F, N), generator=gen, dtype=torch.float32).to(device)
    counter = kpm_mf.KPM_MF if ops.symmetric else kpm_mf.KPM_MF_ASYM
    launches = counter.launches
    got = kpm_mf.kpm_mf_cuda(ops, ure, uim, **launch) if launch else kpm_mf.kpm_mf_apply(ops, ure, uim)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    ref = (kpm_mf.kpm_mf_plain if ops.symmetric else kpm_mf.kpm_mf_asym_plain)(ops, ure, uim)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= (2e-4 if ops.symmetric else 5e-4) * scale


@pytest.mark.parametrize("L", [3, 24, 48], ids=["N-18", "N-1152", "N-4608"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_matches_plain(cuda_device, symmetric, L):
    """K6 / K7 against their plain versions on a matrix-free preconditioner's
    operands, two complex vectors of (Ltau, N) frequency planes."""
    _check_kpm_mf(_mf_operands(_fdm(cuda_device, symmetric, L=L)), cuda_device)


@pytest.mark.parametrize("n_vectors", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["constants", "all-cluster", "no-cluster"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_forms_and_vectors(cuda_device, symmetric, form, n_vectors):
    """Both forms alone and the constants' mix, with 1 to 4 vectors (row
    groups of 2 and 4): the order threshold forced to 0 sends every frequency
    through the cluster form, a huge one sends none."""
    ops = _mf_operands(_real_fdm(cuda_device, symmetric, "honeycomb", 24))
    launch = {"constants": {}, "all-cluster": dict(order_threshold=0), "no-cluster": dict(order_threshold=10**6)}[form]
    F = ops.coefs_re.shape[0]
    if launch:
        want = F if form == "all-cluster" else 0
        assert kpm_mf.cluster_plan(ops, n_vectors, **launch)["n_cluster"] == want
    _check_kpm_mf(ops, cuda_device, n_vectors=n_vectors, **launch)


def _cluster_form_fits(ops, n_vectors, k):
    """The cluster form's limits (csrc/kpm_mf.cu): 2048 sites a CTA, and in
    227 KB of shared memory the mbarriers, 2 n_stages slot buffers of G rows,
    the coefficients and 16 bytes of tables per site and color."""
    n_tables, C_pad = ops.stage_A.shape[0], ops.coefs_re.shape[1]
    n_buf = 2 * (2 * n_tables - 1 if ops.symmetric else n_tables)
    G = 4 if n_vectors % 2 == 0 else 2
    slice_ = -(-ops.n_sites // k)
    smem = 16 * ((n_buf * -(-slice_ // 32) + 1) // 2) + n_buf * slice_ * G * 4 + 2 * C_pad * 4 + n_tables * slice_ * 16
    return slice_ <= 2048 and smem <= 227 * 1024


@pytest.mark.parametrize("cluster_size", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N", [3000, 8190])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_ragged_slices(cuda_device, symmetric, N, cluster_size):
    """Chains of N = 3000 and 8190 sites: N is no multiple of the cluster
    size or of 32, so the last CTA's slice and the last warp are partly
    filled; every frequency in the cluster form where the shape fits it (1 or
    2 sites a thread), else all in the one-CTA form, by shape alone."""
    ops = _mf_operands(_real_fdm(cuda_device, symmetric, "chain", N))
    plan = kpm_mf.cluster_plan(ops, 2, order_threshold=0, cluster_size=cluster_size)
    fits = _cluster_form_fits(ops, 2, cluster_size)
    assert plan["n_cluster"] == (ops.coefs_re.shape[0] if fits else 0)
    assert plan["sites_per_thread"] == ((1 if -(-N // cluster_size) <= 1024 else 2) if fits else 0)
    _check_kpm_mf(ops, cuda_device, order_threshold=0, cluster_size=cluster_size)


@pytest.mark.parametrize("form", ["constants", "all-cluster", "no-cluster"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_permuted_lattice(cuda_device, symmetric, form):
    """The honeycomb L = 24 with its site labels permuted: partners in every
    other CTA's slice, read through distributed shared memory."""
    ops = _mf_operands(_real_fdm(cuda_device, symmetric, "honeycomb", 24, perm_seed=11))
    owner = kpm_mf.unpack_partner16(ops.stage_P) // (ops.n_sites // 8)
    assert len(torch.unique(owner[:, : ops.n_sites // 8])) == 8
    launch = {"constants": {}, "all-cluster": dict(order_threshold=0, cluster_size=8),
              "no-cluster": dict(order_threshold=10**6)}[form]
    _check_kpm_mf(ops, cuda_device, **launch)


@pytest.mark.parametrize("form", ["all-cluster", "no-cluster"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_orders_all_one(cuda_device, symmetric, form):
    """Operands whose live orders are all 1: y = c_0 u (K7: |c_0|^2 u), no
    order step and no barrier in either form."""
    ops = _mf_operands(_real_fdm(cuda_device, symmetric, "honeycomb", 24))
    ones = np.ones_like(ops.orders_host)
    ops = dataclasses.replace(ops, orders=torch.ones_like(ops.orders), orders_host=ones, launch_plans={})
    _check_kpm_mf(ops, cuda_device, order_threshold=0 if form == "all-cluster" else 10**6)


def test_kpm_mf_kernel_largest_tiles(cuda_device):
    """Honeycomb L = 66 (N = 8712): K6 in the cluster form (slices of 1089
    sites, 2 a thread), and in its one-CTA form's 16-site register tiles, which take
    8192 < N <= 16384, against the plain version; K7's limit is 8192 sites,
    so it refuses this N with the size."""
    gen = torch.Generator().manual_seed(7)
    v0 = torch.randn(2 * 66 * 66, generator=gen, dtype=torch.float64)
    fdm = _fdm(cuda_device, True, L=66, beta=0.5)
    pre = KPMPreconditioner.build(fdm, v0, matrix_free=True)
    assert fdm.n_sites == 8712 and pre.active and pre.orders.max() > 1
    ops = pre.mf_operands()
    assert kpm_mf.cluster_plan(ops, 1)["sites_per_thread"] == 2
    _check_kpm_mf(ops, cuda_device, n_vectors=1)
    _check_kpm_mf(ops, cuda_device, n_vectors=1, order_threshold=0)
    _check_kpm_mf(ops, cuda_device, n_vectors=1, order_threshold=10**6)
    asym = KPMPreconditioner.build(_fdm(cuda_device, False, L=66, beta=0.5), v0, matrix_free=True)
    u = torch.zeros((1, fdm.Ltau, fdm.n_sites), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="N = 8712 sites exceeds the kernel's 8192"):
        kpm_mf.kpm_mf_apply(asym.mf_operands(), u, u)


@pytest.mark.parametrize("symmetric", SYM)
def test_run_updates_kpm_launches_k6_k7(cuda_device, symmetric):
    """preconditioner='kpm' at N = 1152 (matrix-free): every CG iteration
    applies K1 and K6 (symmetric) or K7 (asymmetric), never a plain version."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(24, 1.0, 0.6, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM)
    for c in counters:
        c.reset()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=2, symmetric=symmetric, preconditioner="kpm")
    md = run_updates(tbm, em, cfg, 1, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all() and md["kpm_active"]
    kpm = kpm_mf.KPM_MF if symmetric else kpm_mf.KPM_MF_ASYM
    assert kpm.launches > 0 and mtm.MTM[torch.float32].launches > 0 and mtm.MTM[torch.float64].launches > 0
    for c in counters:
        assert c.plain_calls == 0, c.name


def _cplx_fdm(device, symmetric=True, L=8, beta=1.0, phase=0.7, perm_seed=None):
    """The complex chain t e^{i phase} (an O(1) imaginary part), optionally
    with its site labels permuted (partners anywhere on the ring)."""
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    geo, tbm, em = complex_chain_model(L, phase=phase)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    nt = np.asarray(tbp.neighbor_table)
    if perm_seed is not None:
        nt = np.random.default_rng(perm_seed).permutation(tbp.n_sites)[nt].astype(np.int32)
    structure = build_checkerboard_structure(nt, tbp.n_sites)
    return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)


def _cplx_operands(fdm, seed=8):
    gen = torch.Generator().manual_seed(seed)
    pre = KPMPreconditioner.build(fdm, torch.randn(2 * fdm.n_sites, generator=gen, dtype=torch.float64),
                                  matrix_free=True)
    assert pre.complex_pair and pre.active and pre.orders.max() > 1
    return pre.mf_operands()


def _check_k8(ops, device, n_vectors=2, seed=8, **launch):
    """K8 on `n_vectors` channel pairs of (Ltau, N) frequency planes against
    kpm_mf_cplx_plain: one launch counted, 2e-4 (symmetric) or 5e-4
    (asymmetric) of max|y|."""
    F, N = ops.coefs_re.shape[0], ops.n_sites
    gen = torch.Generator().manual_seed(seed)
    ure, uim = torch.randn((2, n_vectors, F, N), generator=gen, dtype=torch.float32).to(device)
    launches = kpm_mf.KPM_MF_CPLX.launches
    got = kpm_mf.kpm_mf_cplx_cuda(ops, ure, uim, **launch) if launch else kpm_mf.kpm_mf_apply(ops, ure, uim)
    torch.cuda.synchronize()
    assert kpm_mf.KPM_MF_CPLX.launches == launches + 1
    ref = kpm_mf.kpm_mf_cplx_plain(ops, ure, uim)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= (2e-4 if ops.symmetric else 5e-4) * scale
    return got


K8_FORMS = {"constants": {}, "all-cluster": dict(order_threshold=0), "no-cluster": dict(order_threshold=10**6)}


@pytest.mark.parametrize("n_vectors", [1, 2])
@pytest.mark.parametrize("form", list(K8_FORMS))
@pytest.mark.parametrize("L", [8, 1152, 3000, 8190], ids=["N-8", "N-1152", "N-3000", "N-8190"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_matches_plain(cuda_device, symmetric, L, form, n_vectors):
    """K8 against kpm_mf_cplx_plain on a complex chain's matrix-free
    preconditioner, one and two channel pairs (row groups of 2 and 4), in the
    cluster form, the one-CTA form (4 and 16 sites a thread) and the
    constants' mix; the cluster form covers every frequency where the shape
    fits it (by shape alone)."""
    ops = _cplx_operands(_cplx_fdm(cuda_device, symmetric, L=L))
    launch = K8_FORMS[form]
    if launch:
        plan = kpm_mf.cluster_plan(ops, n_vectors, **launch)
        fits = plan["sites_per_thread"] > 0
        assert plan["n_cluster"] == (ops.coefs_re.shape[0] if form == "all-cluster" and fits else 0)
        assert plan["stages"] == (3 if symmetric else 2)  # the chain's 2 colors
    _check_k8(ops, cuda_device, n_vectors=n_vectors, **launch)


@pytest.mark.parametrize("cluster_size", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N", [3000, 8190])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_ragged_slices(cuda_device, symmetric, N, cluster_size):
    """K8 on chains of 3000 and 8190 sites: no multiple of the cluster size
    or of 32, so the last CTA's slice and the last warp are partly filled;
    every frequency in the cluster form where the shape fits it, else all in
    the one-CTA form. The fit counts Bi's 4 bytes a site and table."""
    ops = _cplx_operands(_cplx_fdm(cuda_device, symmetric, L=N))
    plan = kpm_mf.cluster_plan(ops, 2, order_threshold=0, cluster_size=cluster_size)
    n_tables, C_pad = ops.stage_A.shape[0], ops.coefs_re.shape[1]
    n_buf = 2 * (2 * n_tables - 1 if symmetric else n_tables)
    slice_ = -(-N // cluster_size)
    smem = 16 * ((n_buf * -(-slice_ // 32) + 1) // 2) + n_buf * slice_ * 4 * 4 + 2 * C_pad * 4 + n_tables * slice_ * 20
    fits = slice_ <= 2048 and smem <= 227 * 1024
    assert plan["n_cluster"] == (ops.coefs_re.shape[0] if fits else 0)
    assert plan["sites_per_thread"] == ((1 if slice_ <= 1024 else 2) if fits else 0)
    _check_k8(ops, cuda_device, order_threshold=0, cluster_size=cluster_size)


@pytest.mark.parametrize("form", ["all-cluster", "no-cluster"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_permuted_chain(cuda_device, symmetric, form):
    """The complex chain of 1152 sites with its site labels permuted:
    partners in every other CTA's slice, and each pair's S_im signs on
    relabelled sides."""
    ops = _cplx_operands(_cplx_fdm(cuda_device, symmetric, L=1152, perm_seed=11))
    owner = kpm_mf.unpack_partner16(ops.stage_P) // (ops.n_sites // 4)
    assert len(torch.unique(owner[:, : ops.n_sites // 4])) == 4
    launch = {"all-cluster": dict(order_threshold=0, cluster_size=4), "no-cluster": dict(order_threshold=10**6)}
    _check_k8(ops, cuda_device, **launch[form])


@pytest.mark.parametrize("form", ["all-cluster", "no-cluster"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_orders_all_one(cuda_device, symmetric, form):
    """Live orders all 1: y = c_0 u (asymmetric: |c_0|^2 u), no stage at all."""
    ops = _cplx_operands(_cplx_fdm(cuda_device, symmetric, L=1152))
    ops = dataclasses.replace(ops, orders=torch.ones_like(ops.orders), orders_host=np.ones_like(ops.orders_host),
                              launch_plans={})
    _check_k8(ops, cuda_device, order_threshold=0 if form == "all-cluster" else 10**6)


@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_bit_identical(cuda_device, symmetric):
    """Two launches on the same operands give the same bits (no atomics, no
    order that changes from run to run)."""
    ops = _cplx_operands(_cplx_fdm(cuda_device, symmetric, L=1152))
    one, two = _check_k8(ops, cuda_device), _check_k8(ops, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_kpm_mf_cplx_kernel_refuses_large_n(cuda_device):
    """K8 takes at most 8192 sites (the one-CTA form's 16-site register
    tiles of one vector) and says so."""
    fdm = _cplx_fdm(cuda_device, True, L=8200, beta=0.2)
    gen = torch.Generator().manual_seed(9)
    pre = KPMPreconditioner.build(fdm, torch.randn(2 * fdm.n_sites, generator=gen, dtype=torch.float64),
                                  matrix_free=True)
    u = torch.zeros((fdm.Ltau, fdm.n_sites), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="N = 8200 sites exceeds the kernel's 8192"):
        kpm_mf.kpm_mf_apply(pre.mf_operands(), u, u)


@pytest.mark.parametrize("symmetric", SYM)
def test_run_updates_complex_kpm_launches_k8(cuda_device, symmetric):
    """The complex chain at N = 1152 with preconditioner='kpm': K8 is the only
    kernel launched; the complex M^dag M is plain PyTorch by design, and no
    real-hopping kernel or plain version runs."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model
    from smoqyelphqmc_tpu_torch.ops.fermion_det import CPLX_MTM

    geo, tbm, em = complex_chain_model(1152)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE,
                kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM, kpm_mf.KPM_MF_CPLX)
    for c in counters:
        c.reset()
    for c in CPLX_MTM.values():
        c.reset()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=2, symmetric=symmetric, preconditioner="kpm")
    md = run_updates(tbm, em, cfg, 1, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all() and md["kpm_active"]
    assert kpm_mf.KPM_MF_CPLX.launches > 0 and all(c.plain_calls > 0 for c in CPLX_MTM.values())
    for c in counters:
        assert c.plain_calls == 0, c.name
        assert c.launches == 0 or c is kpm_mf.KPM_MF_CPLX, c.name


# ----------------------------------------------------------------------
# the measured path: K2 at the estimator's shape, measurements, run_simulation
# ----------------------------------------------------------------------


def _estimator_rhs(fdm32, Nrv, seed):
    """The refresh's unit-norm systems: M^T R of random-phase vectors R
    (Nrv, 2, Ltau, N) as 2 Nrv systems."""
    gen = torch.Generator().manual_seed(seed)
    theta = 2.0 * np.pi * torch.rand((Nrv, fdm32.Ltau, fdm32.n_sites), generator=gen, dtype=torch.float64)
    R = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1).to(fdm32.device, torch.float32)
    b = fdm32.mul_Mt(R).reshape(2 * Nrv, fdm32.Ltau, fdm32.n_sites)
    return (b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)).contiguous()


@pytest.mark.parametrize("L,beta", [(3, 1.0), (12, 1.0), (4, 0.9)], ids=["N-18", "N-288", "N-32-odd-Ltau"])
def test_pcg_kernel_estimator_systems(cuda_device, L, beta):
    """K2 on the 2 Nrv = 20 systems of one estimator refresh at its tolerance
    2e-5, against its plain version."""
    fdm = _fdm(cuda_device, L=L, beta=beta)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    b = _estimator_rhs(fdm32, 10, 11)
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, b, 2e-5, 10_000)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, b, 2e-5, 10_000)
    assert bool((ek < 2e-5).all()) and bool((ep < 2e-5).all()) and bool(torch.isfinite(xk).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5 * float(xp.abs().max()))


def _estimator_pair(device, dtype):
    """A refreshed estimator on a small honeycomb (CPU, plain versions) and
    its copy on `device`, with the context on both."""
    from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator, update_greens_estimator
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.5, 0.0)
    out = []
    for dev in ("cpu", device):
        rng = np.random.default_rng(0)
        tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
        elph = ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, device=dev)
        out.append(initialize_qmc(tbp, elph))
    (cctx, cstate), (gctx, gstate) = out
    est = build_greens_estimator(cctx.Ltau, 2, geo.L, Nrv=4, dtype=dtype, device="cpu")
    theta = 2.0 * np.pi * torch.rand((4, cctx.Ltau, cctx.n_sites), generator=torch.Generator().manual_seed(4),
                                     dtype=torch.float64)
    est = update_greens_estimator(est, make_fdm(cctx, cstate.x), theta, precond=cstate.precond, mixed=True,
                                  solve_dtype="float32" if dtype == "float32" else None).estimator
    gest = dataclasses.replace(est, R=est.R.to(device), GR=est.GR.to(device))
    return geo, (cctx, cstate, est), (gctx, gstate, gest)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)], ids=["f32", "f64"])
def test_make_measurements_on_gpu_matches_cpu(cuda_device, dtype, tol):
    """The measurement pass of the tutorial set plus bond and current
    correlations on the card (cuFFT) against the CPU (pocketfft) from the
    same R and GR: every leaf's dtype, and its values to `tol` of its largest
    magnitude."""
    from smoqyelphqmc_tpu_torch.measure.container import make_measurements
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_spec

    geo, (cctx, cstate, cest), (gctx, gstate, gest) = _estimator_pair(cuda_device, dtype)
    spec = holstein_honeycomb_spec(geo)
    spec.add_correlation("bond", [(2, 2)], integrated=True)
    spec.add_correlation("current", [(2, 2)], integrated=True)
    cout = make_measurements(cctx, spec, cest, cstate.x)
    gout = make_measurements(gctx, spec, gest, gstate.x)
    for cat in cout:
        for name, (cr, ci) in cout[cat].items():
            gr, gi = gout[cat][name]
            assert gr.device.type == "cuda" and gr.dtype == cr.dtype, (cat, name)
            ref = torch.complex(cr.double(), ci.double())
            got = torch.complex(gr.double(), gi.double()).cpu()
            if torch.isnan(ref.real).all():
                assert bool(torch.isnan(got.real).all()), name
                continue
            assert float((got - ref).abs().max()) <= tol * max(float(ref.abs().max()), 1e-300), (cat, name)


def test_simulate_on_gpu(cuda_device, tmp_path):
    """run_simulation's loop (`simulate`, the bins in memory: the GPU machine
    has no h5py) on the card: K1 and K2 launch, no plain version runs, every
    bin value is finite (the DQMC-only globals NaN), and a run interrupted
    after its first sweep resumes to the uninterrupted run's bins bit for
    bit."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, simulate
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_spec

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    spec = holstein_honeycomb_spec(geo)
    cfg = SimulationConfig(beta=1.0, dtau=0.1, N_therm=2, N_measurements=4, N_bins=2, Nt=8, Nrv=10, seed=2)

    def run(prefix, c):
        out = simulate(SimulationInfo(filepath=str(tmp_path), datafolder_prefix=prefix, sID=1), tbm, em, spec, c,
                       device=cuda_device)
        leaves = {}
        while True:
            try:
                k, tree = next(out)
            except StopIteration as done:
                return leaves, *done.value
            for cat, d in tree.items():
                for name, (re, im) in d.items():
                    leaves[(k, cat, name)] = np.asarray(re) + 1j * np.asarray(im)

    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG)
    for c in counters:
        c.reset()
    ref, md, finished = run("gpu", cfg)
    for c in counters:
        assert c.launches > 0 and c.plain_calls == 0, c.name
    assert finished and md["all_converged"] and {k[0] for k in ref} == {0, 1}
    for (_, cat, name), v in ref.items():
        if name in ("sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"):
            assert np.all(np.isnan(v.real))
        else:
            assert np.all(np.isfinite(v)), (cat, name)
    stop = dataclasses.replace(cfg, runtime_limit_hours=0.0, checkpoint_freq_hours=0.0)
    got, _, finished = run("resumed", stop)
    assert not finished and not got
    more, _, finished = run("resumed", cfg)
    got.update(more)
    assert finished and set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


# ----------------------------------------------------------------------
# the measured walker path and the sampler options on the card
# ----------------------------------------------------------------------


def _mu_walker_problem(device, mus, beta=1.0, seed=5):
    """_walker_problem with a chemical potential a walker: the walkers'
    fermion matrix from the context at mus (W,)."""
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm, with_mu

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.4, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    ctx, state = initialize_qmc(tbp, elph, preconditioner="spectral")
    W = len(mus)
    gen = torch.Generator().manual_seed(seed)
    xs = elph.x[None] + 0.1 * torch.randn((W,) + tuple(elph.x.shape), generator=gen, dtype=torch.float64).to(device)
    fdm32 = make_fdm(with_mu(ctx, torch.tensor(mus, dtype=torch.float64)), xs, dtype="float32")
    Lam = build_lambda(elph, xs, tbp.n_sites).to(torch.float32)
    Phi = torch.randn((W, 2, elph.Ltau, tbp.n_sites), generator=gen, dtype=torch.float32).to(device)
    return fdm32, state.precond, Lam, ldiv_lambda_T(Lam[:, None], Phi).contiguous()


def test_pcg_force_kernel_per_walker_mu(cuda_device):
    """K3 with each walker's own mu in its exp_nV plane (mu = (0, 0.1))
    against its plain version; walker 1's solution is not the mu = 0 one."""
    fdm32, pre, Lam, b = _mu_walker_problem(cuda_device, [0.0, 0.1])
    assert fdm32.exp_nV.shape[0] == 2 and not torch.equal(fdm32.exp_nV[0], fdm32.exp_nV[1])
    x0 = torch.zeros_like(b)
    launches = pcg_force.PCG_FORCE.launches
    got = pcg_force.pcg_force_cuda(fdm32, pre, b, x0, Lam, 1e-5, 200, True)
    assert pcg_force.PCG_FORCE.launches == launches + 1
    _check_k3(got, pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, 1e-5, 200, True))
    fdm_zero = _mu_walker_problem(cuda_device, [0.0, 0.0])[0]
    zero = pcg_force.pcg_force_plain(fdm_zero, pre, b, x0, Lam, 1e-5, 200, True)[0]
    torch.testing.assert_close(got[0][0], zero[0], rtol=2e-4, atol=2e-5)
    assert float((got[0][1] - zero[1]).abs().max()) > 1e-3 * float(zero[1].abs().max())


def _omelyan_batch(device, Nt):
    """One W = 2 Omelyan trajectory batch through K3 (mu = (0, 0.1), the
    shared preconditioner) on `device`, its draws from a seeded CPU
    generator."""
    from smoqyelphqmc_tpu_torch.updates.context import QMCState, initialize_qmc, with_mu
    from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, draw_hmc, hmc_update

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(2.0, 0.1, em, tbp, rng, device=device)
    ctx, state = initialize_qmc(tbp, elph, mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    gen = torch.Generator().manual_seed(11)
    xs = elph.x[None] + 0.1 * torch.randn((2,) + tuple(elph.x.shape), generator=gen, dtype=torch.float64).to(device)
    draws = [draw_hmc(gen, ctx) for _ in range(2)]
    params = HMCParams(Nt=Nt, integrator="omelyan", refresh_precond_at_start=False, fused_step_force=True)
    return hmc_update(with_mu(ctx, torch.tensor([0.0, 0.1], dtype=torch.float64)),
                      QMCState(x=xs, precond=state.precond), params, draws)


def test_omelyan_through_k3_matches_plain(cuda_device):
    """A W = 2 Omelyan batch (both kicks of each step through K3, 2 Nt
    launches, no plain version) against the same batch on the CPU (K3's
    plain version): the same accept flags, fields to 1e-4 relative (the GPU
    chains' bound) and iterations per solve within one."""
    Nt = 4
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE)
    for c in counters:
        c.reset()
    gst, gstats = _omelyan_batch(cuda_device, Nt)
    assert pcg_force.PCG_FORCE.launches == 2 * Nt and all(c.plain_calls == 0 for c in counters)
    cst, cstats = _omelyan_batch(torch.device("cpu"), Nt)
    for g, c in zip(gstats, cstats):
        assert g.converged and c.converged and g.accepted == c.accepted
        assert abs(g.iters_avg - c.iters_avg) <= 1.0
    xg, xc = gst.x.cpu(), cst.x
    assert float((xg - xc).abs().max()) <= 1e-4 * float(xc.abs().max())


def _walker_options_config(**kw):
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig

    opts = dict(beta=1.0, dtau=0.1, N_therm=2, N_measurements=4, N_bins=2, Nt=4, Nrv=10, seed=2, n_walkers=2,
                use_radial_updates=True, hmc_integrator="omelyan", target_acceptance=0.7, target_density=0.9)
    return SimulationConfig(**{**opts, **kw})


def test_simulate_walkers_with_options_on_gpu_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """simulate at W = 2 with radial updates, Omelyan, dt targeting and mu
    tuning on the card and on the CPU: every sweep's accept flags equal, the
    bins to 1e-4 of each observable's largest magnitude, K1 f64, K2 and K3
    launch with no plain version on the card; then the card's run interrupted after
    every sweep until its first bins are out resumes to its bins bit for
    bit."""
    from smoqyelphqmc_tpu_torch import driver
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_spec

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    spec = holstein_honeycomb_spec(geo)
    flags = []
    orig = driver.walker_sweep

    def spy(*args, **kw):
        states, st = orig(*args, **kw)
        flags.append(tuple(tuple(bool(u.accepted) for u in ups) for ups in st))
        return states, st

    monkeypatch.setattr(driver, "walker_sweep", spy)

    def run(prefix, cfg, device):
        out = driver.simulate(SimulationInfo(filepath=str(tmp_path), datafolder_prefix=prefix, sID=1), tbm, em, spec,
                              cfg, device=device)
        leaves = {}
        while True:
            try:
                p, k, tree = next(out)
            except StopIteration as done:
                return leaves, *done.value
            for cat, d in tree.items():
                for name, (re, im) in d.items():
                    leaves[(p, k, cat, name)] = np.asarray(re) + 1j * np.asarray(im)

    cfg = _walker_options_config()
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE)
    for c in counters:
        c.reset()
    gpu, gmd, finished = run("gpu", cfg, cuda_device)
    gflags, flags[:] = list(flags), []
    # K1 f32 launches only in per-walker fallback sweeps (their K2 warm starts)
    for c in counters:
        assert c.plain_calls == 0 and (c.launches > 0 or c is mtm.MTM[torch.float32]), c.name
    cpu, cmd, _ = run("cpu", cfg, "cpu")
    assert finished and gmd["all_converged"] and cmd["all_converged"] and gflags == flags and len(gflags) == 6
    assert set(gpu) == set(cpu) and {k[:2] for k in gpu} == {(p, b) for p in (0, 1) for b in (0, 1)}
    for k, ref in cpu.items():
        if np.all(np.isnan(ref.real)):
            assert np.all(np.isnan(gpu[k].real)), k
            continue
        assert float(np.max(np.abs(gpu[k] - ref))) <= 1e-4 * max(float(np.max(np.abs(ref))), 1e-300), k
    stop = dataclasses.replace(cfg, runtime_limit_hours=0.0)
    got, n_runs = {}, 0
    while not got and n_runs < cfg.N_therm + cfg.N_measurements:
        more, _, finished = run("resumed", stop, cuda_device)
        got.update(more)
        n_runs += 1
    more, md, finished = run("resumed", cfg, cuda_device)
    got.update(more)
    assert finished and n_runs > 1 and set(got) == set(gpu)
    for k, v in gpu.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    assert md["final_mu_per_walker"] == gmd["final_mu_per_walker"] and md["hmc_dt_final"] == gmd["hmc_dt_final"]


# ----------------------------------------------------------------------
# SSH couplings: hopping tables whose tau rows differ (K1's memory form, K2
# at tau_stride N), and the gate that keeps K3 / K4 off SSH models
# ----------------------------------------------------------------------


def _ssh_fdm(device, symmetric=True, L=3, beta=1.0):
    """The optical-SSH honeycomb's fermion matrix (f64) at its initial field
    (nonzero: the tau rows of its hopping tables differ)."""
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model

    geo, tbm, em = ossh_honeycomb_model(L, 1.0, 0.5, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)
    assert not fdm.static_hops and float((fdm.cb.C - fdm.cb.C[:, :1]).abs().max()) > 0
    return fdm


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("T", [1, 2, 3, None], ids=["T-1", "T-2", "T-3", "T-path"])
@pytest.mark.parametrize("L,beta", [(3, 0.9), (12, 1.0)], ids=["N-18-Ltau-9", "N-288-Ltau-10"])
def test_mtm_kernel_ssh_tables(cuda_device, L, beta, T, symmetric, dtype, tol):
    """K1's memory form on SSH tables whose tau rows differ: a stage must read
    row l's (cosh, sinh) for B_l and row l+1's for B_{l+1}^T, at the edges of
    ragged tau blocks too."""
    fdm = _ssh_fdm(cuda_device, symmetric, L=L, beta=beta).astype(dtype)
    assert mtm.launch_shape(fdm, 2)["form"] == 0
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=dtype,
                    generator=torch.Generator().manual_seed(31)).to(cuda_device)
    _mtm_close(mtm.mtm_cuda(fdm, v, tau_rows=T), mtm.mtm_plain(fdm, v), tol)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("symmetric", SYM)
@pytest.mark.parametrize("L,beta", [(3, 0.9), (12, 1.0)], ids=["N-18-Ltau-9", "N-288-Ltau-10"])
def test_pcg_kernel_ssh_tables(cuda_device, L, beta, symmetric, warm):
    """K2 on SSH tables whose tau rows differ, cold and warm, both
    factorizations, against its plain version."""
    fdm = _ssh_fdm(cuda_device, symmetric, L=L, beta=beta)
    pre = build_spectral(fdm)
    b = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(32)).to(cuda_device)
    x0 = pcg.SpectralPCG(fdm, pre)(b, tol=1e-3, maxiter=400)[0] if warm else None
    launches = pcg.PCG.launches
    xk, sk = pcg.SpectralPCG(fdm, pre)(b, x0=x0, tol=1e-5, maxiter=400)
    assert pcg.PCG.launches == launches + 1
    fdm32 = fdm.astype(torch.float32)
    nb = torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)
    rhs = b if x0 is None else b - mtm.mtm_plain(fdm32, x0)
    xp, ep, _ = pcg.pcg_plain(fdm32, pre, (rhs / nb).contiguous(), 1e-5, 400)
    xp = xp * nb if x0 is None else x0 + xp * nb
    assert bool(sk.converged) and bool((ep < 1e-5).all())
    torch.testing.assert_close(xk, xp, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_walkers", [1, 2])
def test_ssh_chain_gpu_matches_cpu(cuda_device, n_walkers):
    """The optical-SSH chain's sweeps on the card (K1, K2 and K4's SSH form,
    once a kick a walker; no K3) and on the CPU (the plain chain): the same
    accept decisions, the fields to 1e-4 relative (f32 force solves at tol
    1e-5 with sums in another order)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import ossh_chain_model

    geo, tbm, em = ossh_chain_model(16, 1.0, 0.5, 0.0)
    cfg = SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=4, n_walkers=n_walkers, use_radial_updates=True)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE)
    for c in counters:
        c.reset()
    gpu = run_updates(tbm, em, cfg, 2, device=cuda_device)
    assert pcg_force.PCG_FORCE.launches == 0 and force.FORCE.launches == 2 * n_walkers * 8
    for c in counters[:3]:
        assert c.launches > 0 and c.plain_calls == 0, c.name
    cpu = run_updates(tbm, em, cfg, 2, device="cpu")
    assert gpu["all_converged"] and cpu["all_converged"]
    for k in ("reflection", "swap", "radial", "hmc"):
        assert gpu[f"{k}_acceptance_rate"] == cpu[f"{k}_acceptance_rate"], k
    xg, xc = gpu["x_final"].cpu(), cpu["x_final"]
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-4


def test_fused_force_ssh_launches_no_k4(cuda_device, forced_k4):
    """fused_force=True on an SSH model: the forces take K2 + K4's SSH form
    (K4 once a kick, the name kept from when K4 had no SSH form), never the
    plain chain or K3; K1 and K2 launch."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model

    geo, tbm, em = ossh_honeycomb_model(3, 1.0, 0.5, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE)
    for c in counters:
        c.reset()
    md = run_updates(tbm, em, SimulationConfig(beta=2.0, dtau=0.1, Nt=8, seed=2), 2, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert force.FORCE.launches == 2 * 8 and pcg_force.PCG_FORCE.launches == 0
    assert md["force_routes"] == {"k3": 0, "k4": 2 * 8, "plain": 0}
    for c in counters[:3]:
        assert c.launches > 0 and c.plain_calls == 0, c.name


# ----------------------------------------------------------------------
# the walker path with KPM and complex hoppings
# ----------------------------------------------------------------------


def _walker_states(device, tbm, em, preconditioner, W=2, symmetric=True, beta=1.0, seed=3):
    """The context and W jittered walkers (0.1 N(0, 1)) of a model, with the
    preconditioner built from a drawn start vector."""
    from smoqyelphqmc_tpu_torch.parallel.walkers import init_walker_states
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc

    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(beta, 0.1, em, tbp, rng, device=device)
    gen = torch.Generator().manual_seed(seed)
    n = tbp.n_sites * (2 if tbp.t0_im is not None else 1)
    ctx, state = initialize_qmc(tbp, elph, symmetric=symmetric, preconditioner=preconditioner,
                                mixed_precision=True, force_dtype="float32",
                                lanczos_v0=torch.randn(n, generator=gen, dtype=torch.float64))
    noise = 0.1 * torch.randn((W,) + tuple(state.x.shape), generator=gen, dtype=torch.float64)
    return ctx, init_walker_states(ctx, state, noise), gen


def _walker_mean_operands(ctx, states, gen):
    """The matrix-free operands of the shared refresh from the walker mean."""
    from smoqyelphqmc_tpu_torch.parallel.walkers import draw_shared, shared_precond_refresh

    pre = shared_precond_refresh(ctx, states, draw_shared(gen, ctx, states.precond[0])).precond[0]
    assert pre.matrix_free and pre.active
    return pre.mf_operands()


@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_kernel_walker_mean_tables(cuda_device, symmetric):
    """K6 / K7 against their plain versions on the stage tables of the shared
    refresh from the walker mean of W = 8 walkers (honeycomb L=48)."""
    geo, tbm, em = holstein_honeycomb_model(48, 1.0, 1.5, 0.0)
    ctx, states, gen = _walker_states(cuda_device, tbm, em, "kpm", W=8, symmetric=symmetric)
    _check_kpm_mf(_walker_mean_operands(ctx, states, gen), cuda_device)


@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_mf_cplx_kernel_walker_mean_tables(cuda_device, symmetric):
    """K8 against its plain version on the stage tables (S_im included) of
    the shared refresh from the walker mean of W = 8 complex-chain walkers
    (N = 1152)."""
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    geo, tbm, em = complex_chain_model(1152)
    ctx, states, gen = _walker_states(cuda_device, tbm, em, "kpm", W=8, symmetric=symmetric)
    ops = _walker_mean_operands(ctx, states, gen)
    assert ops.S_im is not None
    _check_k8(ops, cuda_device)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "perwalker"])
@pytest.mark.parametrize("symmetric", SYM)
def test_run_updates_kpm_walkers_launch_k1_k6_k7(cuda_device, symmetric, shared):
    """preconditioner='kpm' at N = 1152 and W = 2, with the shared refresh
    and per walker: every walker's solves apply K1 and K6 (symmetric) or K7
    (asymmetric); K3 stays off and no plain version runs."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = holstein_honeycomb_model(24, 1.0, 0.6, 0.0)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE,
                kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM)
    for c in counters:
        c.reset()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=2, symmetric=symmetric, preconditioner="kpm",
                           n_walkers=2, shared_precond=shared)
    md = run_updates(tbm, em, cfg, 1, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all()
    assert md["kpm_active"] and md["kpm_inactive_walkers"] == 0
    kpm = kpm_mf.KPM_MF if symmetric else kpm_mf.KPM_MF_ASYM
    assert kpm.launches > 0 and mtm.MTM[torch.float32].launches > 0 and mtm.MTM[torch.float64].launches > 0
    assert pcg_force.PCG_FORCE.launches == 0 and pcg.PCG.launches == 0
    for c in counters:
        assert c.plain_calls == 0, c.name


def test_run_updates_complex_kpm_walkers_launch_k8(cuda_device):
    """The complex chain at N = 1152, W = 2, preconditioner='kpm': K8 is the
    only kernel launched, no plain version of a kernel runs."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    geo, tbm, em = complex_chain_model(1152)
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE,
                kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM, kpm_mf.KPM_MF_CPLX)
    for c in counters:
        c.reset()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=2, preconditioner="kpm", n_walkers=2)
    md = run_updates(tbm, em, cfg, 1, device=cuda_device)
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"]).all() and md["kpm_active"]
    assert kpm_mf.KPM_MF_CPLX.launches > 0
    for c in counters:
        assert c.plain_calls == 0, c.name
        assert c.launches == 0 or c is kpm_mf.KPM_MF_CPLX, c.name


def _gpu_cpu_walkers(device, tbm, em, **kw):
    """run_updates at W = 2 on the card and on the CPU from the same seed:
    the same accept decisions, the fields to 1e-4 relative (f32 force solves
    at tol 1e-5 with sums in another order)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    cfg = SimulationConfig(**dict(dict(beta=1.0, dtau=0.1, Nt=4, seed=4, n_walkers=2), **kw))
    gpu = run_updates(tbm, em, cfg, 2, device=device)
    cpu = run_updates(tbm, em, cfg, 2, device="cpu")
    assert gpu["all_converged"] and cpu["all_converged"]
    for k in ("reflection", "swap", "hmc"):
        assert gpu[f"{k}_acceptance_rate"] == cpu[f"{k}_acceptance_rate"], k
    xg, xc = gpu["x_final"].cpu(), cpu["x_final"]
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-4
    return gpu, cpu


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "perwalker"])
@pytest.mark.parametrize("symmetric", SYM)
def test_kpm_walkers_gpu_matches_cpu(cuda_device, symmetric, shared, monkeypatch):
    """The matrix-free KPM walker path (K1, K6 / K7 on the card, their plain
    versions on the CPU) on the honeycomb L=3 at W = 2."""
    from smoqyelphqmc_tpu_torch.ops import kpm as pkpm

    monkeypatch.setattr(pkpm, "MATRIX_FREE_MIN_SITES", 0)
    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    gpu, _ = _gpu_cpu_walkers(cuda_device, tbm, em, preconditioner="kpm", symmetric=symmetric,
                              shared_precond=shared)
    assert gpu["kpm_active"]


@pytest.mark.parametrize("kind", ["auto", "kpm"])
def test_complex_walkers_gpu_matches_cpu(cuda_device, kind, monkeypatch):
    """The complex chain (N = 8) at W = 2 with the doubled-basis spectral
    preconditioner and with matrix-free KPM (K8 on the card)."""
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model
    from smoqyelphqmc_tpu_torch.ops import kpm as pkpm

    monkeypatch.setattr(pkpm, "MATRIX_FREE_MIN_SITES", 0)
    geo, tbm, em = complex_chain_model(8)
    kpm_mf.KPM_MF_CPLX.reset()
    _gpu_cpu_walkers(cuda_device, tbm, em, preconditioner=kind, beta=2.0)
    assert (kpm_mf.KPM_MF_CPLX.launches > 0) == (kind == "kpm")


def test_complex_ssh_walkers_gpu_matches_cpu(cuda_device):
    """The complex-SSH chain (the SSH constant 0.4 + 0.25i on real hoppings,
    tests/test_complex_hoppings.py:242) at W = 2: each walker's own complex
    hopping tables, the doubled-basis spectral preconditioner."""
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononModel, PhononMode, SSHCoupling
    from smoqyelphqmc_tpu_torch.models.library import chain_geometry
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingModel

    geo, bond = chain_geometry(8)
    tbm = TightBindingModel(geo, [bond], [1.0], [0.0], mu=0.1)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], 1.0))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.4 + 0.25j))
    _gpu_cpu_walkers(cuda_device, tbm, em, beta=0.6)


@pytest.mark.parametrize("model", ["honeycomb", "complex_chain"])
def test_simulate_kpm_walkers_on_gpu(cuda_device, tmp_path, model):
    """The measured walker path with matrix-free KPM at W = 2 (N = 1152):
    each walker's estimator refresh runs the CG path with its KPM
    preconditioner (K1 + K6 on the honeycomb, K8 on the complex chain), never
    K2 (spectral and real) or a plain version; the bins are finite."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, simulate
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.measure.container import MeasurementSpec
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model, holstein_honeycomb_spec

    if model == "honeycomb":
        geo, tbm, em = holstein_honeycomb_model(24, 1.0, 0.6, 0.0)
        spec, path = holstein_honeycomb_spec(geo), (mtm.MTM[torch.float32], kpm_mf.KPM_MF)
    else:
        geo, tbm, em = complex_chain_model(1152)
        spec = MeasurementSpec(geometry=geo)
        spec.add_correlation("greens", [(0, 0)], time_displaced=True)
        spec.add_correlation("current", [(tbm.bond_ids[0], tbm.bond_ids[0])], integrated=True)
        path = (kpm_mf.KPM_MF_CPLX,)
    cfg = SimulationConfig(beta=1.0, dtau=0.1, N_therm=1, N_measurements=2, N_bins=1, Nt=4, Nrv=4, seed=2,
                           n_walkers=2, preconditioner="kpm")
    counters = (mtm.MTM[torch.float32], mtm.MTM[torch.float64], pcg.PCG, pcg_force.PCG_FORCE, force.FORCE,
                kpm_mf.KPM_MF, kpm_mf.KPM_MF_ASYM, kpm_mf.KPM_MF_CPLX)
    for c in counters:
        c.reset()
    run = simulate(SimulationInfo(filepath=str(tmp_path), datafolder_prefix=model, sID=1), tbm, em, spec, cfg,
                   device=cuda_device)
    bins = []
    while True:
        try:
            bins.append(next(run))
        except StopIteration as done:
            md, finished = done.value
            break
    assert finished and md["all_converged"] and md["kpm_active"] and [b[:2] for b in bins] == [(0, 0), (1, 0)]
    for c in path:
        assert c.launches > 0, c.name
    assert pcg.PCG.launches == 0 and pcg_force.PCG_FORCE.launches == 0
    for c in counters:
        assert c.plain_calls == 0, c.name
    for _, _, tree in bins:
        for name, (re, im) in tree["correlations"].items():
            assert np.all(np.isfinite(re)) and np.all(np.isfinite(im)), name


def test_span_brackets_its_operator_and_kernel(cuda_device):
    """A span around a CUDA operator and the sync after it holds, on the
    profiler's clock, the operator's host event and its kernel (the spans'
    time.time_ns() and kineto's events share their base); the span leaves
    nothing of its own on the device's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smoqyelphqmc_tpu_torch import tracing

    x = torch.ones(1 << 20, device=cuda_device)
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("outer") as sp:
            x.mul_(3.0)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.name() == "aten::mul_" and e.device_type() == DeviceType.CPU]
    on_device = [e for e in events if e.device_type() != DeviceType.CPU]
    assert len(ops) == 1 and on_device and tracing.spans() == [sp]
    assert all(e.name() != "outer" for e in events)
    for e in ops + on_device:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns, (e.name(), e.start_ns(), sp.start_ns)
    tracing.clear()


def test_pcg_kernels_record_their_launches(cuda_device):
    """Under a profiler each K2 and K3 launch records its systems, sizes and
    the iteration tensor it returned, on the card, with no host read."""
    from torch.profiler import ProfilerActivity, profile

    from smoqyelphqmc_tpu_torch import tracing

    fdm = _fdm(cuda_device)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    gen = torch.Generator().manual_seed(7)
    L, N = fdm.Ltau, fdm.n_sites
    b = torch.randn((3, L, N), generator=gen).to(cuda_device, torch.float32)
    b = b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)
    fdm32w, prew, Lam, bw = _walker_problem(cuda_device, 2, 1.0)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, _, it2 = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 500)
        *_, it3 = pcg_force.pcg_force_cuda(fdm32w, prew, bw, torch.zeros_like(bw), Lam, 1e-5, 500, True)
    (r2,), (r3,) = pcg.PCG.records, pcg_force.PCG_FORCE.records
    assert (r2.kernel, r2.n_systems, r2.Ltau, r2.N) == ("pcg", 3, L, N) and r2.iters is it2
    assert (r3.kernel, r3.n_systems, r3.Ltau, r3.N) == ("pcg_force", 4, fdm32w.Ltau, fdm32w.n_sites)
    assert r3.iters is it3 and r3.iters.shape == (2,) and bool((r3.iters > 0).all())
    assert r2.iters.is_cuda and int(r2.iters) > 0
    tracing.clear()
