"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so on the GPU machine it runs without the
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: K1 f32 2e-6 and f64 1e-12 relative (max-norm); K2 solutions
rtol 2e-4 / atol 2e-5, both converged (tests/test_pallas.py:65, :96).
"""

import numpy as np
import pytest
import torch

from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import mtm, pcg
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
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


def test_mtm_kernel_tau_dependent_tables(cuda_device):
    """Full (n_colors, Ltau, N) C/S tables (tau stride N), the layout of
    tau-dependent hoppings, through the same kernel."""
    import dataclasses

    fdm = dataclasses.replace(_fdm(cuda_device, beta=0.9), static_hops=False)
    C, S, _, _ = mtm.mtm_tables(fdm)
    assert C.shape[1] == fdm.Ltau == 9
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4)).to(cuda_device)
    got, ref = mtm.mtm_cuda(fdm, v), mtm.mtm_plain(fdm, v)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12


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
