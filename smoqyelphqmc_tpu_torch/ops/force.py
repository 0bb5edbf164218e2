"""Kernel K4: the Holstein force epilogue, with its plain PyTorch version.

From the solution psi_raw of [M^T M] psi_raw = Lambda^{-T} Phi, the two
site-product planes P1, P2 (Ltau, N) that `derivatives.holstein_force_from_planes`
contracts into dS_f/dx (smoqyelphqmc_tpu/ops/pallas_fused.py:934-976,
`FusedForce`):

    psi = roll(x, +1) / Lambda,  lam_psi = roll(Lambda psi, -1)
    w = B roll(lam_psi, +1),  sw = sgn1 w,  A = lam_psi + sw   (= M lam_psi)
    P1 = sum_ch (CB^T A) (CB^{-1} sw)
    P2 = sum_ch roll(M^T A, +1) psi     (zeros unless want_p2)

Symmetric factorization, real hoppings, float32. psi_raw is
(..., 2, Ltau, N) and Lambda (..., Ltau, N); a walker batch carries its
fermion matrix's exp_nV as (W, 1, Ltau, N) (`updates.context.make_fdm`).
`force_planes` is the dispatcher: a CPU tensor takes `force_planes_plain`, a
CUDA tensor launches `csrc/force.cu` or raises. K3 (`ops/pcg_force.py`) runs the same epilogue
after its solve.
"""

from __future__ import annotations

import torch

from .. import _build
from .fermion_det import boundary_sign
from .mtm import KernelCounter, mtm_tables, require_real

FORCE = KernelCounter("force")


def planes(fdm32, Lam: torch.Tensor, x: torch.Tensor, want_p2: bool):
    """The epilogue's function in plain ops, uncounted (K3's plain version
    calls it too)."""
    L = fdm32.Ltau
    Lc = Lam.unsqueeze(-3)
    sgn1 = boundary_sign(L, True, x.dtype, x.device)
    psi = torch.roll(x, 1, dims=-2) / Lc
    lam_psi = torch.roll(Lc * psi, -1, dims=-2)
    sw = sgn1 * fdm32.apply_B(torch.roll(lam_psi, 1, dims=-2))
    A = lam_psi + sw
    up = fdm32.cb.apply(A, transpose=True)
    vp = fdm32.cb.apply(sw, inverse=True)
    P1 = torch.sum(up * vp, dim=-3)
    if not want_p2:
        return P1, torch.zeros_like(P1)
    MtA1 = torch.roll(fdm32.mul_Mt(A), 1, dims=-2)
    return P1, torch.sum(MtA1 * psi, dim=-3)


def check_operands(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor) -> int:
    """Validate the operands of K3 / K4; returns the number of walkers."""
    require_real(fdm32, "force kernels (K3 / K4)")
    if psi_raw.dtype != torch.float32 or Lam.dtype != torch.float32 or fdm32.dtype != torch.float32:
        raise TypeError("force kernels: psi_raw, Lambda and the fermion matrix must be float32")
    if not fdm32.symmetric:
        raise ValueError("force kernels: the symmetric factorization only")
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    if psi_raw.shape[-3:] != (2, Ltau, N) or Lam.shape[-2:] != (Ltau, N):
        raise ValueError(f"force kernels: psi_raw {tuple(psi_raw.shape)} or Lambda {tuple(Lam.shape)} "
                         f"is not (..., 2, {Ltau}, {N}) / (..., {Ltau}, {N})")
    W = psi_raw.numel() // (2 * Ltau * N)
    if Lam.numel() != W * Ltau * N or fdm32.exp_nV.numel() != W * Ltau * N:
        raise ValueError("force kernels: Lambda and exp_nV must hold one (Ltau, N) plane per walker")
    if not (psi_raw.device == Lam.device == fdm32.device):
        raise ValueError("force kernels: operands on different devices")
    return W


def force_planes_plain(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool):
    """(P1, P2) in plain PyTorch ops (the function K4 computes)."""
    require_real(fdm32, "force (K4)")
    FORCE.plain_calls += 1
    return planes(fdm32, Lam, psi_raw, want_p2)


def force_planes_cuda(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool):
    """Launch K4 on CUDA tensors."""
    W = check_operands(fdm32, Lam, psi_raw)
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    lead = psi_raw.shape[:-3]
    x = psi_raw.reshape(W, 2, Ltau, N).contiguous()
    lam = Lam.reshape(W, Ltau, N).contiguous()
    C, S, partner, expV = mtm_tables(fdm32)
    P1 = torch.empty((W, Ltau, N), dtype=torch.float32, device=x.device)
    P2 = torch.empty_like(P1)
    rc = _build.load_library().smoqy_force(
        x.data_ptr(), lam.data_ptr(), P1.data_ptr(), P2.data_ptr(), C.data_ptr(), S.data_ptr(),
        partner.data_ptr(), expV.data_ptr(), W, Ltau, N, C.shape[0], C.shape[1], int(want_p2),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "force kernel launch")
    FORCE.launches += 1
    return P1.reshape(lead + (Ltau, N)), P2.reshape(lead + (Ltau, N))


def force_planes(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool):
    """K4 dispatcher: plain version for CPU tensors, the kernel for CUDA tensors."""
    if psi_raw.device.type == "cpu":
        return force_planes_plain(fdm32, Lam, psi_raw, want_p2)
    if psi_raw.device.type == "cuda":
        return force_planes_cuda(fdm32, Lam, psi_raw, want_p2)
    raise RuntimeError(f"force_planes: no kernel for device {psi_raw.device}")
