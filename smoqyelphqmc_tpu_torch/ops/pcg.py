"""Kernel K2: the whole-solve spectral-preconditioned CG, with its plain version.

`SpectralPCG(fdm, pre)(b, x0, tol, maxiter)` keeps the host-side semantics of
`FusedPCG.__call__` (smoqyelphqmc_tpu/ops/pallas_fused.py:851-904): each system
is scaled to unit norm so the solve's absolute stopping test is the
b-relative one, a warm start x0 becomes a cold solve for the correction
against b - M^T M x0 (that matvec is kernel K1), `iters` is the solve's loop
count and `converged` means all finite and every eps < tol. The tolerance is
an ordinary float here, so the JAX package's rhs rescaling for traced
tolerances is not needed.

`pcg_unit` is the dispatcher of the solve on unit-norm right-hand sides: a CPU
tensor takes `pcg_plain`, a CUDA tensor launches `csrc/pcg.cu` or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .cg import CGStats
from .mtm import KernelCounter, mtm_plain, mtm_tables, mul_MtM

PCG = KernelCounter("pcg")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def precond_plain(pre, r: torch.Tensor) -> torch.Tensor:
    """The kernel's preconditioner apply in plain ops: the half-spectrum form of
    `_pcg_ops.precond` (pallas_fused.py:455-478), bf16 operands, f32 sums."""
    W, Qb, filt, Lh = pre.pcg_operands()
    Wf, Qf = W.to(torch.float32), Qb.to(torch.float32)
    U = torch.einsum("ml,bln->bmn", Wf, _bf16(r))  # (B, 2 Lh, N): [Re; Im]
    A = (_bf16(U) @ Qf) * torch.cat([filt, filt])
    Bm = _bf16(A) @ Qf.T
    return torch.einsum("ml,bmn->bln", Wf, _bf16(Bm))


def pcg_plain(fdm32, pre, b: torch.Tensor, tol: float, maxiter: int):
    """Solve [M^T M] x = b for unit-norm systems b (B, Ltau, N) f32 with an
    absolute stopping test: the function K2 computes. Returns (x, eps, iters)."""
    PCG.plain_calls += 1
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    one = torch.ones((), dtype=torch.float32, device=b.device)

    def sdot(u, v):
        return torch.sum(u * v, dim=(1, 2))

    def col(s):
        return s[:, None, None]

    x = torch.zeros_like(b)
    r = b
    z = precond_plain(pre, r)
    p = z
    rdotz = sdot(r, z)
    eps = torch.sqrt(sdot(r, r))
    active = eps >= tol
    it = 0
    while it < maxiter and bool(active.any()):
        Ap = mtm_plain(fdm32, p)
        pAp = sdot(p, Ap)
        alpha = torch.where(active, rdotz / torch.where(pAp != 0, pAp, one), zero)
        x = x + col(alpha) * p
        r = r - col(alpha) * Ap
        eps = torch.where(active, torch.sqrt(sdot(r, r)), eps)
        on = active & (eps >= tol)
        z = precond_plain(pre, r)
        new_rdotz = sdot(r, z)
        beta = torch.where(on, new_rdotz / torch.where(rdotz != 0, rdotz, one), zero)
        p = torch.where(col(on), z + col(beta) * p, p)
        rdotz = torch.where(on, new_rdotz, rdotz)
        active = on
        it += 1
    return x, eps, torch.tensor(it, dtype=torch.int32)


def pcg_cuda(fdm32, pre, b: torch.Tensor, tol: float, maxiter: int):
    """Launch K2 on unit-norm systems b (B, Ltau, N), a contiguous f32 CUDA tensor."""
    if b.dtype != torch.float32 or fdm32.dtype != torch.float32:
        raise TypeError("pcg kernel: b and the fermion matrix must be float32")
    if b.device != fdm32.device or pre.Q.device != b.device:
        raise ValueError("pcg kernel: b, the fermion matrix and the preconditioner must share a device")
    B, Ltau, N = b.shape
    if (Ltau, N) != (fdm32.Ltau, fdm32.n_sites) or pre.n_sites != N or pre.Ltau != Ltau:
        raise ValueError(f"pcg kernel: shape {tuple(b.shape)} does not match the operator")
    lib = _build.load_library()
    if B > lib.smoqy_pcg_max_systems():
        raise ValueError(f"pcg kernel: {B} systems, at most {lib.smoqy_pcg_max_systems()}")
    b = b.contiguous()
    C, S, partner, expV = mtm_tables(fdm32)
    W, Qb, filt, Lh = pre.pcg_operands()
    dev = b.device
    x = torch.empty_like(b)
    eps = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    work = torch.empty(B * N * (4 * Ltau + 6 * Lh), dtype=torch.float32, device=dev)
    part = torch.empty(3 * lib.smoqy_pcg_max_grid() * B, dtype=torch.float64, device=dev)
    rc = lib.smoqy_pcg(
        b.data_ptr(), x.data_ptr(), eps.data_ptr(), iters.data_ptr(),
        C.data_ptr(), S.data_ptr(), partner.data_ptr(), expV.data_ptr(),
        W.data_ptr(), Qb.data_ptr(), filt.data_ptr(), work.data_ptr(), part.data_ptr(),
        B, Ltau, Lh, N, C.shape[0], C.shape[1], int(fdm32.symmetric),
        float(tol), int(maxiter), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "pcg kernel launch")
    PCG.launches += 1
    return x, eps, iters[0]


def pcg_unit(fdm32, pre, b: torch.Tensor, tol: float, maxiter: int):
    """K2 dispatcher on unit-norm systems: plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if b.device.type == "cpu":
        return pcg_plain(fdm32, pre, b, tol, maxiter)
    if b.device.type == "cuda":
        return pcg_cuda(fdm32, pre, b, tol, maxiter)
    raise RuntimeError(f"pcg: no kernel for device {b.device}")


class SpectralPCG:
    """Whole-solve f32 spectral PCG for one (fermion matrix, preconditioner) pair."""

    def __init__(self, fdm, pre):
        if pre.n_sites != fdm.n_sites or pre.Ltau != fdm.Ltau:
            raise ValueError("preconditioner and fermion matrix sizes differ")
        self.fdm32 = fdm if fdm.dtype == torch.float32 else fdm.astype(torch.float32)
        self.pre = pre

    def __call__(self, b: torch.Tensor, x0=None, tol: float = 1e-5, maxiter: int = 500):
        shape = b.shape
        Ltau, N = shape[-2], shape[-1]
        bb = b.to(torch.float32).reshape(-1, Ltau, N)
        normb = torch.sqrt(torch.sum(bb * bb, dim=(1, 2), keepdim=True))
        safe_normb = torch.where(normb > 0, normb, torch.ones_like(normb))
        if x0 is None:
            rhs = bb / safe_normb
        else:
            xx0 = x0.to(torch.float32).reshape(-1, Ltau, N)
            rhs = (bb - mul_MtM(self.fdm32, xx0)) / safe_normb
        x, eps, iters = pcg_unit(self.fdm32, self.pre, rhs.contiguous(), float(tol), int(maxiter))
        x = x * safe_normb
        if x0 is not None:
            x = x + xx0
        x = x.reshape(shape)
        eps = eps.reshape(shape[:-2])
        converged = torch.isfinite(x).all() & (eps < tol).all()
        return x, CGStats(iters=iters, eps=eps, converged=converged)
