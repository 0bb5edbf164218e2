"""Kernel K2: the whole-solve spectral-preconditioned CG, with its plain version.

`SpectralPCG(fdm, pre)(b, x0, tol, maxiter)` keeps the host-side semantics of
`FusedPCG.__call__` (the JAX package's ops/pallas_fused.py:851-904): each system
is scaled to unit norm so the solve's absolute stopping test is the
b-relative one, a warm start x0 becomes a cold solve for the correction
against b - M^T M x0 (that matvec is kernel K1), `iters` is the solve's loop
count and `converged` means all finite and every eps < tol. The tolerance is
an ordinary float here, so the JAX package's rhs rescaling for traced
tolerances is not needed.

`pcg_unit` is the dispatcher of the solve on unit-norm right-hand sides: a CPU
tensor takes `pcg_plain`, a CUDA tensor launches `csrc/pcg.cu` or raises.
While tracing is on, each launch and each plain call leaves a record of its
systems and its iteration count in `PCG.records` (`tracing.Launch`).
"""

from __future__ import annotations

import torch

from .. import _build
from ..tracing import KernelCounter
from .cg import CGStats
from .mtm import mtm_plain, mtm_tables, mul_MtM, require_real

PCG = KernelCounter("pcg")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def precond_plain(pre, r: torch.Tensor) -> torch.Tensor:
    """The kernel's preconditioner apply in plain ops: the half-spectrum form of
    `_pcg_ops.precond` (pallas_fused.py:455-478), bf16 operands, f32 sums;
    the intermediates U, Am, Bm are stored in bf16, as the kernels store them."""
    ops = pre.pcg_operands()
    Wf, Qf = ops.W.to(torch.float32), ops.Q.to(torch.float32)
    U = torch.einsum("ml,bln->bmn", Wf, _bf16(r)).to(torch.bfloat16)  # (B, 2 Lh, N): [Re; Im]
    Am = ((U.to(torch.float32) @ Qf) * torch.cat([ops.filt, ops.filt])).to(torch.bfloat16)
    Bm = (Am.to(torch.float32) @ Qf.T).to(torch.bfloat16)
    return torch.einsum("ml,bmn->bln", Wf, Bm.to(torch.float32))


def pcg_plain(fdm32, pre, b: torch.Tensor, tol: float, maxiter: int):
    """Solve [M^T M] x = b for unit-norm systems b (B, Ltau, N) f32 with an
    absolute stopping test: the function K2 computes. Returns (x, eps, iters)."""
    require_real(fdm32, "pcg (K2)")
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
    iters = torch.tensor(it, dtype=torch.int32)
    PCG.record(b.shape[0], b.shape[1], b.shape[2], iters)
    return x, eps, iters


def pcg_cuda(fdm32, pre, b: torch.Tensor, tol: float, maxiter: int, stamps=None):
    """Launch K2 on unit-norm systems b (B, Ltau, N), a contiguous f32 CUDA tensor.

    `stamps`, an int64 CUDA tensor of `stamp_slots(maxiter)` entries, selects
    the timed instantiation, which records per-phase clocks there
    (`phase_times`); the path never passes it."""
    require_real(fdm32, "pcg kernel (K2)")
    if b.dtype != torch.float32 or fdm32.dtype != torch.float32:
        raise TypeError("pcg kernel: b and the fermion matrix must be float32")
    if b.device != fdm32.device or pre.Q.device != b.device:
        raise ValueError("pcg kernel: b, the fermion matrix and the preconditioner must share a device")
    B, Ltau, N = b.shape
    if fdm32.exp_nV.dim() != 2:
        raise ValueError("pcg kernel: one fermion matrix, not a walker batch")
    if (Ltau, N) != (fdm32.Ltau, fdm32.n_sites) or pre.n_sites != N or pre.Ltau != Ltau:
        raise ValueError(f"pcg kernel: shape {tuple(b.shape)} does not match the operator")
    lib = _build.load_library()
    if B > lib.smoqy_pcg_max_systems():
        raise ValueError(f"pcg kernel: {B} systems, at most {lib.smoqy_pcg_max_systems()}")
    b = b.contiguous()
    C, S, partner, expV = mtm_tables(fdm32)
    ops = pre.pcg_operands()
    dev = b.device
    x = torch.empty_like(b)
    eps = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    # r and p (two planes each), z, Ap in f32, then U, Am, Bm (B, 2 Lh, N) in bf16
    work = torch.empty(B * N * (6 * Ltau + 3 * ops.Lh), dtype=torch.float32, device=dev)
    part = torch.empty(3 * lib.smoqy_pcg_max_grid() * B, dtype=torch.float64, device=dev)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev
                               or not stamps.is_contiguous() or stamps.numel() < stamp_slots(maxiter)):
        raise ValueError(f"pcg kernel: stamps must be a contiguous int64 tensor of {stamp_slots(maxiter)} on {dev}")
    rc = lib.smoqy_pcg(
        b.data_ptr(), x.data_ptr(), eps.data_ptr(), iters.data_ptr(),
        C.data_ptr(), S.data_ptr(), partner.data_ptr(), expV.data_ptr(),
        ops.W.data_ptr(), ops.Wt.data_ptr(), ops.Q.data_ptr(), ops.Qt.data_ptr(), ops.filt.data_ptr(),
        work.data_ptr(), part.data_ptr(), B, Ltau, ops.Lh, N, C.shape[0], C.shape[1], int(fdm32.symmetric),
        float(tol), int(maxiter), None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "pcg kernel launch")
    PCG.launches += 1
    iters = iters[0]
    PCG.record(B, Ltau, N, iters)
    return x, eps, iters


STAMP_HEAD = 4  # globaltimer and clock64 at the kernel's start and end


def stamp_slots(maxiter: int) -> int:
    return STAMP_HEAD + maxiter * _build.load_library().smoqy_pcg_stamps_per_iteration()


def phase_times(stamps: torch.Tensor, iters: int) -> dict:
    """Mean microseconds per iteration of each phase of the timed
    instantiation's run, from its stamps (clock64 of CTA 0, converted with the
    globaltimer / clock64 pairs at the kernel's start and end)."""
    lib = _build.load_library()
    return stamp_phases(stamps.cpu().tolist(), iters, lib.smoqy_pcg_phases().decode().split(","),
                        lib.smoqy_pcg_stamps_per_iteration())


def stamp_phases(t: list, iters: int, names: list, per_iteration: int, once: tuple = ()) -> dict:
    """Microseconds of each phase from a timed instantiation's stamps t: the
    mean per iteration of each loop phase (`names`, the gaps between an
    iteration's `per_iteration` stamps), of the whole iteration, the kernel's
    time, and, where the kernel stamps `once` phases (each ending at a stamp
    of its own, slots STAMP_HEAD.., the first starting at the kernel's
    start), their times under "once"; the loop's stamps follow those."""
    us_per_cycle = (t[2] - t[0]) / (t[3] - t[1]) / 1e3
    first = STAMP_HEAD + len(once)
    rows = [t[first + i * per_iteration:first + (i + 1) * per_iteration] for i in range(iters)]
    out = {name: us_per_cycle * sum(r[j + 1] - r[j] for r in rows) / max(iters, 1) for j, name in enumerate(names)}
    out["iteration"] = us_per_cycle * sum(r[-1] - r[0] for r in rows) / max(iters, 1)
    out["kernel"] = (t[2] - t[0]) / 1e3
    if once:
        chain = [t[1]] + t[STAMP_HEAD:first]
        out["once"] = {name: us_per_cycle * (chain[j + 1] - chain[j]) for j, name in enumerate(once)}
    return out


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
        require_real(fdm, "SpectralPCG (K2)")
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
