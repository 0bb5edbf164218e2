"""Kernel K3: the whole-solve spectral PCG with an in-kernel warm start and the
Holstein force epilogue, for W walkers at once, with its plain version.

`solve_force(fdm, pre, b, Lam, x0, tol, maxiter, want_p2)` is the port of
`FusedPCG.solve_force` (the JAX package's ops/pallas_fused.py:823-849) with a
leading walker axis: b and x0 are (..., 2, Ltau, N), Lam is (..., Ltau, N),
the fermion matrix carries one exp_nV plane per walker (`make_fdm` on a walker
batch) and the spectral preconditioner is shared. Unlike K2's host side
(ops/pcg.py), the warm start enters the solve: r0 = b - M^T M x0, and each
channel system stops at |r| < tol |b|. It returns psi_raw, the planes P1, P2
(`ops/force.py`) and CGStats with per-channel eps = |r| / |b|, per-walker
iteration counts (iterations until both channels of the walker stopped) and
per-walker `converged` (finite and every eps < tol).

`pcg_force` is the dispatcher: a CPU tensor takes `pcg_force_plain`, a CUDA
tensor launches `csrc/pcg_force.cu` or raises. The kernel's matvec phases take
T consecutive tau rows of one system a CTA; `tau_block_rows` picks T (the
algebra of one block is `ops/mtm.py:mtm_blocked_plain`). While tracing is
on, each launch and each plain call leaves a record of its 2W channel
systems and its per-walker iteration counts in `PCG_FORCE.records`
(`tracing.Launch`).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..tracing import KernelCounter
from .cg import CGStats
from .force import check_operands, planes
from .mtm import mtm_tables, require_real
from .pcg import STAMP_HEAD, precond_plain, stamp_phases

PCG_FORCE = KernelCounter("pcg_force")

_TINY = 1e-30

# a CTA's dynamic shared memory that keeps two CTAs of K3 on an SM beside
# their static arrays (228 KB an SM)
SMEM_BUDGET = 96 * 1024
_GEMM_SMEM = 2 * (16 * 72 + 64 * 72) * 2  # csrc/pcg_common.cuh:kGemmSmem
_FORCE_ROWS = 8  # csrc/force_epilogue.cuh:kForceRows


def smem_bytes(N: int, T: int) -> int:
    """K3's dynamic shared memory for tau blocks of T rows
    (csrc/pcg_force.cu:pcg_force_smem_bytes): the GEMM stages, the epilogue's
    rows or the block's 5T + 5 rows (row_ops.cuh:mtm_block_rows), whichever
    is largest."""
    return max(max(5 * T + 5, _FORCE_ROWS) * N * 4, _GEMM_SMEM)


def tau_block_rows(n_systems: int, Ltau: int, N: int, grid: int) -> int:
    """T, the tau rows a CTA takes in K3's matvec phases: the fewest for which
    the n_systems * ceil(Ltau / T) blocks make one round of `grid` CTAs, but
    no more than the shared-memory budget allows (at least 1: at large N a
    block is one row, over the budget)."""
    fit = 1
    while fit < Ltau and smem_bytes(N, fit + 1) <= SMEM_BUDGET:
        fit += 1
    T = 1
    while T < fit and n_systems * -(-Ltau // T) > grid:
        T += 1
    return T


def tau_blocks(Ltau: int, T: int) -> list:
    """(first row, rows) of each block of a system, as the kernel walks them."""
    return [(l0, min(T, Ltau - l0)) for l0 in range(0, Ltau, T)]


def _grid(lib, N: int, T: int) -> int:
    grid = lib.smoqy_pcg_force_grid(N, T)
    if grid <= 0:
        raise RuntimeError(f"pcg_force kernel: no cooperative grid (CUDA error {-grid})")
    return grid


def tau_block(fdm32, n_systems: int) -> int:
    """T for a launch on this fermion matrix (the grid of one-row blocks is
    the most CTAs the kernel can have)."""
    grid = _grid(_build.load_library(), fdm32.n_sites, 1)
    return tau_block_rows(n_systems, fdm32.Ltau, fdm32.n_sites, grid)


def launch_shape(fdm32, n_systems: int) -> dict:
    """How K3 launches for n_systems on this fermion matrix: T, the grid
    and the dynamic shared memory in bytes."""
    lib = _build.load_library()
    T = tau_block(fdm32, n_systems)
    N = fdm32.n_sites
    return dict(tau_block=T, grid=_grid(lib, N, T), smem=lib.smoqy_pcg_force_smem_bytes(N, T))


def pcg_force_plain(fdm32, pre, b: torch.Tensor, x0: torch.Tensor, Lam: torch.Tensor, tol: float,
                    maxiter: int, want_p2: bool):
    """The function K3 computes, on b, x0 (W, 2, Ltau, N) and Lam (W, Ltau, N)
    float32. Returns (x, P1, P2, eps (2W,), iters (W,) int32)."""
    require_real(fdm32, "pcg_force (K3)")
    PCG_FORCE.plain_calls += 1
    W, _, L, N = b.shape
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    one = torch.ones((), dtype=torch.float32, device=b.device)

    def mtm(v):
        return fdm32.mul_Mt(fdm32.mul_M(v))

    def precond(r):
        return precond_plain(pre, r.reshape(2 * W, L, N)).reshape(W, 2, L, N)

    def sdot(u, v):
        return torch.sum(u * v, dim=(-2, -1))

    def col(s):
        return s[..., None, None]

    normb = torch.sqrt(sdot(b, b))
    tolc = tol * torch.clamp(normb, min=_TINY)
    x = x0
    r = b - mtm(x0)
    z = precond(r)
    p = z
    rdotz = sdot(r, z)
    eps = torch.sqrt(sdot(r, r))
    active = eps >= tolc
    iters = torch.zeros(W, dtype=torch.int32, device=b.device)
    it = 0
    while it < maxiter and bool(active.any()):
        iters += active.any(dim=-1).to(torch.int32)
        Ap = mtm(p)
        pAp = sdot(p, Ap)
        alpha = torch.where(active, rdotz / torch.where(pAp != 0, pAp, one), zero)
        x = x + col(alpha) * p
        r = r - col(alpha) * Ap
        eps = torch.where(active, torch.sqrt(sdot(r, r)), eps)
        on = active & (eps >= tolc)
        z = precond(r)
        new_rdotz = sdot(r, z)
        beta = torch.where(on, new_rdotz / torch.where(rdotz != 0, rdotz, one), zero)
        p = torch.where(col(on), z + col(beta) * p, p)
        rdotz = torch.where(on, new_rdotz, rdotz)
        active = on
        it += 1
    P1, P2 = planes(fdm32, Lam, x, want_p2)
    PCG_FORCE.record(2 * W, L, N, iters)
    return x, P1, P2, (eps / torch.clamp(normb, min=_TINY)).reshape(2 * W), iters


def pcg_force_cuda(fdm32, pre, b: torch.Tensor, x0: torch.Tensor, Lam: torch.Tensor, tol: float,
                   maxiter: int, want_p2: bool, stamps=None, tau_rows=None):
    """Launch K3 on contiguous CUDA tensors b, x0 (W, 2, Ltau, N), Lam (W, Ltau, N).

    `stamps`, an int64 CUDA tensor of `stamp_slots(maxiter)` entries, selects
    the timed instantiation, which records per-phase clocks there
    (`phase_times`); `tau_rows` overrides T (`tau_block`); the path passes
    neither."""
    W = check_operands(fdm32, Lam, b)
    if x0.shape != b.shape or x0.dtype != b.dtype or x0.device != b.device or pre.Q.device != b.device:
        raise ValueError("pcg_force kernel: x0 or the preconditioner does not match b")
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    if pre.n_sites != N or pre.Ltau != Ltau:
        raise ValueError("pcg_force kernel: preconditioner and fermion matrix sizes differ")
    lib = _build.load_library()
    if 2 * W > lib.smoqy_pcg_max_systems():
        raise ValueError(f"pcg_force kernel: {W} walkers, at most {lib.smoqy_pcg_max_systems() // 2}")
    b, x0, Lam = b.contiguous(), x0.contiguous(), Lam.contiguous()
    C, S, partner, expV = mtm_tables(fdm32)
    if C.shape[0] < 1:
        raise ValueError("pcg_force kernel: the fermion matrix has no hopping colors")
    T = tau_block(fdm32, 2 * W) if tau_rows is None else int(tau_rows)
    if not 1 <= T <= Ltau:
        raise ValueError(f"pcg_force kernel: tau blocks of {T} rows, Ltau = {Ltau}")
    ops = pre.pcg_operands()
    dev = b.device
    x = torch.empty_like(b)
    P1 = torch.empty((W, Ltau, N), dtype=torch.float32, device=dev)
    P2 = torch.empty_like(P1)
    eps = torch.empty(2 * W, dtype=torch.float32, device=dev)
    iters = torch.empty(W, dtype=torch.int32, device=dev)
    # r and p (two planes each), z, Ap in f32, then U, Am, Bm (2W, 2 Lh, N) in bf16
    work = torch.empty(2 * W * N * (6 * Ltau + 3 * ops.Lh), dtype=torch.float32, device=dev)
    part = torch.empty(3 * lib.smoqy_pcg_max_grid() * 2 * W, dtype=torch.float64, device=dev)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev
                               or not stamps.is_contiguous() or stamps.numel() < stamp_slots(maxiter)):
        raise ValueError(f"pcg_force kernel: stamps must be a contiguous int64 tensor of {stamp_slots(maxiter)} "
                         f"on {dev}")
    rc = lib.smoqy_pcg_force(
        b.data_ptr(), x0.data_ptr(), Lam.data_ptr(), x.data_ptr(), P1.data_ptr(), P2.data_ptr(),
        eps.data_ptr(), iters.data_ptr(), C.data_ptr(), S.data_ptr(), partner.data_ptr(),
        expV.data_ptr(), ops.W.data_ptr(), ops.Wt.data_ptr(), ops.Q.data_ptr(), ops.Qt.data_ptr(),
        ops.filt.data_ptr(), work.data_ptr(), part.data_ptr(), W, Ltau, ops.Lh, N, C.shape[0], C.shape[1], T,
        float(tol), int(maxiter),
        int(want_p2), None if stamps is None else stamps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "pcg_force kernel launch")
    PCG_FORCE.launches += 1
    PCG_FORCE.record(2 * W, Ltau, N, iters)
    return x, P1, P2, eps, iters


def _once_phases(lib) -> tuple:
    return tuple(lib.smoqy_pcg_force_once_phases().decode().split(","))


def stamp_slots(maxiter: int) -> int:
    lib = _build.load_library()
    return STAMP_HEAD + len(_once_phases(lib)) + maxiter * lib.smoqy_pcg_force_stamps_per_iteration()


def phase_times(stamps: torch.Tensor, iters: int) -> dict:
    """Microseconds of each phase of the timed instantiation's run: per loop
    iteration (mean over `iters`, the largest per-walker count), and under
    "once" the phases before the loop, the loop and the epilogue."""
    lib = _build.load_library()
    return stamp_phases(stamps.cpu().tolist(), iters, lib.smoqy_pcg_force_phases().decode().split(","),
                        lib.smoqy_pcg_force_stamps_per_iteration(), _once_phases(lib))


def pcg_force(fdm32, pre, b, x0, Lam, tol: float, maxiter: int, want_p2: bool):
    """K3 dispatcher: plain version for CPU tensors, the kernel for CUDA tensors."""
    if b.device.type == "cpu":
        return pcg_force_plain(fdm32, pre, b, x0, Lam, tol, maxiter, want_p2)
    if b.device.type == "cuda":
        return pcg_force_cuda(fdm32, pre, b, x0, Lam, tol, maxiter, want_p2)
    raise RuntimeError(f"pcg_force: no kernel for device {b.device}")


def solve_force(fdm, pre, b: torch.Tensor, Lam: torch.Tensor, x0=None, tol: float = 1e-5,
                maxiter: int = 500, want_p2: bool = True):
    """Solve [M^T M] psi_raw = b for every channel pair of b (..., 2, Ltau, N)
    and emit the force planes (..., Ltau, N). Returns (psi_raw, P1, P2, CGStats)."""
    fdm32 = fdm if fdm.dtype == torch.float32 else fdm.astype(torch.float32)
    shape = b.shape
    lead, Ltau, N = shape[:-3], shape[-2], shape[-1]
    W = math.prod(lead)
    bb = b.to(torch.float32).reshape(W, 2, Ltau, N)
    xx0 = torch.zeros_like(bb) if x0 is None else x0.to(torch.float32).reshape(W, 2, Ltau, N)
    x, P1, P2, eps, iters = pcg_force(fdm32, pre, bb, xx0, Lam.to(torch.float32).reshape(W, Ltau, N),
                                      float(tol), int(maxiter), bool(want_p2))
    x = x.reshape(shape)
    eps = eps.reshape(lead + (2,))
    converged = torch.isfinite(x).reshape(lead + (-1,)).all(dim=-1) & (eps < tol).all(dim=-1)
    stats = CGStats(iters=iters.reshape(lead), eps=eps, converged=converged)
    return x, P1.reshape(lead + (Ltau, N)), P2.reshape(lead + (Ltau, N)), stats
