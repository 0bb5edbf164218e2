"""Batched preconditioned conjugate gradient (port of the JAX package's ops/cg.py).

One CG drives many right-hand sides at once (every leading axis of a
(..., Ltau, N) tensor is an independent system; with sys_ndim = 3 the
trailing (channel, Ltau, N) axes form one system, for an operator that mixes
the complex channel pair), with per-system convergence masks. The loop runs
eagerly; its condition reads one flag per iteration.
`converged` is False on non-finite values or iteration exhaustion, and callers
fold it into the Metropolis decision.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGStats(NamedTuple):
    iters: torch.Tensor  # () int: loop iterations executed (summed over cycles in mixed CG)
    eps: torch.Tensor  # per-system relative residual |r| / |b|
    converged: torch.Tensor  # () bool: all systems converged to finite solutions


def _sys_dot(a: torch.Tensor, b: torch.Tensor, sys_ndim: int = 2) -> torch.Tensor:
    """Per-system inner product over the trailing sys_ndim axes."""
    return torch.sum(a * b, dim=tuple(range(-sys_ndim, 0)))


def _col(v: torch.Tensor, sys_ndim: int = 2) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * sys_ndim)


def cg_solve(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    x0: Optional[torch.Tensor] = None,
    sys_ndim: int = 2,
):
    """Solve A x = b (A symmetric positive definite, left preconditioner);
    the trailing sys_ndim axes of b form one system. Returns (x, CGStats)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731

    def dot(u, v):
        return _sys_dot(u, v, sys_ndim)

    def col(v):
        return _col(v, sys_ndim)

    normb = torch.sqrt(dot(b, b))
    safe_normb = torch.where(normb > 0, normb, torch.ones_like(normb))
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - apply_A(x0)
    z = precond(r)
    p = z
    rdotz = dot(r, z)
    eps = torch.sqrt(dot(r, r)) / safe_normb
    active = eps >= tol
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    it = 0
    while it < maxiter and bool(active.any()):
        Ap = apply_A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(active, rdotz / torch.where(pAp != 0, pAp, torch.ones_like(pAp)), zero)
        x = x + col(alpha) * p
        r = r - col(alpha) * Ap
        eps = torch.where(active, torch.sqrt(dot(r, r)) / safe_normb, eps)
        active_new = active & (eps >= tol)
        z = precond(r)
        new_rdotz = dot(r, z)
        beta = torch.where(active_new, new_rdotz / torch.where(rdotz != 0, rdotz, torch.ones_like(rdotz)), zero)
        p = torch.where(col(active_new), z + col(beta) * p, p)
        rdotz = torch.where(active_new, new_rdotz, rdotz)
        active = active_new
        it += 1
    converged = torch.isfinite(x).all() & ~active.any()
    return x, CGStats(iters=torch.tensor(it), eps=eps, converged=converged)


def cg_solve_mixed(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    apply_A_low: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    inner_tol: float = 1e-5,
    max_outer: int = 12,
    inner_solver: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    sys_ndim: int = 2,
):
    """Mixed-precision defect-correction CG: f32 inner solves of A e = r,
    f64 residuals r = b - A x, with the adaptive last-cycle tolerance
    itol = max(inner_tol, min(0.25, 0.25 tol / max eps)). `inner_solver(r32,
    itol, maxiter)` replaces the inner cg_solve (kernel K2 on the main path)."""

    def dot(u, v):
        return _sys_dot(u, v, sys_ndim)

    normb = torch.sqrt(dot(b, b))
    safe_normb = torch.where(normb > 0, normb, torch.ones_like(normb))
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0.to(b.dtype)
        r = b - apply_A(x)
    eps = torch.sqrt(dot(r, r)) / safe_normb
    it_total = torch.zeros((), dtype=torch.int64)
    outer = 0
    while outer < max_outer and not bool((eps < tol).all()):
        itol = max(inner_tol, min(0.25, 0.25 * tol / max(float(eps.max()), 1e-300)))
        if inner_solver is not None:
            e32, stats = inner_solver(r.to(torch.float32), itol, maxiter)
        else:
            e32, stats = cg_solve(apply_A_low, r.to(torch.float32), precond=precond, tol=itol, maxiter=maxiter,
                                   sys_ndim=sys_ndim)
        x = x + e32.to(x.dtype)
        r = b - apply_A(x)
        eps = torch.sqrt(dot(r, r)) / safe_normb
        it_total = it_total + stats.iters.cpu()
        outer += 1
    converged = torch.isfinite(x).all() & (eps < tol).all()
    return x, CGStats(iters=it_total, eps=eps, converged=converged)
