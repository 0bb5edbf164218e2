"""The least time of a launch of kernel K2 (the whole-solve spectral PCG) or
K3 (the same solve for W walkers with the force epilogue) on one NVIDIA H100
SXM, from the work its systems need for the iterations the launch reports
(copies of `chip_smoke.py`'s `pcg_iteration_ops`, `precond_bytes` and
`epilogue_ops` and of its byte counts of phases K2 and K3, frozen here on
top of `roofline.bound`, `b_flops` and `table_bytes`).

The work is an upper count: K2 reports one iteration count for all its
systems, and every system is charged it, though a system that converged
earlier stops iterating; K3 charges each walker's two channel systems the
walker's count.
"""

from __future__ import annotations

from benchmark.roofline import b_flops, bound, table_bytes


def pcg_iteration_ops(Ltau: int, N: int, n_colors: int, symmetric: bool = True):
    """(f32, bf16) operations of one CG iteration of one (Ltau, N) system:
    M^T M and ten vector operations an element in f32; the half-spectrum
    preconditioner's four products in bf16 (DFT rows, Q, Q^T, inverse DFT)
    and its filter."""
    Lh = Ltau // 2 if Ltau % 2 == 0 else Ltau
    f32 = Ltau * N * (2 * b_flops(n_colors, symmetric) + 4 + 10) + 2 * Lh * N
    bf16 = 2 * (2 * Lh) * Ltau * N * 2 + 2 * (2 * Lh) * N * N * 2
    return f32, bf16


def precond_bytes(Ltau: int, N: int) -> int:
    """The preconditioner's operands (bf16 Q, DFT rows and filter), read once."""
    Lh = Ltau // 2 if Ltau % 2 == 0 else Ltau
    return 2 * N * N + 2 * (2 * Lh) * Ltau + 4 * Lh * N


def epilogue_ops(Ltau: int, N: int, n_colors: int) -> int:
    """K3's force epilogue a channel pair: per channel and site one B, B^T
    (for M^T A), CB^T and CB^{-1} (3 n_colors each) and ~10 products and sums."""
    return 2 * Ltau * N * (2 * b_flops(n_colors, True) + 6 * n_colors + 10)


def pcg_bound(n_systems: int, Ltau: int, N: int, iters: int, n_colors: int, n_hops: int,
              symmetric: bool = True) -> float:
    """Seconds: a K2 launch of n_systems f32 systems, each charged `iters`
    iterations; b in and x out, exp(-dtau V), the preconditioner and the
    hopping tables read once."""
    f32_it, bf16_it = pcg_iteration_ops(Ltau, N, n_colors, symmetric)
    n_it = iters * n_systems
    nbytes = 4 * (2 * n_systems * Ltau * N + Ltau * N) + precond_bytes(Ltau, N) + table_bytes(n_hops, 4)
    return bound(nbytes, {"f32": n_it * f32_it, "bf16": n_it * bf16_it})


def pcg_force_bound(walker_iters, Ltau: int, N: int, n_colors: int, n_hops: int, symmetric: bool = True) -> float:
    """Seconds: a K3 launch of W = len(walker_iters) walkers, each walker's
    two channel systems charged its count, the epilogue once a walker; b,
    x0, x (two planes each), Lambda, exp(-dtau V), P1 and P2 a walker, the
    preconditioner and the hopping tables read or written once."""
    f32_it, bf16_it = pcg_iteration_ops(Ltau, N, n_colors, symmetric)
    W = len(walker_iters)
    n_it = 2 * sum(walker_iters)
    plane = W * Ltau * N * 4
    nbytes = 10 * plane + precond_bytes(Ltau, N) + table_bytes(n_hops, 4)
    return bound(nbytes, {"f32": n_it * f32_it + W * epilogue_ops(Ltau, N, n_colors), "bf16": n_it * bf16_it})
