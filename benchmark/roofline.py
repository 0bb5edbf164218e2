"""The least time of a kernel launch on one NVIDIA H100 SXM, from the work
its operator needs (copies of `chip_smoke.py`'s `bound`, `b_flops`,
`table_bytes` and `mtm_bound`, frozen here).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: HBM 3.35
TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}


def bound(nbytes: float, ops: dict) -> float:
    """Seconds: the larger of nbytes over the HBM rate and the operations
    {type: count} over their peaks."""
    return max(nbytes / HBM_BYTES_S, sum(n / PEAK_FLOPS[k] for k, n in ops.items()))


def b_flops(n_colors: int, symmetric: bool) -> int:
    """Operations per site of one propagator B: each colour is C u + S
    u[partner] (3), the diagonal one multiply; the symmetric B sweeps the
    colours twice."""
    return (2 if symmetric else 1) * 3 * n_colors + 1


def table_bytes(n_hops: int, es: int, rows: int = 1, complex_hops: bool = False) -> int:
    """Each hop's cosh and sinh (and the sinh of its imaginary part) in es
    bytes, on `rows` tau rows (1 for tau-independent hoppings), and the
    neighbour table's two int32 sites a hop."""
    return n_hops * ((3 if complex_hops else 2) * es * rows + 2 * 4)


def mtm_work(n_sys: int, Ltau: int, N: int, es: int, n_colors: int, n_hops: int, rows: int = 1):
    """(bytes, operations) of one M^T M on n_sys (Ltau, N) systems: v in and
    out once, exp(-dtau V) and the hopping data; two B and four multiply-adds
    a site of each row."""
    ops = n_sys * Ltau * N * (2 * b_flops(n_colors, True) + 4)
    nbytes = es * (2 * n_sys * Ltau * N + Ltau * N) + table_bytes(n_hops, es, rows)
    return nbytes, ops


def mtm_bound(n_sys: int, Ltau: int, N: int, es: int, n_colors: int, n_hops: int, rows: int = 1) -> float:
    nbytes, ops = mtm_work(n_sys, Ltau, N, es, n_colors, n_hops, rows)
    return bound(nbytes, {"f32" if es == 4 else "f64": ops})
