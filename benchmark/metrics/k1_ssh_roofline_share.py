"""Per cent of kernel K1's device time that the H100 SXM's peaks need for
the work of its launches, with SSH hopping tables: as `k1_roofline_share`,
each K1 launch (`mtm_kernel`) in the profiled sweeps priced by
`roofline.mtm_bound` on its output buffer's shape (n_sys, Ltau, N) and
dtype, but with each hop's cosh and sinh on Ltau rows (the per-slice tables
of SSH-modulated hoppings, `ops/mtm.py:mtm_tables`), Ltau = beta / dtau of
the configuration. None where a launch's shape cannot be read or is not on
Ltau rows."""

from benchmark.reference import greedy_colors
from benchmark.roofline import mtm_bound

_ES = {"float": 4, "double": 8}


def read(run):
    t = run.trace
    if t is None:
        return None
    c = run.cell.config
    Ltau = int(round(c["beta"] / c["dtau"]))
    k1 = [k for k in t.kernels if "mtm_kernel" in k.name]
    if not k1 or any(k.dims is None or len(k.dims) != 3 or k.dtype not in _ES or int(k.dims[1]) != Ltau
                     for k in k1):
        return None
    model = run.model()
    n_colors = len(greedy_colors(model.neighbor_table))
    least = sum(mtm_bound(int(k.dims[0]), Ltau, int(k.dims[2]), _ES[k.dtype], n_colors,
                          model.neighbor_table.shape[1], rows=Ltau) for k in k1)
    spent = sum(k.dur for k in k1) / 1e6
    return 100.0 * least / spent
