"""Per cent of kernel K1's device time that the H100 SXM's peaks need for
the work of its launches: for each K1 launch (`mtm_kernel`) in the profiled
sweeps, the least time of one M^T M on that launch's systems (the shape of
the output buffer the host allocates for it, (n_sys, Ltau, N), and its
dtype) with the configuration's hopping tables (`roofline.mtm_bound`),
summed and divided by K1's summed device time. The work is counted from
the operator's inputs, not from what the kernel does."""

from benchmark.roofline import mtm_bound
from benchmark.reference import greedy_colors

_ES = {"float": 4, "double": 8}


def read(run):
    t = run.trace
    if t is None:
        return None
    k1 = [k for k in t.kernels if "mtm_kernel" in k.name]
    if not k1 or any(k.dims is None or len(k.dims) != 3 or k.dtype not in _ES for k in k1):
        return None
    model = run.model()
    n_colors = len(greedy_colors(model.neighbor_table))
    least = sum(mtm_bound(int(k.dims[0]), int(k.dims[1]), int(k.dims[2]), _ES[k.dtype], n_colors,
                          model.neighbor_table.shape[1]) for k in k1)
    spent = sum(k.dur for k in k1) / 1e6
    return 100.0 * least / spent
