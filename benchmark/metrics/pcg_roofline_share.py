"""Per cent of kernels K2's and K3's device time that the H100 SXM's peaks
need for the work of their launches: for each K2 and K3 launch in the
profiled sweeps, the program's record of it (`smoqyelphqmc_tpu_torch.tracing`:
its systems, (Ltau, N) and the iteration counts it returned) priced by
`roofline_pcg`, with the configuration's colours and hops, summed and divided
by the summed device time of `pcg_kernel` and `pcg_force_kernel`. The work
is an upper count (`roofline_pcg`). None when the records do not pair one to
one with the kernels in the trace."""

from benchmark.reference import greedy_colors
from benchmark.roofline_pcg import pcg_bound, pcg_force_bound


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from smoqyelphqmc_tpu_torch.ops.pcg import PCG
        from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE
    except ImportError:
        return None
    k2, k3 = getattr(PCG, "records", None), getattr(PCG_FORCE, "records", None)
    k2_kernels = [k for k in t.kernels if "pcg_kernel" in k.name]
    k3_kernels = [k for k in t.kernels if "pcg_force_kernel" in k.name]
    if not k2 or k3 is None or len(k2) != len(k2_kernels) or len(k3) != len(k3_kernels):
        return None
    model = run.model()
    n_colors, n_hops = len(greedy_colors(model.neighbor_table)), model.neighbor_table.shape[1]
    symmetric = bool(run.cell.config.get("symmetric", True))
    least = sum(pcg_bound(r.n_systems, r.Ltau, r.N, int(r.iters), n_colors, n_hops, symmetric) for r in k2)
    least += sum(pcg_force_bound([int(i) for i in r.iters.tolist()], r.Ltau, r.N, n_colors, n_hops, symmetric)
                 for r in k3)
    spent = sum(k.dur for k in k2_kernels + k3_kernels) / 1e6
    return 100.0 * least / spent
