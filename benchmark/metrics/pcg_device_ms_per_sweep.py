"""Device milliseconds per profiled sweep of kernels K2 (`pcg_kernel`) and
K3 (`pcg_force_kernel`)."""


def read(run):
    t = run.trace
    if t is None or not t.n_sweeps:
        return None
    us = t.family_us("pcg_kernel") + t.family_us("pcg_force_kernel")
    return us / 1e3 / t.n_sweeps if us > 0 else None
