"""Device kernel launches per profiled measured sweep, counted in the trace."""


def read(run):
    t = run.trace
    if t is None or not t.n_sweeps or not t.kernels:
        return None
    return len(t.kernels) / t.n_sweeps
