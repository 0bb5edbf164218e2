"""Milliseconds of the update sweep per profiled sweep: the program's
`update` spans (every walker's reflection, swap and HMC trajectory, with
the shared preconditioner refresh at W >= 2), summed inside the profiled
sweeps' windows, over their number."""

from benchmark.spans import ms_per_sweep


def read(run):
    return ms_per_sweep(run, ("update",))
