"""Milliseconds of the radial moves per profiled sweep: the program's
`radial` spans (one walker's move each: the scaled field's f64 action
solve and the Metropolis decision), summed inside the profiled sweeps'
windows, over their number. None for a program without `radial` spans."""

from benchmark.spans import ms_per_sweep


def read(run):
    return ms_per_sweep(run, ("radial",))
