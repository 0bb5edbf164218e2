"""Per cent of the program's `refresh` and `measure` spans (the estimator
refresh and the measurement pass, inside the profiled sweeps' windows) in
which no kernel, copy or set ran on the device."""

from benchmark.spans import idle_share


def read(run):
    return idle_share(run, ("refresh", "measure"))
