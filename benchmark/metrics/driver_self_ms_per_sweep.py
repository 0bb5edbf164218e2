"""Milliseconds of the driver's own work per profiled sweep: the self time
of the program's `sweep` spans (a batch of `simulate`'s loop, from the
fallback controller's choice to the end of the accumulation), their time
inside the profiled sweeps' windows less the part their `update`,
`refresh` and `measure` children cover: the draws, the controller's host
read, the walker rows and the accumulation."""

from benchmark.spans import self_ms_per_sweep


def read(run):
    return self_ms_per_sweep(run)
