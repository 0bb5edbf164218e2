"""Milliseconds of the trajectory forces that take the plain route per
profiled sweep: the program's `force` spans (one a kick, every walker the
trajectory runs: the kick's fermion matrix, the K2 solve and the eager
derivative chain) whose `route` id is 'plain', summed inside the profiled
sweeps' windows, over their number. None for a program without `force`
spans, or one whose profiled sweeps took no plain kick."""

from benchmark.trace import clip


def read(run):
    t = run.trace
    if t is None or not t.windows or not t.n_sweeps:
        return None
    try:
        from smoqyelphqmc_tpu_torch import tracing
    except ImportError:
        return None
    plain = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in tracing.spans()
             if s.name == "force" and s.end_ns is not None and getattr(s, "ids", {}).get("route") == "plain"]
    us = sum(e - s for s, e in clip(plain, t.windows))
    return us / 1e3 / t.n_sweeps if us > 0 else None
