"""Milliseconds of the estimator refresh and the measurement pass per
measured sweep: simulate's (t_refresh_s + t_measurements_s) over the
measured sweeps of the run the window stopped, the first (in set-up) among
them. The profiled sweeps run after it and do not count."""


def read(run):
    md = run.metadata
    return 1e3 * (md["t_refresh_s"] + md["t_measurements_s"]) / run.window.measured
