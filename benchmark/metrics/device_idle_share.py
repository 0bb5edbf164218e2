"""Per cent of the profiled sweeps' span in which no kernel, copy or set
ran on the device: 1 minus the union of device activity over the union of
the sweeps' ranges."""


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
