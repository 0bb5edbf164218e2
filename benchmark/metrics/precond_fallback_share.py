"""Per cent of the sweeps of the window's run (thermalization and measured)
that the fallback controller ran walker by walker: `simulate`'s
`precond_fallback_sweeps` at the runtime limit's stop over the sweeps the
run made."""


def read(run):
    n = run.metadata.get("precond_fallback_sweeps")
    if n is None or not run.sweeps_run:
        return None
    return 100.0 * n / run.sweeps_run
