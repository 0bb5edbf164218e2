"""CG iterations per HMC solve: simulate's `hmc_iters` sum (each sweep adds
its walker-mean iterations per solve) over the sweeps it ran."""


def read(run):
    return run.metadata["hmc_iters"] / run.sweeps_run
