"""Bond-SSH chain through the port (the twin of examples/bssh_chain.py; the
reference's examples/bssh_chain.jl).

Usage: python -m smoqyelphqmc_tpu_torch.examples.bssh_chain <sID> <Omega> <alpha> <mu> <L> <beta> <N_therm>
                                                  <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

from ..driver import run_simulation
from ..models.library import bssh_chain_model
from ._ssh import ssh_arguments, ssh_setup


def setup(
    sID=1, Omega=1.0, alpha=0.5, mu=0.0, L=16, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    return ssh_setup("bssh_chain", bssh_chain_model, False, **locals())


def run(
    sID=1, Omega=1.0, alpha=0.5, mu=0.0, L=16, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".", device="cuda",
):
    kw = dict(locals())
    device = kw.pop("device")
    return run_simulation(*setup(**kw), device=device)


def main(argv):
    return run(**ssh_arguments(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
