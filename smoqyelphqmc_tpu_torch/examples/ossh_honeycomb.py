"""Optical-SSH honeycomb lattice through the port (the twin of examples/ossh_honeycomb.py; the
reference's examples/ossh_honeycomb.jl).

Usage: python -m smoqyelphqmc_tpu_torch.examples.ossh_honeycomb <sID> <Omega> <alpha> <mu> <L> <beta> <N_therm>
                                                  <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

from ..driver import run_simulation
from ..models.library import ossh_honeycomb_model
from ._ssh import ssh_arguments, ssh_setup


def setup(
    sID=1, Omega=1.0, alpha=0.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    return ssh_setup("ossh_honeycomb", ossh_honeycomb_model, True, **locals())


def run(
    sID=1, Omega=1.0, alpha=0.5, mu=0.0, L=3, beta=4.0,
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
