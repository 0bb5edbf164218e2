"""Honeycomb Holstein with chemical-potential tuning to a target density
through the port (the twin of examples/holstein_honeycomb_density_tuning.py;
the reference's tutorials/holstein_honeycomb_density_tuning.jl).

Usage: python -m smoqyelphqmc_tpu_torch.examples.holstein_honeycomb_density_tuning <sID> <Omega> <alpha>
                                                  <n_target> <L> <beta> <N_therm> <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

from ..driver import SimulationConfig, run_simulation
from ..io.simulation_info import SimulationInfo
from ..models.library import holstein_honeycomb_model, holstein_honeycomb_spec


def setup(
    sID=1, Omega=1.0, alpha=1.5, n_target=1.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu=0.0)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_n{n_target:.2f}_w{Omega:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed,
        target_density=n_target,
    )
    return sim_info, tbm, em, spec, cfg


def run(
    sID=1, Omega=1.0, alpha=1.5, n_target=1.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".", device="cuda",
):
    kw = dict(locals())
    device = kw.pop("device")
    return run_simulation(*setup(**kw), device=device)


def main(argv):
    return run(
        sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]),
        n_target=float(argv[3]), L=int(argv[4]), beta=float(argv[5]),
        N_therm=int(argv[6]), N_measurements=int(argv[7]), N_bins=int(argv[8]),
    )


if __name__ == "__main__":
    main(sys.argv[1:])
