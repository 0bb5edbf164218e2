"""Honeycomb Holstein with wall-clock-gated checkpointing and a runtime limit
through the port (the twin of examples/holstein_honeycomb_checkpoint.py;
the reference's tutorials/holstein_honeycomb_checkpoint.jl).

Rerun with the same arguments to resume from the latest checkpoint; a
finished simulation deletes its checkpoints.

Usage: python -m smoqyelphqmc_tpu_torch.examples.holstein_honeycomb_checkpoint <sID> <Omega> <alpha> <mu> <L>
                                                  <beta> <N_therm> <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

from ..driver import SimulationConfig, run_simulation
from ..io.simulation_info import SimulationInfo
from ..models.library import holstein_honeycomb_model, holstein_honeycomb_spec


def setup(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    checkpoint_freq_hours=1.0, runtime_limit_hours=11.5,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_cp_w{Omega:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed,
        checkpoint_freq_hours=checkpoint_freq_hours,
        runtime_limit_hours=runtime_limit_hours,
    )
    return sim_info, tbm, em, spec, cfg


def run(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    checkpoint_freq_hours=1.0, runtime_limit_hours=11.5,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".", device="cuda",
):
    kw = dict(locals())
    device = kw.pop("device")
    return run_simulation(*setup(**kw), resume=True, device=device)


def main(argv):
    return run(
        sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]), mu=float(argv[3]),
        L=int(argv[4]), beta=float(argv[5]), N_therm=int(argv[6]),
        N_measurements=int(argv[7]), N_bins=int(argv[8]),
    )


if __name__ == "__main__":
    main(sys.argv[1:])
