"""Multi-walker honeycomb Holstein simulation through the port (the twin of
examples/holstein_honeycomb_multiwalker.py; the reference's
tutorials/holstein_honeycomb_mpi.jl).

W independent Markov chains run on one card through `run_simulation` with
`SimulationConfig(n_walkers=W)`, the port's walker path: each walker writes
its own bins tagged by pID, as the reference's MPI ranks write theirs, and
the bins are merged and reduced to statistics at the end. The JAX script's
default of one walker a device becomes W = 8 here (`N_WALKERS`), all on
one card. The reference's MPI form is a fleet of one process a card:

    torchrun --nproc_per_node=<cards> -m smoqyelphqmc_tpu_torch.examples.holstein_honeycomb_multiwalker ...

with W a multiple of the number of processes; each process then joins the
fleet (`parallel.distributed.initialize_distributed`) before it runs.

Usage: python -m smoqyelphqmc_tpu_torch.examples.holstein_honeycomb_multiwalker <sID> <Omega> <alpha> <mu>
                                   <L> <beta> <N_therm> <N_measurements> <N_bins> [<n_walkers>]
"""

from __future__ import annotations

import os
import sys

from ..driver import SimulationConfig, run_simulation
from ..io.simulation_info import SimulationInfo
from ..models.library import holstein_honeycomb_model, holstein_honeycomb_spec
from ..parallel.distributed import initialize_distributed, process_count

# walkers when n_walkers is None: the port's production W on one card
N_WALKERS = 8


def setup(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10, n_walkers=None,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_mw_w{Omega:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements, N_bins=N_bins,
        Nt=Nt, Nrv=Nrv, tol=tol, maxiter=maxiter, seed=seed, n_walkers=n_walkers or N_WALKERS,
    )
    return sim_info, tbm, em, spec, cfg


def run(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10, n_walkers=None,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000, seed=1, filepath=".", device="cuda",
):
    """Runs the W walkers; started by torchrun (WORLD_SIZE > 1), each process
    first joins the fleet and runs its block of the walkers."""
    kw = dict(locals())
    device = kw.pop("device")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and process_count() == 1:
        initialize_distributed()
    sim_info, tbm, em, spec, cfg = setup(**kw)
    metadata = run_simulation(sim_info, tbm, em, spec, cfg, device=device)
    metadata.setdefault("n_walkers", cfg.n_walkers)
    return metadata


def main(argv):
    return run(
        sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]), mu=float(argv[3]),
        L=int(argv[4]), beta=float(argv[5]), N_therm=int(argv[6]),
        N_measurements=int(argv[7]), N_bins=int(argv[8]),
        n_walkers=int(argv[9]) if len(argv) > 9 else None,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
