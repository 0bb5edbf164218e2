"""Honeycomb Holstein tutorial through the port (the twin of
examples/holstein_honeycomb.py; the reference's
tutorials/holstein_honeycomb.jl).

Usage: python -m smoqyelphqmc_tpu_torch.examples.holstein_honeycomb <sID> <Omega> <alpha> <mu> <L> <beta>
                                                                   <N_therm> <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

from ..driver import SimulationConfig, run_simulation
from ..io.correlation_ratio import compute_composite_correlation_ratio
from ..io.simulation_info import SimulationInfo, save_simulation_info
from ..models.library import holstein_honeycomb_model, holstein_honeycomb_spec


def setup(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_w{Omega:.2f}_a{alpha:.2f}_mu{mu:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, maxiter=maxiter, seed=seed,
    )
    return sim_info, tbm, em, spec, cfg


def cdw_neighbors(L):
    """The six honeycomb neighbours of Q = 0 that R_cdw compares it with."""
    return [(1, 0), (0, 1), (1, 1), (L - 1, 0), (0, L - 1), (L - 1, L - 1)]


def run(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000, seed=1, filepath=".", device="cuda",
):
    kw = dict(locals())
    device = kw.pop("device")
    sim_info, tbm, em, spec, cfg = setup(**kw)
    metadata = run_simulation(sim_info, tbm, em, spec, cfg, device=device)

    # CDW correlation ratio at Q = 0 with its six honeycomb neighbors
    R, dR = compute_composite_correlation_ratio(
        sim_info.datafolder, "cdw", q_point=(0, 0), q_neighbors=cdw_neighbors(L), spec=spec,
    )
    metadata["Rcdw_mean_real"] = float(R.real)
    metadata["Rcdw_mean_imag"] = float(R.imag)
    metadata["Rcdw_std"] = float(dR)
    save_simulation_info(sim_info, metadata)
    return metadata


def main(argv):
    return run(
        sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]), mu=float(argv[3]),
        L=int(argv[4]), beta=float(argv[5]), N_therm=int(argv[6]),
        N_measurements=int(argv[7]), N_bins=int(argv[8]),
    )


if __name__ == "__main__":
    main(sys.argv[1:])
