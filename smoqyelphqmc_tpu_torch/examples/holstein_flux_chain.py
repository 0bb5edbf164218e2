"""Holstein chain threaded by a magnetic flux (complex hopping t e^{i phi/L})
through the port (the twin of examples/holstein_flux_chain.py): complex
hopping amplitudes take the channel-mixing checkerboard and the
doubled-basis spectral preconditioner, and the current correlation is
measured on the chain's bond.

Usage: python -m smoqyelphqmc_tpu_torch.examples.holstein_flux_chain <sID> <Omega> <alpha> <flux> <mu> <L>
                                                   <beta> <N_therm> <N_measurements> <N_bins>
"""

from __future__ import annotations

import sys

import numpy as np

from ..driver import SimulationConfig, run_simulation
from ..io.simulation_info import SimulationInfo
from ..measure.container import MeasurementSpec
from ..models.library import complex_chain_model


def setup(
    sID=1, Omega=1.0, alpha=0.8, flux=0.5, mu=0.0, L=8, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of `run`, without running."""
    phase = 2.0 * np.pi * flux / L  # Peierls phase per bond
    geo, tbm, em = complex_chain_model(L, t=1.0, phase=phase, mu=mu, Omega=Omega, alpha=alpha)

    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("phonon_greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    spec.add_correlation("current", [(tbm.bond_ids[0], tbm.bond_ids[0])], integrated=True)

    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_flux_chain_f{flux:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed,
    )
    return sim_info, tbm, em, spec, cfg


def run(
    sID=1, Omega=1.0, alpha=0.8, flux=0.5, mu=0.0, L=8, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".", device="cuda",
):
    kw = dict(locals())
    device = kw.pop("device")
    return run_simulation(*setup(**kw), device=device)


def main(argv):
    return run(
        sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]), flux=float(argv[3]),
        mu=float(argv[4]), L=int(argv[5]), beta=float(argv[6]),
        N_therm=int(argv[7]), N_measurements=int(argv[8]), N_bins=int(argv[9]),
    )


if __name__ == "__main__":
    main(sys.argv[1:])
