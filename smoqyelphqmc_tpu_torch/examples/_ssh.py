"""The body the five SSH example twins share (bssh_chain, bssh_square,
ossh_chain, ossh_square, ossh_honeycomb): each builds its model with its
own builder, measures `basic_spec` on the first bond of a chain or on
every bond of a lattice, names its data folder after its example, runs
with radial updates, and reads the same positional command line."""

from __future__ import annotations

from ..driver import SimulationConfig
from ..io.simulation_info import SimulationInfo
from ..models.library import basic_spec


def ssh_setup(name, make_model, every_bond, *, sID, Omega, alpha, mu, L, beta, N_therm, N_measurements, N_bins,
              dtau, Nt, Nrv, tol, seed, filepath):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of the SSH example `name` on make_model's model."""
    geo, tbm, em = make_model(L, Omega, alpha, mu)
    spec = basic_spec(geo, bond_ids=list(tbm.bond_ids) if every_bond else [tbm.bond_ids[0]])
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"{name}_w{Omega:.2f}_a{alpha:.2f}_mu{mu:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed, use_radial_updates=True,
    )
    return sim_info, tbm, em, spec, cfg


def ssh_arguments(argv):
    """`run`'s keywords from the SSH examples' positional command line:
    sID Omega alpha mu L beta N_therm N_measurements N_bins."""
    return dict(sID=int(argv[0]), Omega=float(argv[1]), alpha=float(argv[2]), mu=float(argv[3]),
                L=int(argv[4]), beta=float(argv[5]), N_therm=int(argv[6]), N_measurements=int(argv[7]),
                N_bins=int(argv[8]))
