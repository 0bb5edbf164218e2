"""Simulation bookkeeping: data folders, TOML model summaries, metadata (a
copy of the JAX package's io/simulation_info.py, which the port cannot import
without importing jax).

Covers the capability surface of SmoQyDQMC's SimulationInfo /
initialize_datafolder / model_summary / save_simulation_info as used by the
reference tutorials (tutorials/holstein_honeycomb.jl:89-97,278-284,713).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class SimulationInfo:
    """Names and locates a simulation run. `sID` distinguishes repeated runs,
    `pID` distinguishes parallel walkers (the MPI-rank analogue)."""

    filepath: str = "."
    datafolder_prefix: str = "simulation"
    sID: int = 0
    pID: int = 0
    write_bins_concurrent: bool = True

    def __post_init__(self):
        if self.sID == 0:
            # find first unused sID (mirrors the reference's auto-increment)
            sid = 1
            while os.path.isdir(os.path.join(self.filepath, f"{self.datafolder_prefix}-{sid}")):
                sid += 1
            self.sID = sid

    @property
    def datafolder_name(self) -> str:
        return f"{self.datafolder_prefix}-{self.sID}"

    @property
    def datafolder(self) -> str:
        return os.path.join(self.filepath, self.datafolder_name)

    @property
    def bins_folder(self) -> str:
        return os.path.join(self.datafolder, "bins")

    def with_pID(self, pID: int) -> "SimulationInfo":
        """Clone pointing at the same datafolder but tagged for another walker."""
        return dataclasses.replace(self, pID=pID, sID=self.sID)


def initialize_datafolder(sim_info: SimulationInfo) -> None:
    os.makedirs(sim_info.datafolder, exist_ok=True)
    os.makedirs(sim_info.bins_folder, exist_ok=True)


def _toml_value(v: Any) -> str:
    import numpy as np

    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, complex):
        return f'"{v!r}"'
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return f'"{v}"'


def _write_toml(path: str, tree: Dict[str, Any]) -> None:
    """Minimal TOML writer: nested dicts become [a.b] tables; lists of dicts
    become [[a.b]] array tables."""

    def emit(d: Dict[str, Any], prefix: str, out: list) -> None:
        scalars = {k: v for k, v in d.items() if not isinstance(v, (dict, list)) or (
            isinstance(v, list) and not (v and isinstance(v[0], dict))
        )}
        tables = {k: v for k, v in d.items() if isinstance(v, dict)}
        array_tables = {
            k: v for k, v in d.items() if isinstance(v, list) and v and isinstance(v[0], dict)
        }
        if prefix and scalars:
            out.append(f"[{prefix}]")
        for k, v in scalars.items():
            out.append(f"{k} = {_toml_value(v)}")
        if scalars:
            out.append("")
        for k, v in tables.items():
            emit(v, f"{prefix}.{k}" if prefix else k, out)
        for k, lst in array_tables.items():
            name = f"{prefix}.{k}" if prefix else k
            for item in lst:
                out.append(f"[[{name}]]")
                for kk, vv in item.items():
                    if isinstance(vv, dict):
                        raise ValueError("nested dict inside array table not supported")
                    out.append(f"{kk} = {_toml_value(vv)}")
                out.append("")

    lines: list = []
    emit(tree, "", lines)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def model_summary(
    sim_info: SimulationInfo,
    beta: float,
    dtau: float,
    model_geometry,
    tight_binding_model,
    interactions=(),
) -> str:
    """Write model_summary.toml fully specifying the simulated Hamiltonian
    (model_summary, used at tutorials/holstein_honeycomb.jl:278-284)."""
    geo = model_geometry
    tree: Dict[str, Any] = {
        "beta": beta,
        "dtau": dtau,
        "Ltau": int(round(beta / dtau)),
        "geometry": {
            "dimensions": geo.n_dim,
            "orbitals_per_unit_cell": geo.n_orbitals,
            "lattice_vectors": [list(v) for v in geo.unit_cell.lattice_vecs],
            "basis_vectors": [list(v) for v in geo.unit_cell.basis_vecs],
            "L": list(geo.lattice.L),
            "periodic": list(geo.lattice.periodic),
            "n_sites": geo.n_sites,
        },
        "tight_binding": {
            "mu": tight_binding_model.mu,
            "eps_mean": list(tight_binding_model.eps_mean),
            "hoppings": [
                {
                    "orbitals": list(b.orbitals),
                    "displacement": list(b.displacement),
                    "t_mean": complex(t).real if complex(t).imag == 0 else str(t),
                }
                for b, t in zip(tight_binding_model.t_bonds, tight_binding_model.t_mean)
            ],
        },
    }
    for interaction in interactions:
        phonons = [
            {
                "basis_vec": list(p.basis_vec),
                "Omega_mean": p.Omega_mean,
                "Omega_std": p.Omega_std,
                "M": p.M,
                "Omega4_mean": p.Omega4_mean,
            }
            for p in interaction.phonon_modes
        ]
        holsteins = [
            {
                "phonon_id": h.phonon_id,
                "orbital_id": h.orbital_id,
                "displacement": list(h.displacement),
                "alpha_mean": h.alpha_mean,
                "alpha2_mean": h.alpha2_mean,
                "alpha3_mean": h.alpha3_mean,
                "alpha4_mean": h.alpha4_mean,
                "ph_sym_form": h.ph_sym_form,
            }
            for h in interaction.holstein_couplings
        ]
        sshs = [
            {
                "phonon_ids": list(s.phonon_ids),
                "bond_orbitals": list(s.bond.orbitals),
                "bond_displacement": list(s.bond.displacement),
                "alpha_mean": complex(s.alpha_mean).real,
                "alpha2_mean": complex(s.alpha2_mean).real,
                "alpha3_mean": complex(s.alpha3_mean).real,
                "alpha4_mean": complex(s.alpha4_mean).real,
            }
            for s in interaction.ssh_couplings
        ]
        disps = [
            {
                "phonon_ids": list(d.phonon_ids),
                "displacement": list(d.displacement),
                "Omega_mean": d.Omega_mean,
                "Omega4_mean": d.Omega4_mean,
            }
            for d in interaction.dispersion_couplings
        ]
        tree["electron_phonon"] = {
            "phonon_modes": phonons,
            "holstein_couplings": holsteins,
            "ssh_couplings": sshs,
            "dispersion_couplings": disps,
        }
    path = os.path.join(sim_info.datafolder, "model_summary.toml")
    _write_toml(path, tree)
    return path


def save_simulation_info(sim_info: SimulationInfo, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write simulation_info.toml with run metadata (save_simulation_info)."""
    tree: Dict[str, Any] = {
        "datafolder": sim_info.datafolder_name,
        "sID": sim_info.sID,
        "pID": sim_info.pID,
    }
    if metadata:
        tree["metadata"] = {str(k): v for k, v in metadata.items()}
    path = os.path.join(sim_info.datafolder, f"simulation_info_pID-{sim_info.pID}.toml")
    _write_toml(path, tree)
    return path


def rename_complete_simulation(sim_info: SimulationInfo, delete_checkpoints: bool = True) -> str:
    """Mark a finished simulation by renaming its folder with a '-complete'
    suffix (rename_complete_simulation, used at
    tutorials/holstein_honeycomb_checkpoint.jl:693-700)."""
    if delete_checkpoints:
        from .checkpoint import delete_checkpoints as _del

        _del(sim_info.datafolder)
    target = sim_info.datafolder + "-complete"
    os.rename(sim_info.datafolder, target)
    return target


def save_density_tuning_profile(sim_info: SimulationInfo, history) -> str:
    """Write the chemical-potential tuning trajectory (save_density_tuning_profile,
    tutorials/holstein_honeycomb_density_tuning.jl:677): one row
    per tuner update with (step, mu, n, Nsqrd)."""
    import numpy as np

    path = os.path.join(sim_info.datafolder, f"density_tuning_profile_pID-{sim_info.pID}.csv")
    with open(path, "w") as f:
        f.write("step mu n Nsqrd\n")
        for k, (mu, n, N2) in enumerate(history):
            # entries may be lazy device scalars; force to host floats here
            f.write(
                f"{k} {float(np.asarray(mu))!r} {float(np.asarray(n))!r} "
                f"{float(np.asarray(N2))!r}\n"
            )
    return path
