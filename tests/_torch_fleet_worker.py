"""One process of a walker fleet of the PyTorch port, for tests/test_torch_fleet.py.

    python _torch_fleet_worker.py <init file> <rank> <world> <workdir> [json opts]

Each process joins a gloo process group through a file:// store (world 1:
no group, the single-process reference), runs `driver.run_simulation` on
the CPU with one torch thread on the chain of tests/_models.py (L=4,
beta=0.4, W walkers) and writes `worker<rank>.pkl` into workdir: its owned
walkers, metadata, the accept flags and fields after every sweep (the
driver's walker_sweep spied), the fallback controller's choices, records and
last state, the bins it wrote and how often it post-processed.

json opts (all optional): "W" walkers (4), "therm" / "meas" / "bins" (1, 2,
2), "k" sweeps_per_dispatch (1), "tune" per-walker mu tuning (true),
"runtime" runtime_limit_hours (inf; 0.0 stops after the first batch),
"prefix" the data folder's prefix ("fleet"), "sID" (1; 0 takes the
auto-increment, which rank 0 broadcasts).
"""

import json
import os
import pickle
import sys


def main() -> None:
    init_file, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    opts = json.loads(sys.argv[5]) if len(sys.argv) > 5 else {}
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(tests_dir))
    sys.path.insert(0, tests_dir)

    import torch

    torch.set_num_threads(1)
    from _torch_models import port_chain_model
    from smoqyelphqmc_tpu_torch import driver
    from smoqyelphqmc_tpu_torch.io import measurements_io
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.measure.container import MeasurementSpec
    from smoqyelphqmc_tpu_torch.parallel import distributed
    from smoqyelphqmc_tpu_torch.parallel.walkers import PrecondFallbackController

    if world > 1:
        distributed.initialize_distributed(f"file://{init_file}", world, rank)

    report = {"rank": rank, "flags": [], "x": [], "choices": [], "records": [], "controller": None,
              "bins_written": [], "processed": 0}
    sweep_fn, choose, record, state_dict = (driver.walker_sweep, PrecondFallbackController.choose,
                                            PrecondFallbackController.record, PrecondFallbackController.state_dict)
    write_bin, process = measurements_io.write_measurement_bin, measurements_io.process_measurements

    def spy_sweep(*args, **kw):
        states, st = sweep_fn(*args, **kw)
        report["flags"].append([[bool(u.accepted) for u in ups] for ups in st])
        report["x"].append(states.x.numpy().copy())
        return states, st

    def spy_choose(self):
        report["choices"].append(choose(self))
        return report["choices"][-1]

    def spy_record(self, iters, used_shared):
        report["records"].append((float(iters), bool(used_shared)))
        return record(self, iters, used_shared)

    def spy_state_dict(self):
        report["controller"] = state_dict(self)
        return report["controller"]

    def spy_write_bin(info, b, tree, *args, **kw):
        report["bins_written"].append((info.pID, b))
        return write_bin(info, b, tree, *args, **kw)

    def spy_process(*args, **kw):
        report["processed"] += 1
        return process(*args, **kw)

    driver.walker_sweep = spy_sweep
    PrecondFallbackController.choose, PrecondFallbackController.record = spy_choose, spy_record
    PrecondFallbackController.state_dict = spy_state_dict
    measurements_io.write_measurement_bin, measurements_io.process_measurements = spy_write_bin, spy_process

    geo, tbm, _tbp, em, _elph = port_chain_model(L=4, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])
    W = int(opts.get("W", 4))
    cfg = driver.SimulationConfig(
        beta=0.4, dtau=0.1, N_therm=int(opts.get("therm", 1)), N_measurements=int(opts.get("meas", 2)),
        N_bins=int(opts.get("bins", 2)), Nt=2, Nrv=2, tol=1e-7, seed=3, n_walkers=W,
        target_density=1.0 if opts.get("tune", True) else None, checkpoint_freq_hours=0.0,
        runtime_limit_hours=float(opts.get("runtime", float("inf"))), sweeps_per_dispatch=int(opts.get("k", 1)),
    )
    info = SimulationInfo(filepath=workdir, datafolder_prefix=opts.get("prefix", "fleet"), sID=int(opts.get("sID", 1)))
    md = driver.run_simulation(info, tbm, em, spec, cfg, device="cpu")
    report.update(owned=list(distributed.local_walker_ids(W)), datafolder=info.datafolder,
                  metadata={k: v for k, v in md.items() if not k.startswith("t_")})
    with open(os.path.join(workdir, f"worker{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)


if __name__ == "__main__":
    main()
