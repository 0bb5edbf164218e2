"""The multiwalker twin (smoqyelphqmc_tpu_torch.examples.
holstein_honeycomb_multiwalker) as a fleet: 2 processes on the CPU with
torchrun's environment, each joining the gloo group through the twin
itself, at tests/test_examples.py's tiny sizes with W = 2 (one walker a
process); the merged binned_data.h5 must equal one process's bit for bit,
as the port's fleets do on the CPU (tests/test_torch_fleet.py)."""

import glob
import json
import os
import socket
import sys

import numpy as np

from _torch_examples import h5_datasets, tiny

from smoqyelphqmc_tpu_torch.parallel import distributed

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_examples_fleet_worker.py")
FLEET_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(workdir, nproc: int, kw: dict) -> None:
    """nproc workers of the twin's run through distributed.spawn_processes
    (nproc = 1: one process, no fleet environment); every worker must
    finish with every solve converged, in a fleet of nproc processes."""
    env = {k: v for k, v in os.environ.items() if k not in FLEET_ENV}
    env["OMP_NUM_THREADS"] = "1"
    if nproc > 1:
        env.update(WORLD_SIZE=str(nproc), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    logs = [os.path.join(workdir, f"log{r}.txt") for r in range(nproc)]
    codes = distributed.spawn_processes([[sys.executable, WORKER, str(r), json.dumps(kw)] for r in range(nproc)],
                                        logs, 300.0, env=env)
    for r, (code, log) in enumerate(zip(codes, logs)):
        with open(log) as f:
            text = f.read()
        assert code == 0, f"worker {r} of {nproc} failed ({code}):\n{text[-4000:]}"
        assert json.loads(text.strip().splitlines()[-1]) == {"n_walkers": kw["n_walkers"], "all_converged": True,
                                                             "processes": nproc}


def test_multiwalker_twin_fleet_is_one_process(tmp_path):
    runs = {}
    for nproc in (1, 2):
        workdir = tmp_path / f"p{nproc}"
        os.makedirs(workdir)
        _launch(str(workdir), nproc, tiny("holstein_honeycomb_multiwalker", workdir / "out"))
        (folder,) = glob.glob(str(workdir / "out" / "*"))
        assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(folder, "bins", "*.h5"))) == [
            f"bin-{b}_pID-{w}.h5" for b in range(2) for w in range(2)]
        assert glob.glob(os.path.join(folder, "simulation_info_pID-*.toml")) == [
            os.path.join(folder, "simulation_info_pID-0.toml")]
        assert glob.glob(os.path.join(folder, "checkpoint*")) == []
        runs[nproc] = h5_datasets(os.path.join(folder, "binned_data.h5"))
    assert runs[2].keys() == runs[1].keys() and runs[1]
    for k, v in runs[1].items():
        np.testing.assert_array_equal(runs[2][k], v, err_msg=k)
