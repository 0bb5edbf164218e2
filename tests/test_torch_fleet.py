"""Walker fleets of the PyTorch port (parallel/distributed.py): P real
processes joined by gloo through a file:// store, each running
tests/_torch_fleet_worker.py on the CPU with one torch thread, against one
process with all W walkers (the twins of tests/test_multihost.py).

A fleet must give one process's chains: the same accept flags sweep by
sweep, the same fallback controller choices, records and state, fields
within 1e-10 relative and bins within 1e-6, and on the CPU bit for bit (the
plain versions compute each walker alike at any batch size, and the shared
quantities are computed from the gathered walkers in one process's order).
Each pID's bins are written once, by the process that owns it; rank 0 alone
post-processes; no checkpoint is left behind; a killed and resumed fleet at
k = 2 writes the uninterrupted fleet's bins bit for bit, and its
checkpoints resumed by another number of processes are refused."""

import glob
import json
import os
import pickle
import sys
import time
import uuid

import h5py
import numpy as np
import pytest
import torch

from smoqyelphqmc_tpu_torch.parallel import distributed

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_fleet_worker.py")


def _run(workdir, nproc: int, opts: dict, timeout: float = 300.0):
    """Run nproc workers as one fleet (nproc = 1: one process, no group);
    returns their exit codes and logs by rank. A failed worker ends the
    others."""
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, f"pg-{uuid.uuid4().hex}")
    logs = [os.path.join(workdir, f"log{r}.txt") for r in range(nproc)]
    codes = distributed.spawn_processes(
        [[sys.executable, WORKER, init, str(r), str(nproc), str(workdir), json.dumps(opts)] for r in range(nproc)],
        logs, timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))
    texts = []
    for log in logs:
        with open(log) as f:
            texts.append(f.read())
    return codes, texts


def _launch(workdir, nproc: int, opts: dict, timeout: float = 300.0) -> list:
    """`_run`, any failed worker failing the test; returns the workers'
    reports by rank."""
    codes, logs = _run(workdir, nproc, opts, timeout)
    for r, (code, log) in enumerate(zip(codes, logs)):
        assert code == 0, f"worker {r} of {nproc} failed ({code}):\n{log[-4000:]}"
    reports = []
    for r in range(nproc):
        with open(os.path.join(workdir, f"worker{r}.pkl"), "rb") as f:
            reports.append(pickle.load(f))
    return reports


def _bins(datafolder) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.h5"))):
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: out.__setitem__((os.path.basename(path), name), obj[()])
                         if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_fleet_is_one_process(fleet: list, one: dict, W: int) -> None:
    """Flags and fields after every sweep, the controller, the metadata's
    walker means and the bins of a fleet against one process's."""
    assert [r["owned"] for r in fleet] == [list(distributed.local_walker_ids(W, i, len(fleet)))
                                           for i in range(len(fleet))]
    assert len({r["datafolder"] for r in fleet}) == 1
    for s, flags in enumerate(one["flags"]):
        assert [sum((r["flags"][s][u] for r in fleet), []) for u in range(len(flags))] == flags, s
        x = np.concatenate([r["x"][s] for r in fleet])
        assert np.max(np.abs(x - one["x"][s])) <= 1e-10 * np.max(np.abs(one["x"][s])), s
        np.testing.assert_array_equal(x, one["x"][s])
    for r in fleet:
        assert (r["choices"], r["records"], r["controller"]) == (one["choices"], one["records"], one["controller"])
        for key in ("hmc_acceptance_rate", "reflection_acceptance_rate", "swap_acceptance_rate", "hmc_iters",
                    "measurement_iters", "precond_fallback_sweeps", "all_converged"):
            assert r["metadata"][key] == one["metadata"][key], key
    written = sorted(b for r in fleet for b in r["bins_written"])
    assert written == sorted(one["bins_written"])  # each (pID, bin) once
    for r in fleet:
        assert {p for p, _ in r["bins_written"]} == set(r["owned"])
    assert [r["processed"] for r in fleet] == [1] + [0] * (len(fleet) - 1)
    got, ref = _bins(fleet[0]["datafolder"]), _bins(one["datafolder"])
    assert got.keys() == ref.keys() and ref
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=str(k))
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    folder = fleet[0]["datafolder"]
    assert os.path.exists(os.path.join(folder, "stats.h5"))
    assert glob.glob(os.path.join(folder, "checkpoint_*")) == []


@pytest.mark.parametrize("W,world,blocks", [
    (4, 2, [[0, 1], [2, 3]]), (8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]), (4, 4, [[0], [1], [2], [3]]), (3, 1, [[0, 1, 2]]),
])
def test_local_walker_ids(W, world, blocks):
    assert [list(distributed.local_walker_ids(W, r, world)) for r in range(world)] == blocks


def test_local_walker_ids_uneven_raises():
    with pytest.raises(ValueError, match="multiple of the number of processes"):
        distributed.local_walker_ids(3, 0, 2)


def test_one_process_helpers():
    """Without a process group every helper is the one-process identity."""
    t = torch.arange(6.0).reshape(3, 2)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    distributed.barrier("test")
    assert distributed.gather_walkers(t) is t
    assert distributed.broadcast_object({"a": 1}) == {"a": 1} and distributed.all_gather_object(5) == [5]


def test_spawn_processes_ends_the_rest_when_one_fails(tmp_path):
    """A process that fails ends the others at once; each one's output is in
    its log."""
    t0 = time.time()
    logs = [str(tmp_path / "a.txt"), str(tmp_path / "b.txt")]
    codes = distributed.spawn_processes([[sys.executable, "-c", "print('out'); raise SystemExit(3)"],
                                         [sys.executable, "-c", "import time; time.sleep(120)"]], logs, 100.0)
    assert codes[0] == 3 and codes[1] < 0 and time.time() - t0 < 60
    with open(logs[0]) as f:
        assert f.read() == "out\n"


def test_two_process_fleet_matches_one_process(tmp_path):
    """2 processes x 2 walkers against 1 process x 4 walkers, with per-walker
    mu tuning (the mus gathered for the shared refresh's mean); the fleet
    takes an auto-incremented sID (sID=0, its first folder already taken),
    which rank 0 broadcasts."""
    one = _launch(tmp_path / "one", 1, {})[0]
    os.makedirs(tmp_path / "two" / "fleet-1")
    fleet = _launch(tmp_path / "two", 2, {"sID": 0})
    assert fleet[0]["datafolder"].endswith("fleet-2")
    _assert_fleet_is_one_process(fleet, one, 4)
    mus = {int(w): v for r in fleet for w, v in r["metadata"]["final_mu_per_walker"].items()}
    assert [mus[w] for w in range(4)] == one["metadata"]["final_mu_per_walker"]
    for w in range(4):
        assert os.path.exists(os.path.join(fleet[0]["datafolder"], f"density_tuning_profile_pID-{w}.csv"))


def test_fleet_kill_and_resume_batched(tmp_path):
    """k = 2, no tuning: a fleet stopped by runtime limit 0 after its first
    batch leaves one checkpoint a process; relaunched, it resumes and writes
    the uninterrupted fleet's bins bit for bit."""
    opts = {"tune": False, "k": 2, "therm": 2, "meas": 4, "bins": 2}
    ref = _launch(tmp_path, 2, {**opts, "prefix": "ref"})
    folder = os.path.join(tmp_path, "int-1")
    stopped = _launch(tmp_path, 2, {**opts, "prefix": "int", "runtime": 0.0})
    assert [len(r["flags"]) for r in stopped] == [2, 2] and [r["processed"] for r in stopped] == [0, 0]
    for p in range(2):
        assert glob.glob(os.path.join(folder, f"checkpoint_pID-{p}_slot-*.pkl")), p
    assert not os.path.exists(os.path.join(folder, "stats.h5"))
    resumed = _launch(tmp_path, 2, {**opts, "prefix": "int"})
    assert [len(r["flags"]) for r in resumed] == [4, 4]
    assert os.path.exists(os.path.join(folder, "stats.h5"))
    assert glob.glob(os.path.join(folder, "checkpoint_*")) == []
    got, want = _bins(folder), _bins(ref[0]["datafolder"])
    assert got.keys() == want.keys() and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    for r, s in zip(resumed, stopped):
        assert r["x"][-1].shape == s["x"][-1].shape


def test_fleet_checkpoint_resumed_by_other_process_count_raises(tmp_path):
    """A 2-process fleet's checkpoints (walkers 0-1 and 2-3) resumed by one
    process that owns all four walkers: the run refuses, naming the walkers
    each checkpoint holds, and leaves the checkpoints for a resume with 2."""
    opts = {"tune": False, "k": 2, "therm": 2, "meas": 4, "bins": 2, "prefix": "int"}
    _launch(tmp_path, 2, {**opts, "runtime": 0.0})
    codes, logs = _run(tmp_path, 1, opts)
    assert codes[0] != 0
    assert "ValueError: the checkpoints hold other walkers than the processes now own" in logs[0], logs[0][-4000:]
    assert "{0: [0, 1]}" in logs[0]
    for p in range(2):
        assert glob.glob(os.path.join(tmp_path, "int-1", f"checkpoint_pID-{p}_slot-*.pkl")), p


def test_four_process_fleet(tmp_path):
    """4 processes x 1 walker (the reference's one-rank-one-chain layout)
    against 1 process x 4 walkers: one walker a process still takes the
    batched trajectory of W >= 2 (K3's path), as the W = 4 process does."""
    one = _launch(tmp_path / "one", 1, {"tune": False})[0]
    fleet = _launch(tmp_path / "four", 4, {"tune": False})
    _assert_fleet_is_one_process(fleet, one, 4)
