"""Sweep batching in the PyTorch port (SimulationConfig.sweeps_per_dispatch):
the absolute-grid partition against the JAX driver's own `_batch`, the
measured simulation and the update sweeps at k > 1 against k = 1 (the twins
of tests/test_driver.py's batching tests), the fallback controller against
the JAX package's under per-batch recording, and resume at k = 2.

Tolerances: at W = 1 the bins of k = 4 equal k = 1's bit for bit (the port
runs the same sweeps eagerly, in the same order; only the bookkeeping moves
to batch ends); at W = 2 the accept flags are equal and the bins held to
5e-6, the JAX test's bound (they come out equal); resumed runs repeat the
uninterrupted run's bins bit for bit."""

import ast
import dataclasses
import glob
import os
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from _torch_models import port_honeycomb_model
from smoqyelphqmc_tpu.parallel.walkers import PrecondFallbackController as JaxController
from smoqyelphqmc_tpu_torch import driver
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_simulation, run_updates
from smoqyelphqmc_tpu_torch.io.checkpoint import read_checkpoint
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.measure.container import MeasurementSpec
from smoqyelphqmc_tpu_torch.parallel.walkers import PrecondFallbackController

torch.set_num_threads(2)

JAX_DRIVER = Path(__file__).resolve().parents[1] / "smoqyelphqmc_tpu" / "driver.py"


def _jax_batch(where: str, k_disp: int):
    """The JAX driver's `_batch`, nested in its function `where`, compiled
    from the driver's source and closed over k_disp."""
    tree = ast.parse(JAX_DRIVER.read_text())
    outer = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == where)
    inner = next(n for n in ast.walk(outer) if isinstance(n, ast.FunctionDef) and n.name == "_batch")
    ns = {"k_disp": k_disp}
    exec(compile(ast.Module(body=[inner], type_ignores=[]), str(JAX_DRIVER), "exec"), ns)
    return ns["_batch"]


def _partition(batch, n_therm: int, n_meas: int, bin_size: int) -> list:
    """(phase, start, k) of every batch of a run, as the drivers' loops cut it."""
    out, done = [], 0
    while done < n_therm:
        k = batch(done, n_therm)
        out.append(("therm", done, k))
        done += k
    done = 0
    while done < n_meas:
        k = batch(done, n_meas, done + bin_size - done % bin_size)
        out.append(("measure", done, k))
        done += k
    return out


@pytest.mark.parametrize("where", ["run_simulation", "_run_multiwalker"])
@pytest.mark.parametrize("k_disp", [1, 2, 3, 4])
@pytest.mark.parametrize("n_therm,n_meas,n_bins", [(3, 6, 2), (5, 12, 3), (0, 7, 2)])
def test_batch_partition_matches_jax(where, k_disp, n_therm, n_meas, n_bins):
    bin_size = max(n_meas // n_bins, 1)
    jax_part = _partition(_jax_batch(where, k_disp), n_therm, n_meas, bin_size)
    port_part = _partition(lambda done, *ends: driver._batch(done, k_disp, *ends), n_therm, n_meas, bin_size)
    assert port_part == jax_part
    assert sum(k for p, _, k in port_part if p == "measure") == n_meas
    # no measured batch straddles a bin end
    assert all((s // bin_size) == ((s + k - 1) // bin_size) for p, s, k in port_part if p == "measure")


def _spec(geo) -> MeasurementSpec:
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    spec.add_correlation("phonon_greens", [(0, 0)], time_displaced=True)
    return spec


def _h5_tree(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj)) if isinstance(obj, h5py.Dataset)
                     else None)
    return out


class _Spy:
    """Records the accept flags of every walker sweep and the size of every
    batch the driver runs."""

    def __enter__(self):
        self.flags, self.ks = [], []
        self._orig = (driver.walker_sweep, driver._Chains.batch)
        walkers, batch = self._orig

        def spy_walkers(*args, **kw):
            states, st = walkers(*args, **kw)
            self.flags.append(tuple(tuple(bool(u.accepted) for u in ups) for ups in st))
            return states, st

        def spy_batch(chains, k, *args, **kw):
            self.ks.append(k)
            return batch(chains, k, *args, **kw)

        driver.walker_sweep, driver._Chains.batch = spy_walkers, spy_batch
        return self

    def __exit__(self, *exc):
        driver.walker_sweep, driver._Chains.batch = self._orig


def _model():
    geo, tbm, _tbp, em, _elph = port_honeycomb_model(L=2, beta=0.5, dtau=0.1, alpha=0.5)
    return tbm, em, _spec(geo)


def _config(**kw) -> SimulationConfig:
    opts = dict(beta=0.5, dtau=0.1, N_therm=3, N_measurements=6, N_bins=2, Nt=4, Nrv=4, tol=1e-8, seed=11)
    return SimulationConfig(**{**opts, **kw})


def _run(tmp_path, prefix, **cfg_kw):
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix=prefix, sID=1)
    with _Spy() as spy:
        md = run_simulation(info, *_model(), _config(**cfg_kw), device="cpu")
    return info, md, spy


def test_batched_simulation_w1_is_bit_identical(tmp_path):
    """k = 4 at W = 1: the batches cut on the grid (3 | 3, 1, 2: the first
    measured batch min(k, bin size) = 3), the same flags, the bins bit for
    bit."""
    runs = {k: _run(tmp_path, f"k{k}", sweeps_per_dispatch=k) for k in (1, 4)}
    (info1, md1, spy1), (info4, md4, spy4) = runs[1], runs[4]
    assert (md1["n_first_therm_batch"], md1["n_first_measured_batch"]) == (1, 1)
    assert (md4["n_first_therm_batch"], md4["n_first_measured_batch"]) == (3, 3)
    assert spy4.ks == [k for _, _, k in _partition(lambda d, *e: driver._batch(d, 4, *e), 3, 6, 3)] == [3, 3, 1, 2]
    assert spy1.flags == spy4.flags and len(spy4.flags) == 9
    for key in ("hmc_acceptance_rate", "hmc_iters", "reflection_iters", "swap_iters", "measurement_iters"):
        assert md1[key] == md4[key], key
    t1, t4 = (_h5_tree(os.path.join(i.datafolder, "binned_data.h5")) for i in (info1, info4))
    assert t1.keys() == t4.keys()
    for name in t1:
        np.testing.assert_array_equal(t4[name], t1[name], err_msg=name)


def test_batched_simulation_walkers(tmp_path):
    """k = 3 at W = 2 (the twin of the JAX multiwalker test): the same
    accept flags, bins within 5e-6, the controller recording once a batch."""
    records = []
    record = PrecondFallbackController.record

    def spy_record(self, iters, used_shared):
        records.append((iters, used_shared))
        return record(self, iters, used_shared)

    PrecondFallbackController.record = spy_record
    try:
        runs = {k: _run(tmp_path, f"k{k}", n_walkers=2, sweeps_per_dispatch=k) for k in (1, 3)}
    finally:
        PrecondFallbackController.record = record
    (info1, md1, spy1), (info3, md3, spy3) = runs[1], runs[3]
    assert spy3.ks == [3, 3, 3] and len(records) == 9 + 3
    assert spy1.flags == spy3.flags
    assert md1["hmc_acceptance_rate"] == md3["hmc_acceptance_rate"]
    assert md3["n_first_measured_batch"] == 3 and md3["precond_fallback_sweeps"] == 0
    for pid in (0, 1):
        t1, t3 = (_h5_tree(os.path.join(i.with_pID(pid).datafolder, "binned_data.h5")) for i in (info1, info3))
        assert t1.keys() == t3.keys()
        for name in t1:
            np.testing.assert_allclose(t3[name], t1[name], rtol=5e-6, atol=5e-6, err_msg=name)


def test_fallback_counts_sweeps_and_controller_counts_batches(tmp_path):
    """Per-walker refresh throughout (shared_precond=False) at k = 3: the
    driver's fallback count (precond_fallback_sweeps) counts sweeps, the
    controller's own fallback_sweeps batches, as the JAX package's do."""
    kw = dict(n_walkers=2, sweeps_per_dispatch=3, shared_precond=False)
    # stopped after its first batch: the checkpoint holds both counts
    info, _, spy = _run(tmp_path, "stopped", **kw, checkpoint_freq_hours=0.0, runtime_limit_hours=0.0)
    state = read_checkpoint(info.datafolder, 0)["state"]
    assert spy.ks == [3] and state["fallback"] == 3 and state["controller"]["fallback_sweeps"] == 1
    _, md, spy = _run(tmp_path, "full", **kw)
    assert spy.ks == [3, 3, 3] and md["precond_fallback_sweeps"] == 9


@pytest.mark.parametrize("ratio,retry_every", [(1.5, 3), (1.2, 1), (1.5, 32)])
def test_controller_matches_jax(ratio, retry_every):
    """The port's controller and the JAX package's, fed the same per-batch
    iteration counts (spikes to per-walker mode, probes, a NaN and a zero
    that must be ignored), choose alike and end in the same state."""
    rng = np.random.default_rng(7)
    its = list(10.0 + rng.random(40)) + [40.0, 12.0, float("nan"), 0.0, 35.0, 9.5, 9.6] + list(9.0 + rng.random(20))
    port, jax_c = PrecondFallbackController(ratio, retry_every), JaxController(ratio, retry_every)
    choices = []
    for it in its:
        c = port.choose()
        assert c == jax_c.choose()
        choices.append(c)
        port.record(it, c)
        jax_c.record(it, c)
    assert port.state_dict() == jax_c.state_dict()
    # the spikes demote the refresh to per walker, except where every batch probes
    assert all(choices) == (retry_every == 1)


@pytest.mark.parametrize("W", [1, 2])
def test_batched_resume_is_bit_identical(tmp_path, W):
    """k = 2: interrupted after every batch (runtime limit 0) and resumed to
    the end, the run writes the uninterrupted run's bins bit for bit."""
    tbm, em, spec = _model()
    cfg = _config(N_measurements=4, n_walkers=W, sweeps_per_dispatch=2, checkpoint_freq_hours=0.0)
    ref = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="ref", sID=1)
    run_simulation(ref, tbm, em, spec, cfg, device="cpu")
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="int", sID=1)
    stop = dataclasses.replace(cfg, runtime_limit_hours=0.0)
    n_runs = 0
    while not os.path.exists(os.path.join(info.datafolder, "stats.h5")):
        run_simulation(info, tbm, em, spec, stop, device="cpu")
        n_runs += 1
        assert n_runs <= 5
    assert n_runs == 4  # batches 2 + 1 (thermalization), 2 + 2 (measured, the last one finishes)
    assert not glob.glob(os.path.join(info.datafolder, "checkpoint_*"))
    for pid in range(W):
        a, b = (_h5_tree(os.path.join(i.with_pID(pid).datafolder, "binned_data.h5")) for i in (ref, info))
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)


@pytest.mark.parametrize("W", [1, 2])
def test_batched_updates_match(W):
    """run_updates partitions its sweeps on the same grid: 4 sweeps at k = 3
    (batches 3 + 1) end at k = 1's fields with k = 1's statistics."""
    tbm, em, _ = _model()
    cfg = SimulationConfig(beta=0.5, dtau=0.1, Nt=4, tol=1e-8, seed=11, n_walkers=W, target_acceptance=0.6)
    md1 = run_updates(tbm, em, cfg, 4, device="cpu")
    md3 = run_updates(tbm, em, dataclasses.replace(cfg, sweeps_per_dispatch=3), 4, device="cpu")
    assert torch.equal(md1["x_final"], md3["x_final"])
    assert len(md3["sweep_s"]) == 4 and md1["hmc_delta_H"] == md3["hmc_delta_H"]
    for key in ("hmc_acceptance_rate", "hmc_iters", "hmc_dt_final"):
        assert md1[key] == md3[key], key
