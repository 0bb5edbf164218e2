"""The port's spans and kernel records (`smoqyelphqmc_tpu_torch.tracing`) on
the CPU, at L=2: the span tree of `simulate` at W = 1 and 2, nothing
recorded without a profiler, the same bins, fields and metadata with tracing
on and off, the refresh and measurement timings as span sums, the fallback
count and the last trajectory in the metadata of a stopped run, the plain
K2 / K3 records, and a profiler event inside a span on the span's clock."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smoqyelphqmc_tpu_torch import tracing
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates, simulate
from smoqyelphqmc_tpu_torch.io.checkpoint import read_checkpoint
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import pcg, pcg_force
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

torch.set_num_threads(2)

WALKERS = [pytest.param(1, id="W1"), pytest.param(2, id="W2")]
TIMINGS = {"t_refresh_s", "t_measurements_s", "t_first_therm_sweep_s", "t_therm_s", "t_first_measured_sweep_s",
           "t_measure_s"}


def _config(W, **kw):
    opts = dict(beta=0.4, dtau=0.1, N_therm=2, N_measurements=3, N_bins=3, Nt=2, Nrv=3, tol=1e-7, seed=21,
                n_walkers=W)
    return SimulationConfig(**{**opts, **kw})


def _model():
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.4, 0.0)
    return tbm, em, holstein_honeycomb_spec(geo)


def _simulate(tmp_path, name, cfg, traced=False, resume=False):
    """simulate to its return, under a CPU profiler with `traced`: (bins,
    metadata, finished, the spans recorded)."""
    tbm, em, spec = _model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix=name, sID=1)
    tracing.clear()
    bins = []
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        gen = simulate(info, tbm, em, spec, cfg, resume=resume, device="cpu")
        while True:
            try:
                bins.append(next(gen))
            except StopIteration as stop:
                md, finished = stop.value
                break
    return info, bins, md, finished, tracing.spans()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("W", WALKERS)
def test_span_tree_of_simulate(tmp_path, W):
    """One `sweep` span a sweep in each phase (k = 1), each with its
    `update` child, and in the measured phase its `refresh` and `measure`
    children in that order; children inherit the phase and the sweep's
    index; every span lies inside its parent."""
    cfg = _config(W)
    *_, spans = _simulate(tmp_path, "tree", cfg, traced=True)
    assert {s.name for s in spans} == {"sweep", "update", "force", "refresh", "measure"}
    sweeps = [i for i, s in enumerate(spans) if s.name == "sweep"]
    assert [(spans[i].ids["phase"], spans[i].ids["sweep"]) for i in sweeps] == (
        [("therm", j) for j in range(cfg.N_therm)] + [("measure", j) for j in range(cfg.N_measurements)])
    for i in sweeps:
        s = spans[i]
        assert s.parent == -1
        children = [c for c in spans if c.parent == i]
        want = ["update"] if s.ids["phase"] == "therm" else ["update", "refresh", "measure"]
        assert [c.name for c in children] == want
        for c in children:
            assert c.ids == s.ids and "walker" not in c.ids
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
            assert 0.0 < c.seconds <= s.seconds
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_nothing_is_recorded_without_a_profiler(tmp_path):
    """Tracing is off without a profiler: no span, no kernel record; the
    timings are still taken; clear() refuses inside an open recorded span."""
    pcg.PCG.records.clear()
    _, _, md, finished, spans = _simulate(tmp_path, "off", _config(2))
    assert finished and spans == [] and pcg.PCG.records == [] and pcg_force.PCG_FORCE.records == []
    assert md["t_refresh_s"] > 0 and md["t_measurements_s"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with pytest.raises(RuntimeError):
                tracing.clear()
    assert [s.name for s in tracing.spans()] == ["outer"]
    tracing.clear()
    assert tracing.spans() == []


@pytest.mark.parametrize("W", WALKERS)
def test_tracing_changes_no_result(tmp_path, W):
    """Bins, the final fields and every metadata key but the timings are
    the same, bit for bit, with tracing on and off."""
    cfg = _config(W, checkpoint_freq_hours=0.0)
    runs = [_simulate(tmp_path / tag, tag, cfg, traced=tag == "on") for tag in ("off", "on")]
    (info0, bins0, md0, fin0, _), (info1, bins1, md1, fin1, spans1) = runs
    assert fin0 and fin1 and spans1
    assert len(bins0) == len(bins1) == cfg.N_bins * W
    for b0, b1 in zip(bins0, bins1):
        assert b0[:-1] == b1[:-1]
        for (k0, v0), (k1, v1) in zip(_leaves(b0[-1]), _leaves(b1[-1])):
            assert k0 == k1
            np.testing.assert_array_equal(v0, v1, err_msg=str(k0))
    x0, x1 = (read_checkpoint(i.datafolder, 0)["state"]["x"] for i in (info0, info1))
    assert torch.equal(torch.as_tensor(x0), torch.as_tensor(x1))
    assert set(md0) == set(md1) and TIMINGS <= set(md0)
    for k in set(md0) - TIMINGS:
        assert md0[k] == md1[k], k


@pytest.mark.parametrize("W", WALKERS)
def test_phase_timings_are_span_sums(tmp_path, W):
    """t_refresh_s and t_measurements_s are the sums, in sweep order, of the
    `refresh` and `measure` spans' seconds."""
    _, _, md, _, spans = _simulate(tmp_path, "sums", _config(W), traced=True)
    for key, name in (("t_refresh_s", "refresh"), ("t_measurements_s", "measure")):
        total = 0.0
        for s in spans:
            if s.name == name:
                total += s.seconds
        assert md[key] == total, key


def test_stopped_run_reports_fallback_count_and_resumes(tmp_path):
    """A run the runtime limit stops reports precond_fallback_sweeps (sweeps
    run walker by walker so far) and hmc_last; resumed to the end, the count
    is the uninterrupted run's."""
    cfg = _config(2, shared_precond=False)
    *_, md_ref, fin, _ = _simulate(tmp_path, "whole", cfg)
    assert fin and md_ref["precond_fallback_sweeps"] == cfg.N_therm + cfg.N_measurements
    stop = dataclasses.replace(cfg, runtime_limit_hours=0.0)
    _, _, md, fin, _ = _simulate(tmp_path, "stopped", stop)
    assert not fin and md["precond_fallback_sweeps"] == 1
    assert set(md["hmc_last"]) == {"delta_H", "accepted", "converged"} and len(md["hmc_last"]["delta_H"]) == 2
    _, _, md, fin, _ = _simulate(tmp_path, "stopped", stop, resume=True)
    assert not fin and md["precond_fallback_sweeps"] == 2
    _, _, md, fin, _ = _simulate(tmp_path, "stopped", cfg, resume=True)
    assert fin and md["precond_fallback_sweeps"] == md_ref["precond_fallback_sweeps"]
    assert md["hmc_last"] == md_ref["hmc_last"]


@pytest.mark.parametrize("W", WALKERS)
def test_hmc_last_is_the_last_trajectory(tmp_path, W):
    """The first thermalization sweep of a stopped simulate is run_updates'
    one sweep: hmc_last holds its Delta H (plain values at W = 1, lists
    over the walkers at W >= 2) with its accept flag and convergence."""
    cfg = _config(W)
    _, _, md, fin, _ = _simulate(tmp_path, "last", dataclasses.replace(cfg, runtime_limit_hours=0.0))
    tbm, em, _ = _model()
    ref = run_updates(tbm, em, cfg, 1, device="cpu")
    last = md["hmc_last"]
    assert not fin
    if W == 1:
        assert last["delta_H"] == ref["hmc_delta_H"][-1]
        assert isinstance(last["accepted"], bool) and last["converged"] is True
    else:
        assert last["delta_H"] == [dh[-1] for dh in ref["hmc_delta_H"]]
        assert all(isinstance(a, bool) for a in last["accepted"]) and last["converged"] == [True, True]


def test_plain_solver_records():
    """Under a profiler, each plain K2 and K3 call records its systems, its
    sizes and the iteration counts it returned (the same tensor)."""
    _, tbm, em = holstein_honeycomb_model(2, 1.0, 0.4, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    elph = ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, device="cpu")
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=True)
    pre = build_spectral(fdm)
    fdm32 = fdm.astype(torch.float32)
    gen = torch.Generator().manual_seed(5)
    L, N = fdm.Ltau, fdm.n_sites
    b = torch.randn((3, L, N), generator=gen).to(torch.float32)
    b = b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)
    bw = torch.randn((2, 2, L, N), generator=gen).to(torch.float32)
    Lam = torch.ones((2, L, N), dtype=torch.float32)
    tracing.clear()
    pcg.pcg_plain(fdm32, pre, b, 1e-5, 500)
    assert pcg.PCG.records == []
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, it2 = pcg.pcg_plain(fdm32, pre, b, 1e-5, 500)
        *_, it3 = pcg_force.pcg_force_plain(fdm32, pre, bw, torch.zeros_like(bw), Lam, 1e-5, 500, True)
    (r2,), (r3,) = pcg.PCG.records, pcg_force.PCG_FORCE.records
    assert (r2.kernel, r2.n_systems, r2.Ltau, r2.N) == ("pcg", 3, L, N) and r2.iters is it2 and int(it2) > 0
    assert (r3.kernel, r3.n_systems, r3.Ltau, r3.N) == ("pcg_force", 4, L, N) and r3.iters is it3
    assert r3.iters.shape == (2,) and bool((it3 > 0).all())
    tracing.clear()
    assert pcg.PCG.records == [] and pcg_force.PCG_FORCE.records == []


def test_profiler_events_inside_a_span_share_its_clock():
    """A CPU operator run inside a span starts and ends, on the profiler's
    clock (kineto's Unix-epoch nanoseconds), between the span's start and
    end (time.time_ns())."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer", phase="measure") as outer:
            torch.ones(1000, dtype=torch.float64).mul_(3.0)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul_"]
    assert len(events) == 1 and tracing.spans() == [outer]
    e = events[0]
    assert outer.start_ns <= e.start_ns() <= e.end_ns() <= outer.end_ns
    assert outer.ids == {"phase": "measure"} and outer.parent == -1
    tracing.clear()
