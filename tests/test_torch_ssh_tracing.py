"""The `radial` and `force` spans (`smoqyelphqmc_tpu_torch.tracing`) on the
CPU: a tiny optical-SSH honeycomb (L=3, beta=2, Nt=8, radial moves on)
under a torch profiler records one `radial` span a walker a sweep inside
its sweep's `update` span, with the walker's index, and one `force` span a
kick whose routes and walker counts are what `tracing.FORCE_ROUTES` counts,
all 'plain' on SSH couplings; nothing without a profiler; the Holstein
honeycomb's kicks take K3 on a shared sweep and the plain chain walker by
walker (`updates.hmc.force_route` on the CPU). No jax import."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smoqyelphqmc_tpu_torch import tracing
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, _expand, _init_chain, simulate
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.models.library import (
    basic_spec,
    holstein_honeycomb_model,
    holstein_honeycomb_spec,
    ossh_honeycomb_model,
    ossh_honeycomb_spec,
)
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, force_route

torch.set_num_threads(2)

NT = 8


def _config(W, **kw):
    opts = dict(beta=2.0, dtau=0.05, N_therm=1, N_measurements=1, N_bins=1, Nt=NT, Nrv=3, seed=17, n_walkers=W,
                use_radial_updates=True)
    return SimulationConfig(**{**opts, **kw})


def _ssh():
    geo, tbm, em = ossh_honeycomb_model(3, 1.0, 0.5, 0.0)
    return tbm, em, ossh_honeycomb_spec(geo, list(tbm.bond_ids))


def _holstein():
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.4, 0.0)
    return tbm, em, holstein_honeycomb_spec(geo)


def _simulate(tmp_path, model, cfg, traced=True):
    """simulate to its return, under a CPU profiler with `traced`:
    (metadata, the evaluations by route this run counted, the spans
    recorded)."""
    tbm, em, spec = model()
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="ssh_spans", sID=1)
    tracing.clear()
    start = dict(tracing.FORCE_ROUTES)
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        gen = simulate(info, tbm, em, spec, cfg, device="cpu")
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                md, finished = stop.value
                break
    assert finished and md["all_converged"]
    return md, tracing.force_routes_since(start), tracing.spans()


def _by_route(spans):
    """The walkers the `force` spans cover, summed by route."""
    out = {"k3": 0, "k4": 0, "plain": 0}
    for s in spans:
        if s.name == "force":
            out[s.ids["route"]] += s.ids["walkers"]
    return out


def test_the_example_measures_basic_spec_on_every_bond():
    geo, tbm, _ = ossh_honeycomb_model(3, 1.0, 0.5, 0.0)
    bonds = list(tbm.bond_ids)
    assert len(bonds) == 3
    assert ossh_honeycomb_spec(geo, bonds) == basic_spec(geo, bonds)


@pytest.mark.parametrize("W", [pytest.param(1, id="W1"), pytest.param(2, id="W2")])
def test_one_radial_span_a_walker_inside_each_update(tmp_path, W):
    """Each `update` span holds one `radial` span a walker, in walker order,
    each with its walker's index and its sweep's phase and index, inside
    the update's time; no radial span elsewhere."""
    cfg = _config(W)
    _, _, spans = _simulate(tmp_path, _ssh, cfg)
    updates = [i for i, s in enumerate(spans) if s.name == "update"]
    assert len(updates) == cfg.N_therm + cfg.N_measurements
    radial = [s for s in spans if s.name == "radial"]
    assert len(radial) == W * len(updates)
    for i in updates:
        u = spans[i]
        children = [s for s in spans if s.parent == i and s.name == "radial"]
        assert [c.ids["walker"] for c in children] == list(range(W))
        for c in children:
            assert c.ids == {**u.ids, "walker": c.ids["walker"]}
            assert u.start_ns <= c.start_ns <= c.end_ns <= u.end_ns and 0.0 < c.seconds <= u.seconds
    assert all(spans[s.parent].name == "update" for s in radial)


@pytest.mark.parametrize("W", [pytest.param(1, id="W1"), pytest.param(2, id="W2")])
def test_ssh_force_spans_are_the_counted_plain_kicks(tmp_path, W):
    """One `force` span a kick inside its `update` span, Nt a trajectory,
    each covering every walker of the trajectory: their walkers by route
    are the run's FORCE_ROUTES increments and its metadata, all 'plain'
    (SSH couplings keep K3 and K4 off)."""
    cfg = _config(W)
    md, counted, spans = _simulate(tmp_path, _ssh, cfg)
    assert counted == md["force_routes"] == _by_route(spans)
    assert counted == {"k3": 0, "k4": 0, "plain": W * NT * (cfg.N_therm + cfg.N_measurements)}
    forces = [s for s in spans if s.name == "force"]
    assert {s.ids["route"] for s in forces} == {"plain"}
    for i, u in enumerate(spans):
        if u.name == "update":
            kicks = [s for s in spans if s.parent == i and s.name == "force"]
            assert sum(s.ids["walkers"] for s in kicks) == W * NT
            assert all(u.start_ns <= s.start_ns <= s.end_ns <= u.end_ns for s in kicks)
    assert all(spans[s.parent].name == "update" for s in forces)


def test_nothing_is_recorded_without_a_profiler(tmp_path):
    """Without a profiler no span is kept, and the kicks are still
    counted."""
    cfg = _config(2)
    md, counted, spans = _simulate(tmp_path, _ssh, cfg, traced=False)
    assert spans == []
    assert counted == md["force_routes"] and counted["plain"] == 2 * NT * (cfg.N_therm + cfg.N_measurements)


@pytest.mark.parametrize("shared,route,walkers", [
    pytest.param(True, "k3", 2, id="shared-k3"),
    pytest.param(False, "plain", 1, id="walker-by-walker-plain"),
])
def test_holstein_force_spans_follow_the_route(tmp_path, shared, route, walkers):
    """A Holstein W=2 run: on a shared sweep every kick is one K3 span of
    both walkers, walker by walker one plain span a walker (K4 needs the
    card), as force_route decides; no radial span without radial moves."""
    cfg = _config(2, beta=0.4, dtau=0.1, Nt=4, use_radial_updates=False, shared_precond=shared)
    tbm, em, _ = _holstein()
    _, ctx, state, _ = _init_chain(*_expand(tbm, em, cfg, torch.device("cpu")), cfg)
    assert force_route(ctx, state.precond, HMCParams(fused_step_force=shared), torch.device("cpu")) == route
    md, counted, spans = _simulate(tmp_path, _holstein, cfg)
    sweeps = cfg.N_therm + cfg.N_measurements
    assert counted == md["force_routes"] == _by_route(spans) == {**{"k3": 0, "k4": 0, "plain": 0},
                                                                 route: 2 * cfg.Nt * sweeps}
    forces = [s for s in spans if s.name == "force"]
    assert len(forces) == 2 * cfg.Nt * sweeps // walkers
    assert {(s.ids["route"], s.ids["walkers"]) for s in forces} == {(route, walkers)}
    assert not any(s.name == "radial" for s in spans)
