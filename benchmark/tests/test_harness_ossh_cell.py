"""The optical-SSH honeycomb cell `ossh_honeycomb_l12_w8`: found by name with
the example's model, measurement set, radial moves, limits and band; its
configuration cut to L=3, beta=2, Nt=8 with four walkers runs `correct`
through `run_cell` on the CPU, and a traced run gives its span readers
something to read; the three readers new with the cell against hand counts
on synthetic spans and kernel lists, None on a program without their spans
or shapes."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import roofline
from benchmark.harness import HERE, Cell, LayerRun, build, run_cell
from benchmark.reference import greedy_colors
from benchmark.references.ossh_honeycomb import build as build_reference
from benchmark.run import read_layer_metric
from benchmark.trace import Kernel, Trace
from smoqyelphqmc_tpu_torch import tracing

NAME = "ossh_honeycomb_l12_w8"
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
READERS = ("plain_force_ms_per_sweep", "radial_ms_per_sweep", "k1_ssh_roofline_share")


@pytest.fixture
def small_cell():
    """The registered cell with its configuration cut to L=3, beta=2, Nt=8
    and four walkers, one thermalization sweep: its limits and band."""
    cell = Cell.load(NAME)
    return Cell("small_ossh", dict(cell.spec), dict(cell.config, L=3, beta=2.0, Nt=8),
                dict(cell.traffic, n_walkers=4, N_therm=1))


def test_the_cell_loads_the_example():
    cell = Cell.load(NAME)
    c = cell.config
    assert (c["model"], c["spec"], c["use_radial_updates"]) == ("ossh_honeycomb", "basic_spec", True)
    assert (c["L"], c["Omega"], c["alpha"], c["mu"], c["t"], c["beta"], c["dtau"], c["Nt"]) == (
        12, 1.0, 0.5, 0.0, 1.0, 4.0, 0.05, 24)
    assert (c["tol"], c["Nrv"], c["force_dtype"], c["measurement_dtype"]) == (1e-10, 10, "float32", "float32")
    assert c["changed_from_source"] == {"L": [3, 12]} and set(c["assumed"]) == {"L"}
    assert cell.spec["limits"] == {"field_gap": 0.005, "measure_gap": 0.001} and cell.spec["dH_band"] == 0.1
    assert cell.spec["trace_sweeps"] == 2  # with 4, a traced run took 295-303 s on an H100, near its 360 s
    s = cell.settings()
    assert s.radial and not s.kpm and s.Ltau == 80 and cell.n_walkers == 8


def test_benchmark_json_and_the_files_agree():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == NAME]
    cell = Cell.load(NAME)
    assert (w["config"], w["traffic"], w["chips"]) == (cell.spec["config"], cell.spec["traffic"], 1)
    (c,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == ["L"] and c["source"] == cell.config["source"]
    assert c["file"] == f"benchmark/configs/{w['config']}.json"
    for name in READERS:
        (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert m["workloads"] == [NAME] and m["moves"] == "walker_sweeps_per_s"


def test_the_configuration_builds_the_example(tmp_path):
    """Every bond measured (bond and current correlations on the three
    bonds), radial moves on, the tau-dependent hop tables on Ltau rows (the
    rows the K1 reader prices)."""
    from smoqyelphqmc_tpu_torch.driver import _expand, _init_chain
    from smoqyelphqmc_tpu_torch.ops.mtm import mtm_tables
    from smoqyelphqmc_tpu_torch.updates.context import make_fdm

    cell = Cell.load(NAME)
    cell = Cell(NAME, cell.spec, dict(cell.config, L=3), cell.traffic)
    _, tbm, em, spec, cfg = build(cell, 5, tmp_path)
    assert cfg.use_radial_updates and cfg.n_walkers == 8 and len(em.ssh_couplings) == 3
    assert [spec.correlations[k].id_pairs for k in ("bond", "current")] == [tuple((b, b) for b in tbm.bond_ids)] * 2
    _, ctx, state, _ = _init_chain(*_expand(tbm, em, cfg, torch.device("cpu")), cfg)
    fdm = make_fdm(ctx, state.x, dtype="float32")
    C, S, _, _ = mtm_tables(fdm)
    assert not fdm.static_hops and C.shape[1] == S.shape[1] == cell.settings().Ltau == fdm.Ltau


def test_the_cut_cell_is_correct_and_traced(small_cell):
    res = run_cell(small_cell, 2**31 + 2024, 0.5, trace=True, device="cpu")
    assert res.correct, res.compared
    assert res.window.metadata["force_routes"]["plain"] > 0 and res.window.metadata["all_converged"]
    run = LayerRun(res.window, small_cell)
    for name in ("plain_force_ms_per_sweep", "radial_ms_per_sweep"):
        assert read_layer_metric(name, run) > 0, name
    assert read_layer_metric("k1_ssh_roofline_share", run) is None  # no kernel on the CPU


def _span(name, parent, start_us, end_us, **ids):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_us * 1e3), end_ns=int(end_us * 1e3),
                           ids=ids)


def _run(windows, n_sweeps, kernels=(), config=None):
    trace = Trace(windows=windows, kernels=list(kernels), device=[], host_ops=[], n_sweeps=n_sweeps)
    model = build_reference({"L": 12, "Omega": 1.0, "alpha": 0.5})
    return SimpleNamespace(trace=trace, metadata={}, model=lambda: model,
                           cell=SimpleNamespace(config=config or {"beta": 4.0, "dtau": 0.05}))


@pytest.fixture
def two_sweeps(monkeypatch):
    """Two profiled sweeps (us), windows [0, 1000] and [2000, 2300]: radial
    spans [100, 150], [150, 230] in the first, [2250, 2350] across the
    second's end; force spans plain [300, 400] and [2100, 2160], a k3 one
    [500, 900], a plain one outside every window."""
    spans = [_span("sweep", -1, 0, 1000), _span("update", 0, 50, 950),
             _span("radial", 1, 100, 150, walker=0), _span("radial", 1, 150, 230, walker=1),
             _span("force", 1, 300, 400, route="plain", walkers=2), _span("force", 1, 500, 900, route="k3", walkers=2),
             _span("sweep", -1, 2000, 2400), _span("update", 6, 2050, 2390),
             _span("radial", 7, 2250, 2350, walker=0), _span("force", 7, 2100, 2160, route="plain", walkers=1),
             _span("force", -1, 5000, 6000, route="plain", walkers=1)]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    return _run([(0, 1000), (2000, 2300)], 2)


def test_the_span_readers_sum_inside_the_windows(two_sweeps):
    assert read_layer_metric("plain_force_ms_per_sweep", two_sweeps) == pytest.approx((100 + 60) / 1e3 / 2)
    assert read_layer_metric("radial_ms_per_sweep", two_sweeps) == pytest.approx((50 + 80 + 50) / 1e3 / 2)


def test_the_span_readers_read_none_without_their_spans(monkeypatch):
    """The parent's program: sweeps and updates but no radial or force
    span; a plain kick only outside the windows; no tracing module."""
    run = _run([(0, 1000)], 1)
    monkeypatch.setattr(tracing, "spans", lambda: [_span("sweep", -1, 0, 1000), _span("update", 0, 50, 950),
                                                   _span("force", 1, 100, 200, route="k3", walkers=8),
                                                   _span("force", -1, 2000, 2100, route="plain", walkers=1)])
    for name in ("plain_force_ms_per_sweep", "radial_ms_per_sweep"):
        assert read_layer_metric(name, run) is None, name
    import sys

    import smoqyelphqmc_tpu_torch

    monkeypatch.setitem(sys.modules, "smoqyelphqmc_tpu_torch.tracing", None)
    monkeypatch.delattr(smoqyelphqmc_tpu_torch, "tracing")
    for name in ("plain_force_ms_per_sweep", "radial_ms_per_sweep"):
        assert read_layer_metric(name, run) is None, name


K1 = [Kernel("void mtm_kernel<float>", 0.0, 20.0, [2, 80, 288], "float"),
      Kernel("void mtm_kernel<double>", 100.0, 25.0, [8, 80, 288], "double")]


def test_k1_ssh_roofline_against_a_hand_count():
    """Per launch the larger of its bytes (v in and out, exp(-dtau V), each
    hop's cosh and sinh on Ltau rows and its two int32 sites) over 3.35
    TB/s and its operations over the dtype's peak, summed over K1's device
    time."""
    run = _run([(0, 1000)], 1, K1)
    model = run.model()
    nc, hops = len(greedy_colors(model.neighbor_table)), model.neighbor_table.shape[1]
    assert (nc, hops) == (3, 432)
    L, N = 80, 288
    ops_site = 2 * (2 * 3 * nc + 1) + 4

    def least(n, es, peak):
        nbytes = es * (2 * n * L * N + L * N) + hops * (2 * es * L + 8)
        return max(nbytes / 3.35e12, n * L * N * ops_site / peak)

    want = 100 * (least(2, 4, 67e12) + least(8, 8, 34e12)) / 45e-6
    assert read_layer_metric("k1_ssh_roofline_share", run) == pytest.approx(want, rel=1e-12)
    # (2, 80, 288) f32: 467,712 bytes on one row of tables, 740,736 on Ltau rows
    one, per_slice = (roofline.mtm_work(2, L, N, 4, nc, hops, rows)[0] for rows in (1, L))
    assert (one, per_slice) == (467_712, 740_736)


def test_k1_ssh_bound_exceeds_the_static_one_by_the_table_bytes():
    run = _run([(0, 1000)], 1, K1[:1])
    ssh = read_layer_metric("k1_ssh_roofline_share", run)
    static = read_layer_metric("k1_roofline_share", run)
    extra = 432 * 2 * 4 * (80 - 1)  # each hop's cosh and sinh on 79 more rows, f32
    assert ssh > static and ssh - static == pytest.approx(100 * extra / 3.35e12 / 20e-6, rel=1e-9)


@pytest.mark.parametrize("kernels", [
    pytest.param([], id="no-k1"),
    pytest.param([Kernel("void mtm_kernel<float>", 0.0, 20.0)], id="shape-unread"),
    pytest.param([Kernel("void mtm_kernel<float>", 0.0, 20.0, [2, 40, 288], "float")], id="not-ltau-rows"),
])
def test_k1_ssh_roofline_reads_none_without_shapes(kernels):
    assert read_layer_metric("k1_ssh_roofline_share", _run([(0, 1000)], 1, kernels)) is None
