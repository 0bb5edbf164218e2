"""The readers of the program's spans and solver records on synthetic
traces: each idle share, the driver's self time, the ms a sweep, the K2 / K3
roofline against a hand count and None where a record and a kernel do not
pair; None, not an error, for a program without spans, records or the
fallback count (an earlier version of the port)."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import roofline, roofline_pcg
from benchmark.reference import greedy_colors
from benchmark.references.holstein_honeycomb import build
from benchmark.run import read_layer_metric
from benchmark.trace import Kernel, Trace
from smoqyelphqmc_tpu_torch import tracing
from smoqyelphqmc_tpu_torch.ops.pcg import PCG
from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE

MODEL = build({"L": 3, "Omega": 1.0, "alpha": 1.5})


def _span(name, parent, start_us, end_us):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_us * 1e3), end_ns=int(end_us * 1e3))


def _run(windows, device, n_sweeps, kernels=(), metadata=None, sweeps_run=0):
    trace = Trace(windows=windows, kernels=list(kernels), device=device, host_ops=[], n_sweeps=n_sweeps)
    return SimpleNamespace(trace=trace, metadata=metadata or {}, sweeps_run=sweeps_run, model=lambda: MODEL,
                           cell=SimpleNamespace(config={"symmetric": True}))


@pytest.fixture
def two_sweeps(monkeypatch):
    """Two profiled sweeps (us): sweep 0 in [0, 1000] with update [100, 600],
    refresh [600, 700], measure [700, 900]; sweep 1 in [2000, 2400], of which
    the window holds [2000, 2300], with update [2050, 2250], refresh [2250,
    2350] and measure [2350, 2380]; an update outside every window."""
    spans = [_span("sweep", -1, 0, 1000), _span("update", 0, 100, 600), _span("refresh", 0, 600, 700),
             _span("measure", 0, 700, 900),
             _span("sweep", -1, 2000, 2400), _span("update", 4, 2050, 2250), _span("refresh", 4, 2250, 2350),
             _span("measure", 4, 2350, 2380),
             _span("update", -1, 5000, 6000)]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    device = [(150, 250), (200, 300), (650, 680), (950, 990), (2100, 2110), (2260, 2280), (5100, 5900)]
    return _run([(0, 1000), (2000, 2300)], device, 2)


def test_span_times_a_sweep(two_sweeps):
    assert read_layer_metric("update_ms_per_sweep", two_sweeps) == pytest.approx((500 + 200) / 1e3 / 2)


def test_idle_shares_of_the_spans(two_sweeps):
    # update spans inside the windows: [100, 600] and [2050, 2250], 700 us; busy 150 + 10
    assert read_layer_metric("update_idle_share", two_sweeps) == pytest.approx(100 * (1 - 160 / 700))
    # refresh and measure: [600, 900] and [2250, 2300], 350 us; busy 30 + 20
    assert read_layer_metric("measure_idle_share", two_sweeps) == pytest.approx(100 * (1 - 50 / 350))


def test_driver_self_time_subtracts_the_children(two_sweeps):
    # sweep 0: 1000 - (500 + 100 + 200); sweep 1 in its window: 300 - (200 + 50)
    assert read_layer_metric("driver_self_ms_per_sweep", two_sweeps) == pytest.approx((200 + 50) / 1e3 / 2)


def test_no_spans_no_readings(monkeypatch):
    run = _run([(0, 1000)], [(0, 10)], 1)
    monkeypatch.setattr(tracing, "spans", lambda: [_span("update", -1, 5000, 6000)])  # outside the window
    for name in ("update_ms_per_sweep", "update_idle_share", "measure_idle_share", "driver_self_ms_per_sweep"):
        assert read_layer_metric(name, run) is None, name
    import smoqyelphqmc_tpu_torch

    monkeypatch.setitem(sys.modules, "smoqyelphqmc_tpu_torch.tracing", None)  # a port without the module
    monkeypatch.delattr(smoqyelphqmc_tpu_torch, "tracing")
    monkeypatch.setattr(tracing, "spans", lambda: [_span("update", -1, 0, 500)])
    for name in ("update_ms_per_sweep", "update_idle_share", "measure_idle_share", "driver_self_ms_per_sweep"):
        assert read_layer_metric(name, run) is None, name


def test_fallback_share_reads_the_stopped_run():
    assert read_layer_metric("precond_fallback_share", _run([], [], 0, metadata={"precond_fallback_sweeps": 18},
                                                            sweeps_run=24)) == pytest.approx(75.0)
    assert read_layer_metric("precond_fallback_share", _run([], [], 0, sweeps_run=24)) is None


def _launch(kernel, n, iters):
    import torch

    return tracing.Launch(kernel, n, 80, MODEL.n_sites, torch.tensor(iters, dtype=torch.int32))


@pytest.fixture
def solver_run(monkeypatch):
    """Two K2 launches (2 systems, 15 iterations; 20 systems, 9) and one K3
    launch of 2 walkers (12 and 7 iterations) at Ltau=80, N=18, each
    kernel 1 ms on the device."""
    monkeypatch.setattr(PCG, "records", [_launch("pcg", 2, 15), _launch("pcg", 20, 9)])
    monkeypatch.setattr(PCG_FORCE, "records", [_launch("pcg_force", 4, [12, 7])])
    kernels = [Kernel("void pcg_kernel<false>", 0.0, 1000.0), Kernel("void pcg_kernel<false>", 2000.0, 1000.0),
               Kernel("void pcg_force_kernel<1>", 4000.0, 1000.0), Kernel("void mtm_kernel<float>", 6000.0, 5.0)]
    return _run([(0, 10000)], [], 1, kernels=kernels)


def test_pcg_roofline_against_a_hand_count(solver_run):
    L, N, nc, hops = 80, MODEL.n_sites, len(greedy_colors(MODEL.neighbor_table)), MODEL.neighbor_table.shape[1]
    assert nc == 3 and hops == 27
    Lh = L // 2
    b = 2 * 3 * nc + 1  # a symmetric B: operations a site
    f32_it = L * N * (2 * b + 14) + 2 * Lh * N
    bf16_it = 4 * (2 * Lh) * L * N + 4 * (2 * Lh) * N * N
    pre = 2 * N * N + 2 * (2 * Lh) * L + 4 * Lh * N
    tables = hops * (2 * 4 + 8)

    def least(nbytes, f32, bf16):
        return max(nbytes / 3.35e12, f32 / 67e12 + bf16 / 989e12)

    k2 = sum(least(4 * (2 * n * L * N + L * N) + pre + tables, it * n * f32_it, it * n * bf16_it)
             for n, it in ((2, 15), (20, 9)))
    epilogue = 2 * L * N * (2 * b + 6 * nc + 10)
    k3 = least(10 * 2 * L * N * 4 + pre + tables, 2 * 19 * f32_it + 2 * epilogue, 2 * 19 * bf16_it)
    assert read_layer_metric("pcg_roofline_share", solver_run) == pytest.approx(100 * (k2 + k3) / 3e-3, rel=1e-12)


def test_pcg_roofline_needs_one_record_a_kernel(solver_run, monkeypatch):
    monkeypatch.setattr(PCG, "records", PCG.records[:1])
    assert read_layer_metric("pcg_roofline_share", solver_run) is None
    monkeypatch.setattr(PCG, "records", [_launch("pcg", 2, 15)] * 2)
    monkeypatch.setattr(PCG_FORCE, "records", [])
    assert read_layer_metric("pcg_roofline_share", solver_run) is None
    monkeypatch.delattr(PCG, "records")  # a port whose counters keep no records
    assert read_layer_metric("pcg_roofline_share", solver_run) is None


@pytest.mark.parametrize("symmetric", [True, False])
def test_pcg_work_matches_chip_smoke(symmetric):
    import chip_smoke

    for Ltau, N in ((80, 288), (240, 288), (81, 18)):
        assert roofline_pcg.pcg_iteration_ops(Ltau, N, 3, symmetric) == chip_smoke.pcg_iteration_ops(Ltau, N, 3,
                                                                                                      symmetric)
        assert roofline_pcg.precond_bytes(Ltau, N) == chip_smoke.precond_bytes(Ltau, N)
        assert roofline_pcg.epilogue_ops(Ltau, N, 3) == chip_smoke.epilogue_ops(Ltau, N, 3)
    assert roofline_pcg.pcg_bound(2, 80, 288, 10, 3, 432) == roofline.bound(
        4 * (2 * 2 * 80 * 288 + 80 * 288) + chip_smoke.precond_bytes(80, 288) + roofline.table_bytes(432, 4),
        {"f32": 20 * chip_smoke.pcg_iteration_ops(80, 288, 3)[0],
         "bf16": 20 * chip_smoke.pcg_iteration_ops(80, 288, 3)[1]})
