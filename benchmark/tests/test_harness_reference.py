"""The plain reference against the port on a tiny honeycomb (L=3, beta=2) on
the CPU. Only this test imports both; the reference itself imports nothing
of the port."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import HERE, run_cell
from benchmark.reference import Reference, Settings, measurements
from benchmark.references.holstein_honeycomb import GREENS_PAIRS, build

CFG = {"L": 3, "Omega": 1.0, "alpha": 0.6, "mu": 0.0}
S = Settings(beta=2.0, dtau=0.05, mu=0.0, Nt=8, jitter=0.05, tol=1e-10, Nrv=4, kpm=False)


def _port(seed=3):
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, _expand
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc

    _, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    tbp, elph = _expand(tbm, em, SimulationConfig(beta=2.0, seed=seed), torch.device("cpu"))
    return initialize_qmc(tbp, elph, use_preconditioner=False, tol=1e-12)


def test_operator_and_action_and_force_match_the_port():
    from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
    from smoqyelphqmc_tpu_torch.updates.context import make_fdm

    ctx, state = _port()
    x = state.x
    fdm = make_fdm(ctx, x)
    g = torch.Generator().manual_seed(5)
    v = torch.randn((2, 40, 18), generator=g, dtype=torch.float64)
    ref = Reference(build(CFG), S, "cpu")
    ref.pre = lambda r: r
    ref.plan = dataclasses.replace(ref.plan, tol_force=1e-12)  # the algebra, not the tolerance, is tested here
    op = ref.op
    tabs = op.tables(x[None])
    assert torch.allclose(op.MtM(v[None], tabs)[0], fdm.mul_MtM(v), rtol=0, atol=1e-12)
    R = torch.randn((2, 40, 18), generator=g, dtype=torch.float64) / np.sqrt(2.0)
    Phi, _ = sample_pseudofermion_fields(R, ctx.elph, fdm, x)
    assert torch.allclose(ref._phi(x[None], R[None])[0], Phi, rtol=1e-13, atol=1e-13)
    x1 = x + 0.1 * torch.randn(x.shape, generator=g, dtype=torch.float64)
    res = fermionic_action_and_force(Phi, ctx.elph, make_fdm(ctx, x1), x1, ctx.plan, tol=1e-12, maxiter=10_000)
    assert float(ref.action(x1[None], Phi[None])[0]) == pytest.approx(float(res.Sf), rel=1e-10)
    f = ref.force(x1[None], Phi[None])[0]
    assert torch.allclose(f, res.force, rtol=1e-6, atol=1e-8 * float(res.force.abs().max()))


def test_greens_function_and_density_match_the_port_estimator():
    from smoqyelphqmc_tpu_torch.measure.greens_estimator import GreensEstimator, measure_G
    from smoqyelphqmc_tpu_torch.measure.scalar import measure_n

    g = torch.Generator().manual_seed(7)
    Nrv, Lt, N = 4, 40, 18
    R = torch.randn((1, Nrv, 2, Lt, N), generator=g, dtype=torch.float64)
    GR = torch.randn((1, Nrv, 2, Lt, N), generator=g, dtype=torch.float64)
    got = measurements(build(CFG), R, GR, GREENS_PAIRS)
    est = GreensEstimator(R=R[0], GR=GR[0], Nrv=Nrv, Ltau=Lt, n_orb=2, L=(3, 3))
    for k, pair in enumerate(GREENS_PAIRS):
        assert torch.allclose(got["greens"][0, k], measure_G(est, pair), rtol=0, atol=1e-12)
    assert torch.allclose(got["density"][0], 2.0 * measure_n(est), rtol=0, atol=1e-12)


def test_the_replayed_sweep_agrees_with_the_program(tiny_cell):
    res = run_cell(tiny_cell, 2**31 + 77, 1.0, trace=False, device="cpu")
    assert res.correct, res.compared
    assert res.compared["field_gap"] < 1e-4 and res.compared["measure_gap"] < 1e-4
    assert len(res.window.durations) >= 1 and res.window.metadata["all_converged"]


# The exact reference's Delta H a walker and the numbers compared of the reference at the configuration's
# precisions, judged as the program is, on a fixed state of the tiny cell (below): taken from the reference as it
# stood before it replayed SSH couplings and radial moves, one intra-op thread; four threads read the same.
PINNED = {
    "dH": [0.020830508334256592, 0.023203635125355504, 0.030880259964760626, 0.02110597522369062],
    "field_gap": 1.1698518598417499e-05,
    "measure_gap": 6.743741758128482e-06,
    "dH_config": [0.020779246975507704, 0.02318227671457862, 0.03085688233113615, 0.02106139389798045],
}


def test_the_holstein_replay_has_not_moved(tiny_cell):
    from benchmark import check

    g = torch.Generator().manual_seed(2024)
    x0 = 0.7 * torch.randn((4, 18, 40), generator=g, dtype=torch.float64)
    gens = [torch.Generator().manual_seed(100 + w).get_state() for w in range(4)]
    judge = check.Judge(tiny_cell.config, tiny_cell.settings(), "cpu", x0, gens, float(tiny_cell.spec["dH_band"]),
                        tuple(tiny_cell.spec["limits"]))
    config = check.control(judge, ("config",))["config"]
    got = {"dH": judge.dH, "field_gap": config["field_gap"], "measure_gap": config["measure_gap"],
           "dH_config": config["dH"]}
    assert got == PINNED


def test_the_traced_run_profiles_its_sweeps_and_checks_the_next(tiny_cell):
    res = run_cell(tiny_cell, 12345, 0.5, trace=True, device="cpu")
    assert res.correct, res.compared
    tr = res.window.trace
    assert tr.n_sweeps == tiny_cell.spec["trace_sweeps"] and tr.window_us > 0 and tr.host_ops


def test_the_reference_and_yardstick_load_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference, benchmark.check, benchmark.roofline, "
            "benchmark.trace, benchmark.references.holstein_honeycomb; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'smoqyelphqmc_tpu', "
            "'smoqyelphqmc_tpu_torch'}))") % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(HERE))
    import run

    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "smoqyelphqmc_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "smoqyelphqmc_tpu.ops", object())
    assert set(run.forbidden_modules()) == base | {"smoqyelphqmc_tpu"}
