"""The plain reference's optical-SSH replay against the port on a tiny
honeycomb (L=3, beta=2) on the CPU: the SSH-modulated operator, the action
and force, the radial move and a whole checked sweep. Only this test and
test_harness_reference.py import both; the reference itself imports nothing
of the port."""

import dataclasses
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import HERE, run_cell
from benchmark.reference import Reference, Settings
from benchmark.references.ossh_honeycomb import build

CFG = {"L": 3, "Omega": 1.0, "alpha": 0.5, "mu": 0.0}
S = Settings(beta=2.0, dtau=0.05, mu=0.0, Nt=8, jitter=0.05, tol=1e-10, Nrv=4, kpm=False, radial=True)


def _port(seed=3, tol=1e-12):
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, _expand
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc

    _, tbm, em = ossh_honeycomb_model(3, 1.0, 0.5, 0.0)
    tbp, elph = _expand(tbm, em, SimulationConfig(beta=2.0, seed=seed), torch.device("cpu"))
    return initialize_qmc(tbp, elph, use_preconditioner=False, tol=tol)


def _reference():
    ref = Reference(build(CFG), S, "cpu")
    ref.pre = lambda r: r
    ref.plan = dataclasses.replace(ref.plan, tol_force=1e-12)  # the algebra, not the tolerance, is tested here
    return ref


def test_operator_and_action_and_force_match_the_port():
    from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
    from smoqyelphqmc_tpu_torch.updates.context import make_fdm

    ctx, state = _port()
    x = state.x
    fdm = make_fdm(ctx, x)
    assert not fdm.static_hops
    g = torch.Generator().manual_seed(5)
    v = torch.randn((2, 40, 18), generator=g, dtype=torch.float64)
    ref = _reference()
    op = ref.op
    tabs = op.tables(x[None])
    assert torch.allclose(op.MtM(v[None], tabs)[0], fdm.mul_MtM(v), rtol=0, atol=1e-12)
    # the modulation is there: the bare hoppings' operator differs
    bare = (tabs[0], op.C, op.S)
    assert float((op.MtM(v[None], bare)[0] - fdm.mul_MtM(v)).abs().max()) > 1e-3
    R = torch.randn((2, 40, 18), generator=g, dtype=torch.float64) / np.sqrt(2.0)
    Phi, _ = sample_pseudofermion_fields(R, ctx.elph, fdm, x)
    assert torch.allclose(ref._phi(x[None], R[None])[0], Phi, rtol=1e-13, atol=1e-13)
    x1 = x + 0.1 * torch.randn(x.shape, generator=g, dtype=torch.float64)
    res = fermionic_action_and_force(Phi, ctx.elph, make_fdm(ctx, x1), x1, ctx.plan, tol=1e-12, maxiter=10_000)
    assert float(ref.action(x1[None], Phi[None])[0]) == pytest.approx(float(res.Sf), rel=1e-10)
    f = ref.force(x1[None], Phi[None])[0]
    assert torch.allclose(f, res.force, rtol=1e-6, atol=1e-8 * float(res.force.abs().max()))


def test_a_radial_move_matches_the_port():
    """The same decision and the same field as the port's radial_update on
    the same draws, for moves whose acceptance lies between 0 and 1 (small
    z: the initial field is far from the fermions' equilibrium) and one taken
    outright."""
    from smoqyelphqmc_tpu_torch.updates.global_updates import RadialDraws, radial_update

    ctx, state = _port(tol=1e-10)
    g = torch.Generator().manual_seed(11)
    R = torch.randn((2, 40, 18), generator=g, dtype=torch.float64) / math.sqrt(2.0)
    ref = _reference()
    x = state.x[None]
    decisions = {}
    for z in (-1.5, 1e-3, 3e-3):
        scaled, log_weight = ref.radial(x, [z])
        for u in (0.05, 0.5, 0.95):
            new, stats = radial_update(ctx, state, RadialDraws(z=z, R=R, u_acc=u))
            accepted = bool(ref._metropolis(x, scaled, R[None], torch.tensor([u], dtype=torch.float64),
                                            log_weight)[0])
            assert accepted == stats.accepted, (z, u, stats)
            assert torch.equal(new.x, scaled[0] if accepted else state.x)
            decisions.setdefault(z, set()).add(accepted)
    assert decisions[-1.5] == {True} and decisions[1e-3] == {True, False} and decisions[3e-3] == {True, False}


def test_the_radial_moves_of_the_replay_decide_both_ways():
    """On the tiny cell's draws the replayed radial move both accepts and
    rejects across a few states (a replay that never moved would test
    nothing)."""
    from benchmark.reference import draw

    ref = Reference(build(CFG), S, "cpu")
    gens = [torch.Generator().manual_seed(300 + w).get_state() for w in range(6)]
    draws = [draw(gs, ref.model, S) for gs in gens]
    x0 = 0.7 * torch.randn((6, 18, 40), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    sw = ref.sweep(x0, draws)
    radial = [a[2] for a in sw.global_accepted]
    assert any(radial) and not all(radial), radial


def test_the_replayed_ssh_sweep_agrees_with_the_program(tiny_ossh_cell):
    res = run_cell(tiny_ossh_cell, 2**31 + 91, 1.0, trace=False, device="cpu")
    assert res.correct, res.compared
    assert res.compared["field_gap"] < 1e-4 and res.compared["measure_gap"] < 1e-4
    assert len(res.window.durations) >= 1 and res.window.metadata["all_converged"]


def test_the_ssh_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference, benchmark.references.ossh_honeycomb; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'smoqyelphqmc_tpu', "
            "'smoqyelphqmc_tpu_torch'}))") % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("change", [{"mass": np.inf}, {"ssh_alpha": 0.5 + 0.1j}])
def test_the_reference_model_refuses_frozen_modes_and_complex_constants(change):
    model = build(CFG)
    fields = dataclasses.asdict(model)
    key, value = next(iter(change.items()))
    fields[key] = np.full_like(fields[key], value, dtype=np.result_type(fields[key], value))
    with pytest.raises(ValueError, match="reference"):
        type(model)(**fields)
