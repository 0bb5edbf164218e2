"""The route of the trajectory force evaluations (`updates.hmc.force_route`)
and its counter (`tracing.FORCE_ROUTES`), on the CPU.

The route is decided by the input: K3 where the walker sweep asks for it and
it applies (no SSH couplings); K2 + K4 on a CUDA device for f32 forces with
the symmetric factorization and real hoppings, where K4 takes the lattice
(its SSH form with SSH couplings); the eager derivative chain elsewhere (the
CPU, complex hoppings or SSH constants, f64 forces, the asymmetric
factorization). `HMCParams.fused_force` True /
False forces the route where the planes apply. The contexts here are CPU tensors; the CUDA cases pass the device
alone, which is the device part of the gate (tests/test_torch_gpu.py holds
the route on the card). No jax import.
"""

import dataclasses

import pytest
import torch

from smoqyelphqmc_tpu_torch import driver, tracing
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, _expand, _init_chain, run_updates, simulate
from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
from smoqyelphqmc_tpu_torch.models.library import (
    chain_geometry,
    complex_chain_model,
    holstein_honeycomb_model,
    holstein_honeycomb_spec,
    ossh_chain_model,
)
from smoqyelphqmc_tpu_torch.ops import force
from smoqyelphqmc_tpu_torch.ops.mtm import SMEM_MAX
from smoqyelphqmc_tpu_torch.updates import hmc
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, force_route

CPU, CUDA = torch.device("cpu"), torch.device("cuda")

def _complex_ssh_chain():
    """The chain with a complex SSH constant on real hoppings."""
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononModel, PhononMode, SSHCoupling
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingModel

    geo, bond = chain_geometry(8)
    tbm = TightBindingModel(geo, [bond], [1.0], [0.0], mu=0.1)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], 1.0))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.4 + 0.25j))
    return geo, tbm, em


MODELS = {
    "holstein": lambda: holstein_honeycomb_model(2, 1.0, 0.5, 0.0),
    "ssh": lambda: ossh_chain_model(8, 1.0, 0.5, 0.0),
    "complex": lambda: complex_chain_model(8),
    "complex-ssh": _complex_ssh_chain,
}


def _chain(model="holstein", **kw):
    """(context, preconditioner) of a chain on CPU tensors."""
    _, tbm, em = MODELS[model]()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, **kw)
    _, ctx, state, _ = _init_chain(*_expand(tbm, em, cfg, CPU), cfg)
    return ctx, state.precond


def force_k4(monkeypatch):
    """run_updates / simulate with HMCParams.fused_force=True: the forces
    through K4 (its plain version on the CPU) wherever the planes apply."""
    make = driver._hmc_params
    monkeypatch.setattr(driver, "_hmc_params", lambda cfg: dataclasses.replace(make(cfg), fused_force=True))


ROUTES = [
    pytest.param("holstein", {}, CPU, {}, "plain", id="cpu"),
    pytest.param("holstein", {}, CUDA, {}, "k4", id="cuda"),
    pytest.param("holstein", {"preconditioner": "kpm"}, CUDA, {}, "k4", id="cuda-kpm"),
    pytest.param("holstein", {}, CUDA, {"fused_step_force": True}, "k3", id="cuda-k3"),
    pytest.param("holstein", {"preconditioner": "kpm"}, CUDA, {"fused_step_force": True}, "k4", id="cuda-kpm-no-k3"),
    pytest.param("holstein", {}, CUDA, {"fused_force": False}, "plain", id="cuda-forced-plain"),
    pytest.param("holstein", {}, CPU, {"fused_force": True}, "k4", id="cpu-forced-k4"),
    pytest.param("ssh", {}, CUDA, {}, "k4", id="cuda-ssh"),
    pytest.param("ssh", {}, CUDA, {"fused_force": True}, "k4", id="cuda-ssh-forced"),
    pytest.param("complex-ssh", {}, CUDA, {}, "plain", id="cuda-complex-ssh"),
    pytest.param("ssh", {"force_dtype": "float64"}, CUDA, {}, "plain", id="cuda-ssh-f64-forces"),
    pytest.param("complex", {}, CUDA, {}, "plain", id="cuda-complex"),
    pytest.param("holstein", {"force_dtype": "float64"}, CUDA, {}, "plain", id="cuda-f64-forces"),
    pytest.param("holstein", {"symmetric": False}, CUDA, {}, "plain", id="cuda-asymmetric"),
]


@pytest.mark.parametrize("model,cfg,device,params,route", ROUTES)
def test_force_route_follows_the_input(model, cfg, device, params, route):
    ctx, precond = _chain(model, **cfg)
    assert force_route(ctx, precond, HMCParams(**params), device) == route


def test_force_route_takes_the_shape(monkeypatch):
    """K4 takes a lattice whose block of one row fits a CTA's shared memory
    (the memory form's bytes; the staged form where those fit too): the
    route leaves K4 above that, without a launch to refuse."""
    for N in (18, 288, 3200, 4608, 7200):
        assert force.fits(N) and force.smem_bytes(N, 1, force.staged_form(N)) <= SMEM_MAX, N
    assert force.staged_form(3200) and not force.staged_form(4608)
    assert not force.fits(7300) and not force.fits(8192)
    ctx, precond = _chain()
    monkeypatch.setattr(hmc.k4, "fits", lambda N: N > 10**6)
    assert force_route(ctx, precond, HMCParams(), CUDA) == "plain"
    assert force_route(ctx, precond, HMCParams(fused_force=True), CUDA) == "k4"


@pytest.mark.parametrize("kw,n_walkers,route", [
    pytest.param({}, 1, "plain", id="w1"),
    pytest.param({"k4": True}, 1, "k4", id="w1-k4"),
    pytest.param({"hmc_integrator": "omelyan"}, 1, "plain", id="w1-omelyan"),
    pytest.param({}, 2, "k3", id="w2-shared"),
    pytest.param({"shared_precond": False, "k4": True}, 2, "k4", id="w2-perwalker-k4"),
    pytest.param({"ssh": True, "k4": True}, 2, "k4", id="w2-ssh"),
])
def test_force_routes_count_each_kick(kw, n_walkers, route, monkeypatch):
    """run_updates' force_routes: one evaluation a walker a kick on the
    route taken, Nt a leapfrog trajectory (2 Nt under Omelyan), as the
    process counter moves; `k4` forces K4 where the planes apply."""
    kw = dict(kw)
    if kw.pop("k4", False):
        force_k4(monkeypatch)
    _, tbm, em = MODELS["ssh" if kw.pop("ssh", False) else "holstein"]()
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, seed=3, n_walkers=n_walkers, **kw)
    start = dict(tracing.FORCE_ROUTES)
    md = run_updates(tbm, em, cfg, 2, device="cpu")
    kicks = 2 * n_walkers * cfg.Nt * (2 if cfg.hmc_integrator == "omelyan" else 1)
    assert md["all_converged"] and md["force_routes"] == {**{"k3": 0, "k4": 0, "plain": 0}, route: kicks}
    assert tracing.force_routes_since(start) == md["force_routes"]


def test_stopped_simulate_reports_force_routes(tmp_path, monkeypatch):
    """simulate returns this call's evaluations by route on a stop as at
    the end: the first thermalization sweep's Nt a walker when the runtime
    limit stops it, the resumed call's own sweeps after it."""
    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, N_therm=2, N_measurements=2, N_bins=1, Nrv=2, seed=3,
                           n_walkers=2, shared_precond=False)
    force_k4(monkeypatch)
    info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="routes", sID=1)

    def run(c):
        gen = simulate(info, tbm, em, holstein_honeycomb_spec(geo), c, device="cpu")
        while True:
            try:
                next(gen)
            except StopIteration as done:
                return done.value

    md, finished = run(dataclasses.replace(cfg, runtime_limit_hours=0.0))
    assert not finished and md["force_routes"] == {"k3": 0, "k4": 2 * 4, "plain": 0}
    md, finished = run(cfg)
    assert finished and md["force_routes"] == {"k3": 0, "k4": 3 * 2 * 4, "plain": 0}
