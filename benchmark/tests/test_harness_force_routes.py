"""plain_force_share: the share of the trajectory force evaluations that took
the plain derivative chain, read from `simulate`'s `force_routes`."""

from types import SimpleNamespace

import pytest

from benchmark.run import read_layer_metric


def _run(metadata):
    return SimpleNamespace(metadata=metadata, sweeps_run=24)


def test_plain_force_share_reads_the_routes():
    routes = {"k3": 96, "k4": 672, "plain": 0}
    assert read_layer_metric("plain_force_share", _run({"force_routes": routes})) == 0.0
    routes = {"k3": 0, "k4": 36, "plain": 12}
    assert read_layer_metric("plain_force_share", _run({"force_routes": routes})) == pytest.approx(25.0)


def test_plain_force_share_is_none_without_routes():
    """A program that does not count its routes (or counted none) reads None."""
    assert read_layer_metric("plain_force_share", _run({"precond_fallback_sweeps": 3})) is None
    assert read_layer_metric("plain_force_share", _run({"force_routes": {"k3": 0, "k4": 0, "plain": 0}})) is None


def test_plain_force_share_of_a_simulate_run(tmp_path, monkeypatch):
    """simulate's own metadata on the CPU, where the default route is the
    plain chain and HMCParams.fused_force=True takes K4's plain version:
    100% and 0%."""
    import dataclasses

    from smoqyelphqmc_tpu_torch import driver
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, simulate
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model, holstein_honeycomb_spec

    geo, tbm, em = holstein_honeycomb_model(2, 1.0, 0.5, 0.0)
    cfg = SimulationConfig(beta=1.0, dtau=0.1, Nt=4, N_therm=1, N_measurements=1, N_bins=1, Nrv=2, seed=5)
    shares, make = [], driver._hmc_params
    for tag in ("default", "k4"):
        if tag == "k4":
            monkeypatch.setattr(driver, "_hmc_params", lambda c: dataclasses.replace(make(c), fused_force=True))
        info = SimulationInfo(filepath=str(tmp_path / tag), datafolder_prefix="routes", sID=1)
        gen = simulate(info, tbm, em, holstein_honeycomb_spec(geo), cfg, device="cpu")
        while True:
            try:
                next(gen)
            except StopIteration as done:
                metadata, finished = done.value
                break
        assert finished
        shares.append(read_layer_metric("plain_force_share", _run(metadata)))
    assert shares == [100.0, 0.0]
