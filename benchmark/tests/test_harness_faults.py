"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run on the CPU at a tiny
size, one fault at a time; on the optical-SSH honeycomb also faults of the
SSH couplings and the radial move, and what the reference cannot replay is
refused before set-up."""

import dataclasses
import math

import pytest
import torch

from benchmark.harness import run_cell


def _unchanged_trajectory(real):
    def hmc_update(ctx, state, params, draws, recenter=None):
        _, stats = real(ctx, state, params, draws, recenter=recenter)
        return state, stats

    return hmc_update


def _half_the_vectors(real):
    def make_measurements(ctx, spec, est, x):
        h = est.Nrv // 2
        return real(ctx, spec, dataclasses.replace(est, R=est.R[:h], GR=est.GR[:h], Nrv=h), x)

    return make_measurements


def _altered_answer(real):
    def make_measurements(ctx, spec, est, x):
        out = real(ctx, spec, est, x)
        re, im = out["correlations"]["greens"]
        out["correlations"]["greens"] = (re * 1.01, im)
        return out

    return make_measurements


FAULTS = {
    "a sweep returns its state unchanged": ("smoqyelphqmc_tpu_torch.parallel.walkers", "hmc_update",
                                            _unchanged_trajectory),
    "half of the random vectors left out, the mean over the rest": (
        "smoqyelphqmc_tpu_torch.parallel.walkers", "make_measurements", _half_the_vectors),
    "an answer altered where it is produced": ("smoqyelphqmc_tpu_torch.parallel.walkers", "make_measurements",
                                               _altered_answer),
}


def test_the_sound_run_is_correct(tiny_cell):
    assert run_cell(tiny_cell, 424242, 0.5, trace=False, device="cpu").correct


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_makes_the_run_not_correct(fault, tiny_cell, monkeypatch):
    import importlib

    module, name, wrap = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res = run_cell(tiny_cell, 424242, 0.5, trace=False, device="cpu")
    assert not res.correct, res.compared


def _ssh_couplings(change):
    """The program's optical-SSH model with its SSH couplings passed through
    `change` (a list of SSHCoupling to a list)."""
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model

    def model(L, Omega, alpha, mu, t=1.0):
        geo, tbm, em = ossh_honeycomb_model(L, Omega, alpha, mu, t)
        em.ssh_couplings = change(em.ssh_couplings)
        return geo, tbm, em

    return model


def _flipped_alpha(_real):
    return _ssh_couplings(lambda cs: [dataclasses.replace(c, alpha_mean=-c.alpha_mean) for c in cs])


def _one_bond_unmodulated(_real):
    return _ssh_couplings(lambda cs: cs[1:])


def _radial_skipped(_real):
    from smoqyelphqmc_tpu_torch.updates.global_updates import GlobalUpdateStats

    def radial_update(ctx, state, draws, phonon_id=None, sigma=1.0):
        return state, GlobalUpdateStats(accepted=False, delta_S=0.0, iters=0, converged=True)

    return radial_update


SSH_FAULTS = {
    "alpha's sign flipped in the program's model": ("smoqyelphqmc_tpu_torch.models.library", "ossh_honeycomb_model",
                                                    _flipped_alpha),
    "one bond's modulation left out": ("smoqyelphqmc_tpu_torch.models.library", "ossh_honeycomb_model",
                                       _one_bond_unmodulated),
    "the radial move skipped": ("smoqyelphqmc_tpu_torch.parallel.walkers", "radial_update", _radial_skipped),
}


def test_the_sound_ssh_run_is_correct(tiny_ossh_cell):
    assert run_cell(tiny_ossh_cell, 515151, 0.5, trace=False, device="cpu").correct


@pytest.mark.parametrize("fault", list(SSH_FAULTS))
def test_an_ssh_fault_makes_the_run_not_correct(fault, tiny_ossh_cell, monkeypatch):
    import importlib

    module, name, wrap = SSH_FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res = run_cell(tiny_ossh_cell, 515151, 0.5, trace=False, device="cpu")
    assert not res.correct, res.compared


def _with_mode(**changes):
    """The program's optical-SSH model with its first phonon mode changed."""
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model

    def model(L, Omega, alpha, mu, t=1.0):
        geo, tbm, em = ossh_honeycomb_model(L, Omega, alpha, mu, t)
        em.phonon_modes[0] = dataclasses.replace(em.phonon_modes[0], **changes)
        return geo, tbm, em

    return model


UNREPLAYED = {
    "a frozen mode (bond SSH)": ({}, _with_mode(M=math.inf)),
    "complex SSH constants": ({}, _ssh_couplings(lambda cs: [dataclasses.replace(c, alpha_mean=c.alpha_mean + 0.1j)
                                                             for c in cs])),
    "higher-order SSH constants": ({}, _ssh_couplings(lambda cs: [dataclasses.replace(c, alpha2_mean=0.1)
                                                                  for c in cs])),
    "Omelyan integration": ({"hmc_integrator": "omelyan"}, None),
    "target_acceptance": ({"target_acceptance": 0.7}, None),
    "hmc_dt": ({"hmc_dt": 0.05}, None),
}


@pytest.mark.parametrize("what", list(UNREPLAYED))
def test_what_the_reference_cannot_replay_is_refused(what, tiny_ossh_cell, monkeypatch):
    from smoqyelphqmc_tpu_torch.models import library

    options, model = UNREPLAYED[what]
    if model is not None:
        monkeypatch.setattr(library, "ossh_honeycomb_model", model)
    cell = dataclasses.replace(tiny_ossh_cell, config=dict(tiny_ossh_cell.config, **options))
    with pytest.raises(ValueError, match="reference"):
        run_cell(cell, 515151, 0.5, trace=False, device="cpu")
