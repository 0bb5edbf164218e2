"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run on the CPU at a tiny
size, one fault at a time."""

import dataclasses

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
