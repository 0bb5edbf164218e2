"""smoqyelphqmc_tpu_torch.dh_scan on the CPU: its default output (the
optical-SSH honeycomb, 'auto') is what the tool printed before it took
--model, --alpha and --preconditioner, and the Holstein honeycomb's Delta H
falls with Nt as a consistent force makes it fall."""

import json

import pytest
import torch

from smoqyelphqmc_tpu_torch import dh_scan

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--L", "2", "--beta", "1"]
# the tool's lines at TINY before the options came (the same CPU build, two
# threads); "seconds" is the run's own
BEFORE = [
    {"L": 2, "beta": 1.0, "Nt": 24, "delta_H": 0.007432714747665159, "iters_per_solve": 3.4, "converged": True},
    {"L": 2, "beta": 1.0, "Nt": 48, "delta_H": 0.0015310342971588398, "iters_per_solve": 1.8775510204081634,
     "converged": True},
    {"L": 2, "beta": 1.0, "Nt": 96, "delta_H": 0.000337789202148997, "iters_per_solve": 1.3917525773195876,
     "converged": True},
]


def _lines(argv, capsys):
    dh_scan.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_default_output_unchanged(capsys):
    """The default lines carry the keys of before in their order, the same
    Nt, iterations and convergence, and Delta H to 1e-12 relative; naming
    the defaults explicitly prints the same."""
    got = _lines(TINY, capsys)
    for line, want in zip(got, BEFORE, strict=True):
        assert list(line) == list(want) + ["seconds"]
        assert {k: v for k, v in line.items() if k not in ("delta_H", "seconds")} == {
            k: v for k, v in want.items() if k != "delta_H"}
        assert line["delta_H"] == pytest.approx(want["delta_H"], rel=1e-12)
    named = _lines(TINY + ["--model", "ossh_honeycomb", "--alpha", "0.5", "--preconditioner", "auto"], capsys)
    assert [{k: v for k, v in d.items() if k != "seconds"} for d in named] == [
        {k: v for k, v in d.items() if k != "seconds"} for d in got]


def test_holstein_delta_h_falls_with_nt(capsys):
    """The Holstein honeycomb at alpha 1.5 ('auto', here spectral): every
    trajectory converges and Delta H falls by ~4 a doubling of Nt."""
    got = _lines(TINY + ["--model", "holstein_honeycomb", "--Nt", "6", "12", "24"], capsys)
    assert [d["Nt"] for d in got] == [6, 12, 24] and all(d["converged"] for d in got)
    dH = [abs(d["delta_H"]) for d in got]
    assert 2.5 <= dH[0] / dH[1] <= 6.0 and 2.5 <= dH[1] / dH[2] <= 6.0, dH
