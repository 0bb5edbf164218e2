"""The control, the plain reference one precision step below the
configuration's (bfloat16 for its float32 force and measurement solves) put
in the program's place, comes out not correct; the reference at the
configuration's own precisions comes out correct. On the CPU at a tiny size;
on the card at each cell's size (marked gpu: `python -m pytest
benchmark/tests -m gpu` there)."""

import json

import pytest
import torch

from benchmark.control import readings
from benchmark.harness import HERE, Cell


def _judge(cell, numbers):
    return all(numbers[k] <= cell.spec["limits"][k] for k in cell.spec["limits"])


def test_the_control_fails_and_the_configuration_passes_on_the_cpu(tiny_cell):
    r = readings(tiny_cell, 2**32 + 3, 0.5, "cpu")
    assert _judge(tiny_cell, r["program"])
    assert _judge(tiny_cell, r["config"])
    assert not _judge(tiny_cell, r["control"])


CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = Cell.load(name)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = readings(cell, seed, 5.0, "cuda")
        assert _judge(cell, r["program"]), r
        assert not _judge(cell, r["control"]), r
