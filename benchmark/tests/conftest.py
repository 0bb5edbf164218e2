import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_cell():
    """A cell of the headline configuration cut to L=3, beta=2, Nt=8 with
    four walkers, for the CPU: the limits and band of honeycomb_l12_w8."""
    import json

    from benchmark.harness import HERE, Cell

    base = Cell.load("honeycomb_l12_w8")
    config = dict(base.config, L=3, beta=2.0, Nt=8)
    traffic = json.loads((HERE / "traffic" / "w8_shared.json").read_text())
    return Cell("tiny", dict(base.spec), config, dict(traffic, n_walkers=4, N_therm=1))


@pytest.fixture
def tiny_ossh_cell(tiny_cell):
    """The optical-SSH honeycomb of the reference package's example
    (alpha=0.5, radial updates on, every bond measured) in the tiny cell's
    place: L=3, beta=2, Nt=8, four walkers, the limits and band of
    honeycomb_l12_w8."""
    config = dict(tiny_cell.config, model="ossh_honeycomb", spec="basic_spec", alpha=0.5, use_radial_updates=True)
    return dataclasses.replace(tiny_cell, name="tiny_ossh", config=config)
