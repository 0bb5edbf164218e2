"""Configurations, cells, traffic mixes and per-layer readers are files
found by the names in BENCHMARK.json."""

import importlib.util
import json
import re

import pytest

from benchmark.harness import HERE, Cell

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    cell = Cell.load(w["name"])
    assert (cell.spec["config"], cell.spec["traffic"]) == (w["config"], w["traffic"])
    assert "measure_gap" in cell.spec["limits"] and set(cell.spec["limits"]) <= {"field_gap", "measure_gap"}
    assert cell.spec["trace_sweeps"] >= 1
    assert ("field_gap" in cell.spec["limits"]) == (cell.spec.get("dH_band", 0) > 0)
    assert cell.n_walkers >= 1 and cell.settings().Ltau * cell.config["dtau"] == pytest.approx(cell.config["beta"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_is_found_by_name(c):
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    cfg = json.loads((HERE.parent / c["file"]).read_text())
    assert cfg["source"] == c["source"]
    assert all(k in cfg for k in c["reduced"])
    from smoqyelphqmc_tpu_torch.models import library

    assert hasattr(library, f"{cfg['model']}_model") and hasattr(library, f"{cfg['model']}_spec")
    assert (HERE / "references" / f"{cfg['model']}.py").exists()


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    spec = importlib.util.spec_from_file_location(m["name"], HERE / "metrics" / f"{m['name']}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_names_and_keys_keep_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert {e["name"] for e in BENCH["end_to_end"]} >= {"setup_s", "walker_sweeps_per_s"}
    assert all(0.01 <= e["bound"] <= 0.25 for e in BENCH["end_to_end"])
