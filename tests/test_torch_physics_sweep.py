"""The CDW study's twin (smoqyelphqmc_tpu_torch.physics_sweep) against
scripts/physics_sweep.py: what each point hands the simulation, argument for
argument (data folder, every SimulationConfig field but the checkpoint
interval and the runtime limit, the seed, the measurement set, the
q-neighbours, and the model expanded from one NumPy seed in both packages);
then a tiny run on the CPU: its rows and CSV, the same run stopped after
every batch and resumed (rows and bin files equal to the uninterrupted
run's, bit for bit, but for the timings), a finished point skipped on
--resume, and the module's import without jax."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_examples import _assert_same_expansion, _requests

from smoqyelphqmc_tpu_torch import physics_sweep

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT_KEYS = ["L", "beta", "Rcdw", "Rcdw_err", "wall_s", "walkers", "therm", "meas", "bins_total"]
# the keys of a row that time the run
TIMINGS = {"wall_s", "s_per_therm_sweep", "s_per_measured_sweep", "segments_s"}
TINY = ["--Ls", "2", "--betas", "1", "--therm", "2", "--meas", "4", "--bins", "2", "--walkers", "2", "--device", "cpu"]


def _script_points(argv, monkeypatch):
    """Run scripts/physics_sweep.py's main with argv, its simulation and ratio
    patched out; returns [(run_simulation's arguments and keywords, the
    ratio call's arguments and keywords)], one a point."""
    import bench
    import smoqyelphqmc_tpu.driver as jdriver
    import smoqyelphqmc_tpu.io as jio

    sims, ratios = [], []
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["physics_sweep.py"] + argv)
    monkeypatch.setattr(bench, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jdriver, "run_simulation", lambda *a, **k: sims.append((a, k)) or {})
    monkeypatch.setattr(jio, "compute_composite_correlation_ratio", lambda *a, **k: ratios.append((a, k)) or (0j, 0.0))
    spec = importlib.util.spec_from_file_location("_jax_physics_sweep", ROOT / "scripts" / "physics_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return list(zip(sims, ratios))


@pytest.mark.parametrize("flags", [[], ["--Ls", "3,2", "--betas", "1.5,0.7", "--therm", "5", "--meas", "6",
                                        "--bins", "3", "--walkers", "2"]], ids=["defaults", "flags"])
def test_points_match_the_script(flags, tmp_path, monkeypatch):
    """For each point of the script's defaults (the ten (L, beta) of the
    study) and of a set of other flags: the twin's data folder, config (all
    but checkpoint_freq_hours and runtime_limit_hours), measurement set,
    model expansion and q-neighbours are the script's; the script starts
    each point afresh, as the twin does without --resume."""
    argv = flags + ["--out", str(tmp_path)]
    points = _script_points(argv, monkeypatch)
    args = physics_sweep.parse_args(argv)
    assert len(points) == len(args.Ls) * len(args.betas) == (10 if not flags else 4)
    mine = [(L, beta) for L in args.Ls for beta in args.betas]
    for (L, beta), ((sim, kw), (rargs, rkw)) in zip(mine, points):
        jinfo, jtbm, jem, jspec, jcfg = sim
        assert kw == {"resume": False}
        pinfo, ptbm, pem, pspec, pcfg = physics_sweep.point_setup(L, beta, args)
        assert (pinfo.filepath, pinfo.datafolder_prefix, pinfo.sID, pinfo.pID) == (
            jinfo.filepath, jinfo.datafolder_prefix, jinfo.sID, jinfo.pID)
        assert pinfo.filepath == physics_sweep.point_folder(str(tmp_path), L, beta)
        differ = {"checkpoint_freq_hours", "runtime_limit_hours"}
        for f in dataclasses.fields(jcfg):
            if f.name not in differ:
                assert getattr(pcfg, f.name) == getattr(jcfg, f.name), (L, beta, f.name)
        assert pcfg.seed == 1000 + 7 * L + int(10 * beta)
        assert _requests(pspec) == _requests(jspec)
        _assert_same_expansion(jtbm, jem, ptbm, pem, jcfg.beta, jcfg.dtau, jcfg.seed)
        assert rargs == (jinfo.datafolder, "cdw") and rkw["q_point"] == (0, 0) and rkw["spec"] is jspec
        assert rkw["q_neighbors"] == physics_sweep.cdw_neighbors(L)


def _bin_bytes(out) -> dict:
    return {p.relative_to(out).as_posix(): p.read_bytes() for p in Path(out).rglob("bins/*.pkl")}


def test_tiny_run_resume_and_skip(tmp_path, monkeypatch, capsys):
    """A tiny run on the CPU writes the script's rows and CSV; the same run
    stopped after every batch (runtime limit 0) and resumed each time ends
    with the uninterrupted run's row (but its timings) and bin files, bit
    for bit; a further --resume skips the finished point."""
    from smoqyelphqmc_tpu_torch import driver

    full, cut = tmp_path / "full", tmp_path / "cut"
    assert physics_sweep.main(TINY + ["--out", str(full)]) == 0
    rows = json.loads((full / "results.json").read_text())
    assert len(rows) == 1 and list(rows[0])[:len(SCRIPT_KEYS)] == SCRIPT_KEYS
    row = rows[0]
    assert (row["L"], row["beta"], row["walkers"], row["therm"], row["meas"], row["bins_total"]) == (2, 1.0, 2, 2, 4, 4)
    assert row["all_converged"] and row["seed"] == 1000 + 14 + 10
    assert abs(row["Rcdw"] - row["Rcdw_unrounded"]) <= 5e-5
    csv = (full / "rcdw_vs_beta.csv").read_text().splitlines()
    assert csv == ["L,beta,Rcdw,Rcdw_err,walkers,therm,meas,bins_total",
                   f"2,1.0,{row['Rcdw']},{row['Rcdw_err']},2,2,4,4"]
    assert "| 2 | 1 |" in capsys.readouterr().out

    segments = 0
    argv = TINY + ["--out", str(cut), "--runtime-limit-minutes", "0"]
    while not (cut / "results.json").exists() or not json.loads((cut / "results.json").read_text()):
        assert physics_sweep.main(argv + (["--resume"] if segments else [])) == 0
        segments += 1
        assert segments <= 7
    assert segments == 6  # 2 + 4 sweeps, one a segment
    resumed = json.loads((cut / "results.json").read_text())[0]
    assert len(resumed["segments_s"]) == 6
    assert {k: v for k, v in resumed.items() if k not in TIMINGS} == {
        k: v for k, v in row.items() if k not in TIMINGS}
    assert _bin_bytes(full) == _bin_bytes(cut) and len(_bin_bytes(full)) == 4

    def boom(*a, **k):
        raise AssertionError("a finished point ran again")

    monkeypatch.setattr(driver, "simulate", boom)
    assert physics_sweep.main(TINY + ["--out", str(full), "--resume"]) == 0
    assert json.loads((full / "results.json").read_text()) == rows


def test_cuda_is_the_default_and_not_a_fallback(monkeypatch, tmp_path):
    """The twin runs on the card unless asked for the CPU; with no card and
    no --device cpu it stops with an error and runs nothing."""
    assert physics_sweep.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert physics_sweep.main(["--out", str(tmp_path / "x")]) != 0
    assert not (tmp_path / "x").exists()


def test_twin_imports_no_jax(tmp_path):
    """The twin's module loads no jax and nothing of the JAX package (a fresh
    process, from an empty directory)."""
    code = (
        "import sys\n"
        "from smoqyelphqmc_tpu_torch import physics_sweep\n"
        "physics_sweep.parse_args([])\n"
        "assert not {k.split('.')[0] for k in sys.modules} & {'jax', 'smoqyelphqmc_tpu'}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

