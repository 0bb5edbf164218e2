"""One run of one benchmark cell: set-up, the measured window, the trace and
the comparison with the plain reference.

A cell (`workloads/<name>.json`) names a configuration (`configs/<name>.json`:
the model's builder in `smoqyelphqmc_tpu_torch.models.library` by its
`model` name, `<model>_model`, which takes the keys of the file that match
its parameters, and the measurement set's, `spec` where the file names one
and `<model>_spec` where it does not, given every bond of the model where it
takes `bond_ids`; every key that names a field of the port's
`SimulationConfig` goes there; the reference's model is
`references/<model>.py`) and a traffic mix (`traffic/<name>.json`:
walkers, shared refresh, sweeps a dispatch, thermalization sweeps), the
limits of its compared numbers and how many sweeps a traced run profiles.

The window drives `driver.simulate` with one measured sweep a bin, so every
measured sweep yields; the host's clock at a sweep's first yield is its end.
Set-up is loading the port, building the model, the thermalization sweeps
and the first measured sweep. The window opens at that sweep's yield and
closes at the end of the sweep after which the program's own runtime limit,
set at the opening, stops it: whole sweeps only. The program writes a
checkpoint when it stops; a traced run resumes from it for its profiled
sweeps and stops again, and the checked sweep resumes from the last stop
(see `check.py`).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import json
import math
import shutil
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, trace as tracemod
from benchmark.reference import Settings

HERE = Path(__file__).resolve().parent
BIG = 10**9  # measured sweeps and bins asked for: the runtime limit ends the run


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # workloads/<name>.json
    config: dict
    traffic: dict

    @staticmethod
    def load(name: str) -> "Cell":
        spec = load("workloads", name)
        return Cell(name, spec, load("configs", spec["config"]), load("traffic", spec["traffic"]))

    @property
    def n_walkers(self) -> int:
        return int(self.traffic["n_walkers"])

    def settings(self) -> Settings:
        """The reference's settings. A KPM preconditioner ('kpm', or 'auto'
        above 4000 sites) makes the program draw a Lanczos start vector
        after each trajectory's draws; `use_radial_updates` adds the radial
        move. Raises ValueError for a trajectory the reference does not
        replay: another integrator than the leapfrog, a timestep law
        (`target_acceptance`) or a fixed timestep (`hmc_dt`) in place of
        pi / (2 Nt)."""
        c = self.config
        off = {k: c[k] for k, plain in (("hmc_integrator", "leapfrog"), ("target_acceptance", None), ("hmc_dt", 0.0))
               if c.get(k, plain) != plain}
        if off:
            raise ValueError(f"the plain reference replays the leapfrog at pi / (2 Nt) alone, not {off}")
        kind = c.get("preconditioner", "auto")
        kpm = kind == "kpm" or (kind == "auto" and check.reference_model(c)[0].n_sites > 4000)
        return Settings(beta=c["beta"], dtau=c["dtau"], mu=c["mu"], Nt=c["Nt"], jitter=c["hmc_jitter"], tol=c["tol"],
                        Nrv=c["Nrv"], kpm=kpm, radial=bool(c.get("use_radial_updates", False)))


def unreplayed(tbm, em) -> List[str]:
    """What of the program's tight-binding and electron-phonon models the
    plain reference does not replay: it replays real hoppings and energies,
    live harmonic modes, and Holstein and SSH couplings linear in the fields
    with real constants, none of them disordered."""
    found = []
    if any(complex(t).imag for t in tbm.t_mean) or any(tbm.t_std or ()) or any(tbm.eps_std or ()):
        found.append("complex or disordered hoppings or energies")
    if any(not math.isfinite(m.M) for m in em.phonon_modes):
        found.append("a frozen phonon mode (bond SSH)")
    if any(m.Omega_std or m.Omega4_mean or m.Omega4_std for m in em.phonon_modes):
        found.append("disordered or anharmonic phonon modes")
    for kind, couplings in (("Holstein", em.holstein_couplings), ("SSH", em.ssh_couplings)):
        for c in couplings:
            if any(complex(getattr(c, f"alpha{k}_mean")).imag for k in ("", "2", "3", "4")):
                found.append(f"complex {kind} constants")
            if any(getattr(c, f"alpha{k}_mean") for k in ("2", "3", "4")):
                found.append(f"higher-order {kind} constants")
            if any(getattr(c, f"alpha{k}_std") for k in ("", "2", "3", "4")):
                found.append(f"disordered {kind} constants")
    if em.dispersion_couplings:
        found.append("dispersion couplings")
    return sorted(set(found))


def build(cell: Cell, seed: int, datadir: Path):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, SimulationConfig) of the cell at `seed`."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    lib = importlib.import_module("smoqyelphqmc_tpu_torch.models.library")
    c = cell.config
    model_fn = getattr(lib, f"{c['model']}_model")
    geo, tbm, em = model_fn(**{k: c[k] for k in inspect.signature(model_fn).parameters if k in c})
    off = unreplayed(tbm, em)
    if off:
        raise ValueError(f"the plain reference cannot replay {c['model']}: {', '.join(off)}")
    spec_fn = getattr(lib, c.get("spec", f"{c['model']}_spec"))
    bonds = {"bond_ids": list(tbm.bond_ids)} if "bond_ids" in inspect.signature(spec_fn).parameters else {}
    spec = spec_fn(geo, **bonds)
    fields = {f.name for f in dataclasses.fields(SimulationConfig)}
    t = cell.traffic
    cfg = SimulationConfig(
        **{k: v for k, v in c.items() if k in fields},
        N_therm=int(t["N_therm"]), N_measurements=BIG, N_bins=BIG, seed=int(seed), n_walkers=cell.n_walkers,
        shared_precond=bool(t.get("shared_precond", True)), sweeps_per_dispatch=int(t.get("sweeps_per_dispatch", 1)),
        checkpoint_freq_hours=math.inf, runtime_limit_hours=math.inf,
    )
    sim_info = SimulationInfo(filepath=str(datadir), datafolder_prefix=cell.name, sID=1)
    return sim_info, tbm, em, spec, cfg


@dataclasses.dataclass
class Window:
    t_open: float
    sweep_ends: List[float]  # host clock at each measured sweep's end, the opening first
    metadata: dict  # simulate's metadata at its stop: sums, not yet divided
    measured: int  # measured sweeps the run made (the first, in set-up, included)
    memory_peak: int
    trace: Optional[tracemod.Trace]

    @property
    def durations(self) -> List[float]:
        return [b - a for a, b in zip(self.sweep_ends, self.sweep_ends[1:])]

    @property
    def seconds(self) -> float:
        return self.sweep_ends[-1] - self.t_open


def _bin_index(item) -> int:
    return item[0] if len(item) == 2 else item[1]


def run_window(cell: Cell, inputs, seconds: float, device) -> Window:
    """Set-up and the window."""
    from smoqyelphqmc_tpu_torch.driver import simulate

    sim_info, tbm, em, spec, cfg = inputs
    t_call = time.time()
    gen = simulate(sim_info, tbm, em, spec, cfg, resume=False, device=device)
    last = _bin_index(next(gen))
    t_open = time.time()
    # simulate's clock started at its first step, at or after t_call
    cfg.runtime_limit_hours = (t_open + seconds - t_call) / 3600.0
    ends = [t_open]
    while True:
        try:
            item = next(gen)
        except StopIteration as stop:
            metadata, _ = stop.value
            break
        b = _bin_index(item)
        if b != last:
            ends.append(time.time())
            last = b
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    return Window(t_open, ends, metadata, last + 1, int(peak), None)


def _walker_rows(a, W: int) -> np.ndarray:
    """Checkpoint arrays as a walker batch."""
    a = np.asarray(a)
    return a[None] if W == 1 else a


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):  # the profiler's first start is slow: pay it outside
        torch.zeros(1, device=device).add_(1)
    return torch.profiler.profile(activities=acts, record_shapes=True)


@dataclasses.dataclass
class Checked:
    """The sweep the comparison checks: the fields and the walkers'
    generator states before it, the fields after it (float64 (W, n_phonon,
    Ltau) on the device) and its bins, one a walker."""

    x0: torch.Tensor
    gens: list
    x1: torch.Tensor
    trees: List[dict]


def _resume(inputs, device, n: int, profiler=None):
    """Resume the run that the last stop ended (the program resumes bit for
    bit, so these are the sweeps an uninterrupted run makes next) for n
    measured sweeps, checkpoints off as in the window, and stop it by the
    program's own runtime limit; the stop writes a checkpoint. With a
    profiler: the first sweep carries the resumed run's set-up and is not
    profiled, the next n - 1 run under the profiler, each step of the
    generator inside a `bench.sweep` range. Returns the last sweep's bins,
    one a walker."""
    from smoqyelphqmc_tpu_torch.driver import simulate

    sim_info, tbm, em, spec, cfg = inputs
    cfg = dataclasses.replace(cfg, runtime_limit_hours=0.0 if n == 1 else math.inf,
                              checkpoint_freq_hours=math.inf)
    trees: Dict[int, dict] = {}
    gen = simulate(sim_info, tbm, em, spec, cfg, resume=True, device=device)
    last, done = None, 0
    while True:
        try:
            if profiler is not None and 1 <= done < n:
                with torch.profiler.record_function(tracemod.RANGE):
                    item = next(gen)
            else:
                item = next(gen)
        except StopIteration:
            break
        b = _bin_index(item)
        if b != last:
            last, done, trees = b, done + 1, {}
            if profiler is not None and done == 1:
                profiler.start()
            if done == n:
                cfg.runtime_limit_hours = 0.0
                if profiler is not None:
                    profiler.stop()
        trees[0 if len(item) == 2 else item[0]] = item[-1]
    return [trees[w] for w in sorted(trees)]


def profile_sweeps(inputs, device, n: int) -> tracemod.Trace:
    """The trace of n measured sweeps of the resumed run (`_resume`)."""
    profiler = _profiler(device)
    _resume(inputs, device, 1 + n, profiler)
    t0 = time.time()
    tr = tracemod.read(profiler, n)
    tr.read_s = time.time() - t0
    return tr


def checked_sweep(cell: Cell, inputs, device) -> Checked:
    """One measured sweep of the resumed run (`_resume`), unprofiled, from
    the checkpoint that the last stop wrote."""
    from smoqyelphqmc_tpu_torch.io.checkpoint import read_checkpoint

    sim_info = inputs[0]
    W = cell.n_walkers
    before = read_checkpoint(sim_info.datafolder, 0)["state"]
    trees = _resume(inputs, device, 1)
    after = read_checkpoint(sim_info.datafolder, 0)["state"]
    if int(after["meas_done"]) != int(before["meas_done"]) + 1:
        raise RuntimeError(f"the checked sweep is {int(after['meas_done']) - int(before['meas_done'])} sweeps, not 1")
    gens = [before["generator"]] if W == 1 else list(before["generator"])

    def f64(a):
        return torch.as_tensor(_walker_rows(a, W), dtype=torch.float64, device=device)

    return Checked(f64(before["x"]), gens, f64(after["x"]), trees)


@dataclasses.dataclass
class Result:
    window: Window
    compared: Dict[str, float]  # the numbers compared
    limits: Dict[str, float]
    extra: dict

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= self.limits[k] for k, v in self.compared.items())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             scratch: Optional[Path] = None, control: bool = False) -> Result:
    """Set-up, the window, with `trace` the profiled sweeps
    (`profile_sweeps`), then the checked sweep (`checked_sweep`) and the
    comparison; with `control` also the control's numbers and the
    configuration precision's (`check.control`, in `extra`). The program's
    data folder lives under `scratch` (a directory under TMPDIR by default)
    and is removed at the end. Raises ValueError, before set-up, for a
    configuration the reference does not replay (`Cell.settings`,
    `unreplayed`)."""
    settings = cell.settings()
    scratch = Path(scratch or Path(tempfile.gettempdir()) / "smoqy-benchmark" / cell.name)
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        inputs = build(cell, seed, scratch)
        win = run_window(cell, inputs, seconds, device)
        marks = {"window_closed": time.time()}
        if trace:
            win.trace = profile_sweeps(inputs, device, int(cell.spec["trace_sweeps"]))
            marks["profiled"] = time.time()
        chk = checked_sweep(cell, inputs, device)
        marks["resumed"] = time.time()
        del inputs
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        limits = {k: float(v) for k, v in cell.spec["limits"].items()}
        judge = check.Judge(cell.config, settings, device, chk.x0, chk.gens,
                            float(cell.spec.get("dH_band", 0.0)), tuple(limits))
        out = judge(chk.x1, *check.program_measurements(chk.trees, device))
        marks["checked"] = time.time()
        extra = {"marks": marks, "dH": judge.dH}
        if control:
            extra.update(check.control(judge))
            marks["controlled"] = time.time()
        return Result(win, out, limits, extra)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def p90(values: List[float]) -> float:
    """The 90th percentile (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=10)[-1]


def walker_sweeps_per_s(win: Window, n_walkers: int) -> float:
    """Walker-sweeps completed in the window over its length."""
    return len(win.durations) * n_walkers / win.seconds


@dataclasses.dataclass
class LayerRun:
    """What a per-layer metric's reader (`metrics/<name>.py`, `read(run)`)
    reads: the traced sweeps, simulate's metadata sums and the cell."""

    window: Window
    cell: Cell

    @property
    def trace(self) -> Optional[tracemod.Trace]:
        return self.window.trace

    @property
    def metadata(self) -> dict:
        return self.window.metadata

    @property
    def sweeps_run(self) -> int:
        """Thermalization and measured sweeps, the metadata's sums run over."""
        return int(self.cell.traffic["N_therm"]) + self.window.measured

    def model(self):
        """The reference's model of the configuration (its sizes)."""
        return check.reference_model(self.cell.config)[0]
