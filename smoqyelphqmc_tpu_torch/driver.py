"""The simulation driver (port of the JAX package's driver.py).

`run_simulation` is the measured single-walker simulation (the JAX
run_simulation at n_walkers = 1 and one sweep per dispatch): model
expansion from `cfg.seed`, thermalization sweeps, measured sweeps (a sweep,
the Green's-estimator refresh, the measurement pass and device-side bin
sums), a bin written every N_measurements // N_bins sweeps, wall-clock-gated
checkpoints with runtime-limit self-termination, bit-identical resume, and
the final statistics (merged bins, stats.h5, CSVs, simulation_info.toml).
Its loop is `simulate`, a generator that yields the bins in memory and
needs no h5py; only the HDF5 writing and post-processing import h5py.

`run_updates` runs update sweeps only (reflection + swap + leapfrog HMC). At
`cfg.n_walkers` = 1 every random number comes from one `torch.Generator`
seeded with `cfg.seed`; at W >= 2 (the multi-walker driver's update path)
each walker has its own generator, seeded from `cfg.seed` and its index, and
the sweeps follow `parallel.walkers.walker_sweep` with the shared
preconditioner refresh and its fallback controller. It returns the
acceptance / iteration metadata (walker-averaged), the KPM preconditioner's
diagnostics when the chain carries one, and the per-update flags a caller
needs to check the run.

At W = 1 one sweep's draws (`draw_sweep`: reflection, swap, HMC and, for a
measured sweep, the estimator's phases theta) come from the chain's
generator, in that order; `sweep` and `measured_sweep` take them as an
argument. A KPM preconditioner ('kpm', or 'auto' above 4000 sites) runs at
W = 1: its initial Lanczos start vector is the first draw of the chain's
generator (length 2N for complex hoppings). Complex hoppings run at W = 1.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .io.checkpoint import delete_checkpoints, read_checkpoint, runtime_exceeded, write_checkpoint
from .io.simulation_info import SimulationInfo, initialize_datafolder, model_summary, save_simulation_info
from .measure.container import MeasurementAccumulator, MeasurementSpec, make_measurements
from .measure.greens_estimator import (
    EstimatorUpdate,
    GreensEstimator,
    build_greens_estimator,
    draw_theta,
    update_greens_estimator,
)
from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .ops.kpm import KPMPreconditioner
from .ops.preconditioner import resolve_kind
from .parallel.walkers import PrecondFallbackController, WalkerDraws, draw_walker, init_walker_states, walker_sweep
from .tree import tree_map
from .updates.context import QMCContext, QMCState, initialize_qmc, make_fdm
from .updates.global_updates import GlobalUpdateStats, draw_reflection, draw_swap, reflection_update, swap_update
from .updates.hmc import HMCParams, HMCStats, draw_hmc, hmc_update


@dataclasses.dataclass
class SimulationConfig:
    """The JAX package's SimulationConfig, field for field, plus `fused_force`."""

    beta: float
    dtau: float = 0.05
    N_therm: int = 100
    N_measurements: int = 100
    N_bins: int = 10
    Nt: int = 24
    hmc_dt: float = 0.0  # 0 -> pi / (2 Nt)
    hmc_jitter: float = 0.05
    hmc_integrator: str = "leapfrog"  # 'omelyan' waits (ROADMAP Queue 1, item 17)
    target_acceptance: Optional[float] = None  # dt targeting waits (item 17)
    eta: float = 0.0
    Nrv: int = 10
    tol: float = 1e-10
    maxiter: int = 10_000
    seed: int = 1
    symmetric: bool = True
    use_radial_updates: bool = False  # waits (item 17)
    target_density: Optional[float] = None  # mu tuning waits (item 17)
    checkpoint_freq_hours: float = np.inf
    runtime_limit_hours: float = np.inf
    use_preconditioner: bool = True
    preconditioner: Optional[str] = None  # 'auto' | 'spectral' | 'kpm' | 'none'
    mixed_precision: bool = True
    measurement_dtype: str = "float32"
    force_dtype: str = "float32"
    # estimator-refresh solve dtype; None follows measurement_dtype
    measure_solve_dtype: Optional[str] = None
    # the W = 1 trajectory forces through the K2 solve and kernel K4 (the JAX
    # package's SMOQY_FUSED_FORCE=1)
    fused_force: bool = False
    n_walkers: int = 1
    # W >= 2: one preconditioner refresh per sweep from the walker-mean
    # fermion matrix, guarded by PrecondFallbackController (per-walker refresh
    # when a sweep's iterations exceed precond_fallback_ratio x the best seen,
    # re-probing every precond_retry_every sweeps); False = always per walker
    shared_precond: bool = True
    precond_fallback_ratio: float = 1.5
    precond_retry_every: int = 32
    sweeps_per_dispatch: int = 1  # sweep batching waits (item 18)


# the fields whose code is not ported yet: (name, ROADMAP Queue 1 item)
_UNPORTED = (("hmc_integrator", 17), ("target_acceptance", 17), ("use_radial_updates", 17),
             ("target_density", 17), ("sweeps_per_dispatch", 18))


def _check_ported(cfg: SimulationConfig) -> None:
    """Raise for a config field whose code is not ported yet."""
    defaults = {f.name: f.default for f in dataclasses.fields(SimulationConfig)}
    for name, item in _UNPORTED:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(f"SimulationConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                                      f"(ROADMAP Queue 1, item {item})")


def walker_seed(seed: int, w: int) -> int:
    """The seed of walker w's generator."""
    return int(np.random.SeedSequence([seed, w]).generate_state(1)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fold_kpm_diagnostics(metadata: Dict, precond) -> None:
    """Record a KPM preconditioner's self-diagnostics in the metadata
    (the JAX package's driver.py:fold_kpm_diagnostics): whether it is active
    in the final state (inactive means the solves ran unpreconditioned), and
    how many frequencies the static order caps clipped; warn on either. No-op
    for other preconditioners."""
    if not isinstance(precond, KPMPreconditioner):
        return
    metadata["kpm_active"] = bool(precond.active)
    metadata["kpm_inactive_walkers"] = int(not precond.active)
    metadata["kpm_order_clip_count"] = int(precond.order_clip_count)
    if not precond.active:
        warnings.warn("KPM preconditioner DEACTIVATED in the final state: Lanczos bounds outside the valid "
                      "window or the truncation-positivity guard fired, so those CG solves ran "
                      "unpreconditioned", stacklevel=2)
    if precond.order_clip_count > 0:
        warnings.warn(f"KPM order cap clipped {precond.order_clip_count} frequency orders in the final refresh",
                      stacklevel=2)


# ----------------------------------------------------------------------
# One sweep at W = 1
# ----------------------------------------------------------------------


@dataclasses.dataclass
class SweepDraws(WalkerDraws):
    """One W = 1 sweep's random numbers: a walker's, and theta (Nrv, Ltau, N)
    for a measured sweep's estimator refresh."""

    theta: Optional[torch.Tensor] = None


def draw_sweep(gen: torch.Generator, ctx: QMCContext, precond, est: Optional[GreensEstimator] = None) -> SweepDraws:
    """A sweep's draws from the chain's generator: reflection, swap, HMC,
    then, with an estimator, the phases of its refresh."""
    draws = SweepDraws(draw_reflection(gen, ctx), draw_swap(gen, ctx), draw_hmc(gen, ctx, precond))
    if est is not None:
        draws.theta = draw_theta(gen, est, ctx.device)
    return draws


class SweepStats(NamedTuple):
    reflection: GlobalUpdateStats
    swap: GlobalUpdateStats
    hmc: HMCStats

    @property
    def converged(self) -> bool:
        return self.reflection.converged and self.swap.converged and self.hmc.converged


def sweep(ctx: QMCContext, state: QMCState, params: HMCParams, draws: SweepDraws) -> tuple[QMCState, SweepStats]:
    """Reflection + swap + leapfrog HMC, each with its draws."""
    state, r = reflection_update(ctx, state, draws.reflection)
    state, s = swap_update(ctx, state, draws.swap)
    state, h = hmc_update(ctx, state, params, draws.hmc)
    return state, SweepStats(r, s, h)


def _msolve_dtype(cfg: SimulationConfig) -> Optional[str]:
    """Estimator-refresh solve dtype: cfg.measure_solve_dtype, else
    cfg.measurement_dtype ('float32', or None for the rhs's float64)."""
    dt = cfg.measure_solve_dtype or cfg.measurement_dtype
    return "float32" if dt == "float32" else None


class MeasuredSweep(NamedTuple):
    state: QMCState
    stats: SweepStats
    update: EstimatorUpdate  # the refreshed estimator, its solve's iterations and convergence
    out: Dict  # the measurement tree
    t_refresh_s: float  # host clock around the refresh, synchronised
    t_measurements_s: float  # host clock around the measurement pass, synchronised


def measured_sweep(ctx: QMCContext, state: QMCState, params: HMCParams, draws: SweepDraws, est: GreensEstimator,
                   spec: MeasurementSpec, cfg: SimulationConfig) -> MeasuredSweep:
    """A sweep, the estimator refresh at the new field with draws.theta, and
    the measurement pass (the JAX package's measured_step at k = 1)."""
    state, stats = sweep(ctx, state, params, draws)
    _sync(ctx.device)
    t0 = time.perf_counter()
    upd = update_greens_estimator(est, make_fdm(ctx, state.x), draws.theta, precond=state.precond, tol=cfg.tol,
                                  maxiter=cfg.maxiter, mixed=cfg.mixed_precision, solve_dtype=_msolve_dtype(cfg))
    _sync(ctx.device)
    t1 = time.perf_counter()
    out = make_measurements(ctx, spec, upd.estimator, state.x)
    _sync(ctx.device)
    return MeasuredSweep(state, stats, upd, out, t1 - t0, time.perf_counter() - t1)


# ----------------------------------------------------------------------
# Update sweeps
# ----------------------------------------------------------------------


def _init_chain(tbp: TightBindingParameters, elph: ElectronPhononParameters, cfg: SimulationConfig):
    """The chain's generator, context and initial state on the device of
    `elph`, and the seconds the initialization took."""
    device = elph.device
    kind = resolve_kind(cfg.preconditioner or "auto", tbp.n_sites) if cfg.use_preconditioner else None
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    v0 = None
    if kind == "kpm":  # the doubled (re, im) basis for complex hoppings
        v0 = torch.randn((2 * tbp.n_sites if tbp.t0_im is not None else tbp.n_sites,), generator=gen,
                         dtype=torch.float64)
    t0 = time.perf_counter()
    ctx, state = initialize_qmc(
        tbp, elph, symmetric=cfg.symmetric, tol=cfg.tol, maxiter=cfg.maxiter, eta=cfg.eta,
        use_preconditioner=cfg.use_preconditioner, preconditioner=cfg.preconditioner,
        mixed_precision=cfg.mixed_precision, force_dtype=cfg.force_dtype, lanczos_v0=v0,
    )
    _sync(device)
    return gen, ctx, state, time.perf_counter() - t0


def _hmc_params(cfg: SimulationConfig) -> HMCParams:
    return HMCParams(Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, fused_force=cfg.fused_force)


def _expand(tight_binding_model, electron_phonon_model, cfg: SimulationConfig, device):
    """The model's lattice-expanded parameters, drawn from cfg.seed."""
    rng = np.random.default_rng(cfg.seed)
    tbp = TightBindingParameters.from_model(tight_binding_model, rng, device=device)
    return tbp, ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, electron_phonon_model, tbp, rng,
                                                    device=device)


def run_updates(tight_binding_model, electron_phonon_model, cfg: SimulationConfig, n_sweeps: int,
                device="cuda") -> Dict:
    """Run `n_sweeps` update sweeps on `device` (the card unless the caller
    asks for the CPU); returns the metadata dict
    (acceptance rates and CG iterations per solve, averaged over sweeps, as
    run_simulation reports them) with per-sweep lists and timings."""
    return run_sweeps(*_expand(tight_binding_model, electron_phonon_model, cfg, torch.device(device)), cfg, n_sweeps)


def run_sweeps(tbp: TightBindingParameters, elph: ElectronPhononParameters, cfg: SimulationConfig,
               n_sweeps: int) -> Dict:
    """`run_updates` from expanded parameters, on the device of `elph` (for a
    caller with tables of its own, such as relabelled sites). Each sweep runs
    inside a profiler range named "sweep"."""
    _check_ported(cfg)
    device = elph.device
    kind = resolve_kind(cfg.preconditioner or "auto", tbp.n_sites) if cfg.use_preconditioner else None
    if kind == "kpm" and cfg.n_walkers > 1:
        raise NotImplementedError("the walker path with a KPM preconditioner is not ported yet "
                                  "(ROADMAP Queue 1, item 20)")
    if tbp.t0_im is not None and cfg.n_walkers > 1:
        raise NotImplementedError("the walker path with complex hoppings is not ported yet "
                                  "(ROADMAP Queue 1, item 21)")
    gen, ctx, state, t_init = _init_chain(tbp, elph, cfg)
    params = _hmc_params(cfg)
    meta: Dict = {
        "n_sweeps": n_sweeps,
        "n_walkers": cfg.n_walkers,
        "Nt": cfg.Nt,
        "tol": cfg.tol,
        "seed": cfg.seed,
        "Ltau": elph.Ltau,
        "n_sites": tbp.n_sites,
        "device": str(device),
        "t_init_s": t_init,
    }
    if cfg.n_walkers > 1:
        meta.update(_run_walkers(ctx, state, cfg, params, n_sweeps, device))
        return meta

    keys = ("reflection", "swap", "hmc")
    acc = {k: 0.0 for k in keys}
    iters = {k: 0.0 for k in keys}
    converged = []
    delta_H = []
    sweep_s = []
    for _ in range(n_sweeps):
        t0 = time.perf_counter()
        with torch.profiler.record_function("sweep"):
            state, st = sweep(ctx, state, params, draw_sweep(gen, ctx, state.precond))
            _sync(device)
        sweep_s.append(time.perf_counter() - t0)
        for k, s in zip(keys, st):
            acc[k] += float(s.accepted)
        converged.append(st.converged)
        iters["reflection"] += st.reflection.iters
        iters["swap"] += st.swap.iters
        iters["hmc"] += st.hmc.iters_avg
        delta_H.append(st.hmc.delta_H)
    n = max(n_sweeps, 1)
    meta.update({"sweep_s": sweep_s, "hmc_delta_H": delta_H, "all_converged": all(converged),
                 "x_final": state.x})
    fold_kpm_diagnostics(meta, state.precond)
    for k in keys:
        meta[f"{k}_acceptance_rate"] = acc[k] / n
        meta[f"{k}_iters"] = iters[k] / n
    return meta


def _run_walkers(ctx, state, cfg: SimulationConfig, params: HMCParams, n_sweeps: int, device) -> Dict:
    """The W >= 2 sweeps. hmc_delta_H and walker_converged are per walker;
    acceptance and iterations per solve are walker means, averaged over
    sweeps."""
    W = cfg.n_walkers
    gens = [torch.Generator(device="cpu").manual_seed(walker_seed(cfg.seed, w)) for w in range(W)]
    noise = torch.stack([0.1 * torch.randn(tuple(state.x.shape), generator=g, dtype=torch.float64) for g in gens])
    states = init_walker_states(ctx, state, noise)
    pc = PrecondFallbackController(ratio=cfg.precond_fallback_ratio, retry_every=cfg.precond_retry_every,
                                   enabled=state.precond is not None)
    keys = ("reflection", "swap", "hmc")
    acc = {k: 0.0 for k in keys}
    iters = {k: 0.0 for k in keys}
    converged = [True] * W
    delta_H = [[] for _ in range(W)]
    sweep_s = []
    fallback = 0
    for _ in range(n_sweeps):
        use_shared = cfg.shared_precond and pc.choose()
        draws = [draw_walker(g, ctx) for g in gens]
        t0 = time.perf_counter()
        with torch.profiler.record_function("sweep"):
            states, stats = walker_sweep(ctx, states, params, draws, shared_precond=use_shared)
            _sync(device)
        sweep_s.append(time.perf_counter() - t0)
        rs, ss, hs = stats
        for k, sts in zip(keys, stats):
            acc[k] += sum(float(st.accepted) for st in sts) / W
        iters["reflection"] += sum(r.iters for r in rs) / W
        iters["swap"] += sum(s.iters for s in ss) / W
        hmc_iters = sum(h.iters_avg for h in hs) / W
        iters["hmc"] += hmc_iters
        for w in range(W):
            converged[w] = converged[w] and rs[w].converged and ss[w].converged and hs[w].converged
            delta_H[w].append(hs[w].delta_H)
        pc.record(hmc_iters, use_shared)
        fallback += not use_shared
    n = max(n_sweeps, 1)
    meta: Dict = {
        "sweep_s": sweep_s,
        "hmc_delta_H": delta_H,
        "walker_converged": converged,
        "all_converged": all(converged),
        "precond_fallback_sweeps": fallback,
        "x_final": states.x,
    }
    for k in keys:
        meta[f"{k}_acceptance_rate"] = acc[k] / n
        meta[f"{k}_iters"] = iters[k] / n
    return meta


# ----------------------------------------------------------------------
# The measured simulation
# ----------------------------------------------------------------------


def _record_sweep(metadata: Dict, st: SweepStats) -> None:
    """Add one sweep's acceptance flags and iterations to the run's sums. The
    radial entry takes the reflection's flag, as the JAX package's sweep does
    without radial updates."""
    metadata["reflection_acceptance_rate"] += float(st.reflection.accepted)
    metadata["swap_acceptance_rate"] += float(st.swap.accepted)
    metadata["radial_acceptance_rate"] += float(st.reflection.accepted)
    metadata["hmc_acceptance_rate"] += float(st.hmc.accepted)
    metadata["reflection_iters"] += float(st.reflection.iters)
    metadata["swap_iters"] += float(st.swap.iters)
    metadata["hmc_iters"] += float(st.hmc.iters_avg)
    metadata["all_converged"] = metadata["all_converged"] and st.converged


def simulate(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    resume: bool = True,
    device="cuda",
):
    """The measured simulation on `device` (the card unless the caller asks
    for the CPU) as a generator: it writes the data folder's model summary
    and its checkpoints, and yields (bin index, bin-averaged NumPy tree) as
    each bin completes; it returns (metadata, finished), finished False when
    the runtime limit stopped it. `run_simulation` writes the bins to HDF5
    and post-processes a finished run; `simulate` itself needs no h5py.

    The metadata are the JAX package's keys (acceptance rates, CG iterations
    per solve, the phases' timings) plus `all_converged` (every update and
    estimator solve converged), `t_refresh_s` and `t_measurements_s`
    (seconds in estimator refreshes and in measurement passes). With resume, a checkpoint in the data folder restores x, the
    preconditioner, the generator's state, the loop counters, the metadata
    and the partial-bin sums, so that a resumed run yields the bins an
    uninterrupted one yields, bit for bit."""
    _check_ported(cfg)
    if cfg.n_walkers > 1:
        raise NotImplementedError("the measured multi-walker driver is not ported yet (ROADMAP Queue 1, item 11)")
    device = torch.device(device)
    start_time = time.time()
    initialize_datafolder(sim_info)
    geo = spec.geometry
    model_summary(sim_info, cfg.beta, cfg.dtau, geo, tight_binding_model, (electron_phonon_model,))
    tbp, elph = _expand(tight_binding_model, electron_phonon_model, cfg, device)
    gen, ctx, state, _ = _init_chain(tbp, elph, cfg)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=cfg.Nrv, dtype=cfg.measurement_dtype,
                                 device=device)
    params = _hmc_params(cfg)
    metadata: Dict = {
        "N_therm": cfg.N_therm,
        "N_measurements": cfg.N_measurements,
        "N_bins": cfg.N_bins,
        "Nt": cfg.Nt,
        "Nrv": cfg.Nrv,
        "tol": cfg.tol,
        "maxiter": cfg.maxiter,
        "seed": cfg.seed,
        "hmc_acceptance_rate": 0.0,
        "reflection_acceptance_rate": 0.0,
        "swap_acceptance_rate": 0.0,
        "radial_acceptance_rate": 0.0,
        "hmc_iters": 0.0,
        "reflection_iters": 0.0,
        "swap_iters": 0.0,
        "measurement_iters": 0.0,
        "all_converged": True,
        "t_refresh_s": 0.0,
        "t_measurements_s": 0.0,
    }

    therm_done = 0
    meas_done = 0
    cp_stamp: Optional[float] = None
    bin_size = max(cfg.N_measurements // cfg.N_bins, 1)
    acc = MeasurementAccumulator(spec)
    if resume:
        cp = read_checkpoint(sim_info.datafolder, sim_info.pID)
        if cp is not None:
            s = cp["state"]
            state = QMCState(x=torch.as_tensor(s["x"], device=device), precond=s["precond"])
            gen.set_state(torch.as_tensor(s["generator"]))
            therm_done = int(s["therm_done"])
            meas_done = int(s["meas_done"])
            metadata.update(s["metadata"])
            if s["acc_sums"] is not None:
                acc.sums = tree_map(lambda a: torch.as_tensor(a, device=device), s["acc_sums"])
                acc.count = int(s["acc_count"])

    def maybe_checkpoint():
        nonlocal cp_stamp
        # frequency gate first (the test write_checkpoint applies), so a
        # closed gate costs nothing per sweep
        if cp_stamp is not None and (time.time() - cp_stamp) < cfg.checkpoint_freq_hours * 3600.0:
            return
        tree = {
            "x": state.x,
            "precond": state.precond,
            "generator": gen.get_state(),
            "therm_done": therm_done,
            "meas_done": meas_done,
            "metadata": dict(metadata),
            "acc_sums": acc.sums,
            "acc_count": acc.count,
        }
        cp_stamp = write_checkpoint(sim_info.datafolder, tree, pID=sim_info.pID, checkpoint_timestamp=cp_stamp,
                                    checkpoint_freq_hours=cfg.checkpoint_freq_hours)

    def out_of_time() -> bool:
        return runtime_exceeded(start_time, cfg.runtime_limit_hours)

    # ------------------------------------------------------------------
    # thermalize (the first sweep of a phase carries its warm-up)
    # ------------------------------------------------------------------
    t_phase = time.time()
    n_timed = 0
    while therm_done < cfg.N_therm:
        state, st = sweep(ctx, state, params, draw_sweep(gen, ctx, state.precond))
        _record_sweep(metadata, st)
        therm_done += 1
        n_timed += 1
        if n_timed == 1:
            metadata["t_first_therm_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_therm_batch"] = 1
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time():
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, state.precond)
            return metadata, False
    if n_timed:
        metadata["t_therm_s"] = round(time.time() - t_phase, 3)
        metadata["n_therm_timed"] = n_timed

    # ------------------------------------------------------------------
    # measure
    # ------------------------------------------------------------------
    t_phase = time.time()
    n_timed = 0
    while meas_done < cfg.N_measurements:
        m = measured_sweep(ctx, state, params, draw_sweep(gen, ctx, state.precond, est), est, spec, cfg)
        state, est = m.state, m.update.estimator
        _record_sweep(metadata, m.stats)
        metadata["measurement_iters"] += float(m.update.iters)
        metadata["all_converged"] = metadata["all_converged"] and bool(m.update.converged)
        metadata["t_refresh_s"] += m.t_refresh_s
        metadata["t_measurements_s"] += m.t_measurements_s
        acc.accumulate(m.out)
        meas_done += 1
        n_timed += 1
        if n_timed == 1:
            _sync(device)
            metadata["t_first_measured_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_measured_batch"] = 1
        if meas_done % bin_size == 0:
            yield meas_done // bin_size - 1, acc.finalize_bin()
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time() and meas_done < cfg.N_measurements:
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, state.precond)
            return metadata, False
    if n_timed:
        _sync(device)
        metadata["t_measure_s"] = round(time.time() - t_phase, 3)
        metadata["n_measure_timed"] = n_timed

    n_updates = cfg.N_therm + cfg.N_measurements
    for k in ("hmc", "reflection", "swap", "radial"):
        metadata[f"{k}_acceptance_rate"] /= max(n_updates, 1)
    metadata["hmc_iters"] /= max(n_updates, 1)
    metadata["reflection_iters"] /= max(n_updates, 1)
    metadata["swap_iters"] /= max(n_updates, 1)
    metadata["measurement_iters"] /= max(cfg.N_measurements, 1)
    fold_kpm_diagnostics(metadata, state.precond)
    return metadata, True


def run_simulation(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    resume: bool = True,
    device="cuda",
) -> Dict:
    """Full simulation (`simulate`) with its binned HDF5 output: each bin to
    bins/bin-<k>_pID-<p>.h5 as it completes; a finished run then merges the
    bins, writes simulation_info.toml, the statistics (stats.h5, CSVs) and
    deletes its checkpoints. Returns the metadata dict."""
    from .io.measurements_io import merge_bins, process_measurements, write_measurement_bin

    run = simulate(sim_info, tight_binding_model, electron_phonon_model, spec, cfg, resume=resume, device=device)
    while True:
        try:
            bin_index, bin_avg = next(run)
        except StopIteration as done:
            metadata, finished = done.value
            break
        write_measurement_bin(sim_info, bin_index, bin_avg, spec, dtau=cfg.dtau)
    if finished:
        merge_bins(sim_info)
        save_simulation_info(sim_info, metadata)
        process_measurements(sim_info.datafolder, n_bins=cfg.N_bins, spec=spec)
        delete_checkpoints(sim_info.datafolder, sim_info.pID)
    return metadata
