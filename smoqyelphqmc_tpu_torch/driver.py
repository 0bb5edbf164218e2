"""The simulation driver (port of the JAX package's driver.py).

`run_simulation` is the measured simulation on one host (the JAX
run_simulation with one sweep per dispatch): model expansion from
`cfg.seed`, thermalization sweeps, measured sweeps (a sweep, the
Green's-estimator refresh, the measurement pass and device-side bin sums), a
bin written every N_measurements // N_bins sweeps, wall-clock-gated
checkpoints with runtime-limit self-termination, bit-identical resume, and
the final statistics (merged bins, stats.h5, CSVs, simulation_info.toml).
Its loop is `simulate`, a generator that yields the bins in memory and
needs no h5py; only the HDF5 writing and post-processing import h5py.

At `cfg.n_walkers` = 1 every random number comes from one `torch.Generator`
seeded with `cfg.seed`; at W >= 2 each walker has its own generator, seeded
from `cfg.seed` and its index, the sweeps follow
`parallel.walkers.walker_sweep` with the shared preconditioner refresh and
its fallback controller, each walker is measured with its own estimator
refresh and writes its own pID-tagged bin stream (pID = walker index). One
sweep's draws, per generator, come in the order the sweep runs: reflection,
swap, radial (with `use_radial_updates`), HMC, then the estimator's phases
theta (measured sweeps, and thermalization sweeps when tuning mu). With
every option off these are the draws of reflection + swap + HMC alone.

Options: `use_radial_updates`; `hmc_integrator` 'omelyan'; `target_density`
(mu tuning: during thermalization an estimator refresh and (n, N^2) after
each sweep feed the tuner, in the measured phase the measurement's own; one
tuner a walker at W >= 2); `target_acceptance` (the timestep law during
thermalization, one shared dt from the walker-mean acceptance at W >= 2,
frozen afterwards); `recenter` (a callable on one walker's tau-space field,
applied after every drift).

`run_updates` runs update sweeps only. It returns the acceptance /
iteration metadata (walker-averaged), the KPM preconditioner's diagnostics
when the chain carries one, and the per-update flags a caller needs to check
the run. A KPM preconditioner ('kpm', or 'auto' above 4000 sites) takes
its initial Lanczos start vector from the first draw of the generator seeded
with cfg.seed (length 2N for complex hoppings); at W >= 2 a shared refresh's
start vector comes from a generator of its own (`shared_seed`), a
per-walker refresh's from the walker's HMC draws. Every preconditioner and
hopping kind (complex hoppings, complex SSH coupling constants) runs at any
W.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .io.checkpoint import delete_checkpoints, read_checkpoint, runtime_exceeded, write_checkpoint
from .io.simulation_info import (
    SimulationInfo,
    initialize_datafolder,
    model_summary,
    save_density_tuning_profile,
    save_simulation_info,
)
from .measure.container import MeasurementAccumulator, MeasurementSpec, make_measurements
from .measure.greens_estimator import EstimatorUpdate, GreensEstimator, build_greens_estimator, update_greens_estimator
from .measure.scalar import measure_n, measure_Nsqrd
from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .ops.kpm import KPMPreconditioner
from .ops.preconditioner import resolve_kind
from .parallel.walkers import (
    PrecondFallbackController,
    SweepStats,
    WalkerDraws,
    draw_shared,
    draw_walker,
    init_walker_states,
    sync_device,
    walker_measure,
    walker_refresh,
    walker_sweep,
)
from .tree import tree_map
from .updates.context import QMCContext, QMCState, complex_hops, initialize_qmc, make_fdm, with_mu
from .updates.global_updates import radial_update, reflection_update, swap_update
from .updates.hmc import HMCParams, hmc_update
from .updates.mu_tuner import MuTunerState, init_mu_tuner, mu_tuner_update


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
    # 'leapfrog' or 'omelyan' (2 solves a step, ~3x the stable timestep: run
    # with ~Nt / 3 steps)
    hmc_integrator: str = "leapfrog"
    # None: a fixed timestep. A value in (0, 1): during thermalization
    # dt <- dt exp(0.08 (accepted - target)), clamped to [dt0 / 8, 8 dt0],
    # then frozen for the measured sweeps
    target_acceptance: Optional[float] = None
    eta: float = 0.0
    Nrv: int = 10
    tol: float = 1e-10
    maxiter: int = 10_000
    seed: int = 1
    symmetric: bool = True
    use_radial_updates: bool = False
    target_density: Optional[float] = None  # enables mu tuning
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
_UNPORTED = (("sweeps_per_dispatch", 18),)


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


def shared_seed(seed: int) -> int:
    """The seed of the shared refresh's generator (a stream apart from every
    walker's)."""
    return int(np.random.SeedSequence(seed, spawn_key=(0,)).generate_state(1)[0])


def fold_kpm_diagnostics(metadata: Dict, preconds) -> None:
    """Record the KPM preconditioners' self-diagnostics in the metadata
    (the JAX package's driver.py:fold_kpm_diagnostics), `preconds` the
    walkers' list: whether every walker's is active in the final state
    (inactive means its solves ran unpreconditioned), how many walkers' are
    not (a shared preconditioner counts once a walker), and the most
    frequencies the static order caps clipped; warn on either. No-op for
    other preconditioners."""
    pres = [p for p in preconds if isinstance(p, KPMPreconditioner)]
    if not pres:
        return
    n_inactive = sum(not p.active for p in pres)
    clips = max(int(p.order_clip_count) for p in pres)
    metadata["kpm_active"] = n_inactive == 0
    metadata["kpm_inactive_walkers"] = n_inactive
    metadata["kpm_order_clip_count"] = clips
    if n_inactive:
        warnings.warn(f"KPM preconditioner DEACTIVATED in the final state ({n_inactive} walker(s)): Lanczos "
                      "bounds outside the valid window or the truncation-positivity guard fired, so those CG "
                      "solves ran unpreconditioned", stacklevel=2)
    if clips > 0:
        warnings.warn(f"KPM order cap clipped {clips} frequency orders in the final refresh", stacklevel=2)


def dt_law(dt: float, accepted: float, target: float, dt0: float) -> float:
    """The acceptance-targeted timestep after one sweep: dt exp(0.08
    (accepted - target)) clamped to [dt0 / 8, 8 dt0]; `accepted` is the HMC
    accept flag, or the walker-mean of the flags."""
    return min(max(dt * math.exp(0.08 * (accepted - target)), dt0 / 8.0), 8.0 * dt0)


# ----------------------------------------------------------------------
# One sweep at W = 1
# ----------------------------------------------------------------------

def sweep(ctx: QMCContext, state: QMCState, params: HMCParams, draws: WalkerDraws,
          recenter=None) -> tuple[QMCState, SweepStats]:
    """Reflection + swap [+ radial] + HMC, each with its draws."""
    state, r = reflection_update(ctx, state, draws.reflection)
    state, s = swap_update(ctx, state, draws.swap)
    rad = None
    if draws.radial is not None:
        state, rad = radial_update(ctx, state, draws.radial)
    state, h = hmc_update(ctx, state, params, draws.hmc, recenter=recenter)
    return state, SweepStats(r, s, h, rad)


def _msolve_dtype(cfg: SimulationConfig) -> Optional[str]:
    """Estimator-refresh solve dtype: cfg.measure_solve_dtype, else
    cfg.measurement_dtype ('float32', or None for the rhs's float64)."""
    dt = cfg.measure_solve_dtype or cfg.measurement_dtype
    return "float32" if dt == "float32" else None


def _solve_opts(cfg: SimulationConfig) -> Dict:
    return dict(tol=cfg.tol, maxiter=cfg.maxiter, mixed=cfg.mixed_precision, solve_dtype=_msolve_dtype(cfg))


class MeasuredSweep(NamedTuple):
    state: QMCState
    stats: SweepStats
    update: EstimatorUpdate  # the refreshed estimator, its solve's iterations and convergence
    out: Dict  # the measurement tree
    t_refresh_s: float  # host clock around the refresh, synchronised
    t_measurements_s: float  # host clock around the measurement pass, synchronised


def measured_sweep(ctx: QMCContext, state: QMCState, params: HMCParams, draws: WalkerDraws, est: GreensEstimator,
                   spec: MeasurementSpec, cfg: SimulationConfig, recenter=None) -> MeasuredSweep:
    """A sweep, the estimator refresh at the new field with draws.theta, and
    the measurement pass (the JAX package's measured_step at k = 1)."""
    state, stats = sweep(ctx, state, params, draws, recenter)
    sync_device(ctx.device)
    t0 = time.perf_counter()
    upd = update_greens_estimator(est, make_fdm(ctx, state.x), draws.theta, precond=state.precond,
                                  **_solve_opts(cfg))
    sync_device(ctx.device)
    t1 = time.perf_counter()
    out = make_measurements(ctx, spec, upd.estimator, state.x)
    sync_device(ctx.device)
    return MeasuredSweep(state, stats, upd, out, t1 - t0, time.perf_counter() - t1)


# ----------------------------------------------------------------------
# The chains of a run
# ----------------------------------------------------------------------


def _init_chain(tbp: TightBindingParameters, elph: ElectronPhononParameters, cfg: SimulationConfig):
    """The chain's generator, context and initial state on the device of
    `elph`, and the seconds the initialization took."""
    device = elph.device
    kind = resolve_kind(cfg.preconditioner or "auto", tbp.n_sites) if cfg.use_preconditioner else None
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    v0 = None
    if kind == "kpm":  # the doubled (re, im) basis for complex hoppings
        v0 = torch.randn((2 * tbp.n_sites if complex_hops(tbp, elph) else tbp.n_sites,), generator=gen,
                         dtype=torch.float64)
    t0 = time.perf_counter()
    ctx, state = initialize_qmc(
        tbp, elph, symmetric=cfg.symmetric, tol=cfg.tol, maxiter=cfg.maxiter, eta=cfg.eta,
        use_preconditioner=cfg.use_preconditioner, preconditioner=cfg.preconditioner,
        mixed_precision=cfg.mixed_precision, force_dtype=cfg.force_dtype, lanczos_v0=v0,
    )
    sync_device(device)
    return gen, ctx, state, time.perf_counter() - t0


def _hmc_params(cfg: SimulationConfig) -> HMCParams:
    return HMCParams(Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, integrator=cfg.hmc_integrator,
                     fused_force=cfg.fused_force)


def _as_lists(st: SweepStats) -> SweepStats:
    """One chain's sweep stats as a walker batch's (lists of one)."""
    return SweepStats([st.reflection], [st.swap], [st.hmc], None if st.radial is None else [st.radial])


class _Pass(NamedTuple):
    """A measured sweep of every walker: lists over walkers."""

    stats: SweepStats
    updates: List[EstimatorUpdate]
    outs: List[Dict]
    t_refresh_s: float
    t_measurements_s: float


class _Chains:
    """The run's Markov chains. W = 1: one chain whose every draw comes from
    the generator seeded with cfg.seed (a KPM preconditioner's initial start
    vector its first draw). W >= 2: W walkers, each with a generator seeded
    from (cfg.seed, w) whose first draws jitter its initial field (0.1
    N(0, 1)), sweeping through walker_sweep with the shared refresh and its
    fallback controller. `mu` is None (the model's mu, the context
    untouched), a float (W = 1) or (W,) float64 values; `dt` is the HMC
    timestep. Sweep results are SweepStats of lists over walkers."""

    def __init__(self, ctx: QMCContext, state: QMCState, gen: torch.Generator, cfg: SimulationConfig,
                 params: HMCParams, recenter=None):
        self.ctx, self.cfg, self.params, self.recenter = ctx, cfg, params, recenter
        self.W = cfg.n_walkers
        self.mu = None
        self.dt = params.timestep()
        if self.W == 1:
            self.gens, self.state = [gen], state
            return
        self.gens = [torch.Generator(device="cpu").manual_seed(walker_seed(cfg.seed, w)) for w in range(self.W)]
        noise = torch.stack([0.1 * torch.randn(tuple(state.x.shape), generator=g, dtype=torch.float64)
                             for g in self.gens])
        self.states = init_walker_states(ctx, state, noise)
        self.pc = PrecondFallbackController(ratio=cfg.precond_fallback_ratio, retry_every=cfg.precond_retry_every,
                                            enabled=state.precond is not None)
        self.fallback = 0  # sweeps run with per-walker refresh
        # the shared refresh's KPM start vectors, a stream no walker draws from
        self.shared_gen = torch.Generator(device="cpu").manual_seed(shared_seed(cfg.seed))

    @property
    def x(self) -> torch.Tensor:
        """(n_phonon, Ltau) at W = 1, (W, n_phonon, Ltau) at W >= 2."""
        return self.state.x if self.W == 1 else self.states.x

    @property
    def preconds(self) -> list:
        """The walkers' preconditioners (one at W = 1)."""
        return [self.state.precond] if self.W == 1 else list(self.states.precond)

    def _params(self) -> HMCParams:
        return self.params if self.cfg.target_acceptance is None else dataclasses.replace(self.params, dt=self.dt)

    def context(self, w: int = 0) -> QMCContext:
        """Walker w's context at its mu."""
        if self.mu is None:
            return self.ctx
        return with_mu(self.ctx, self.mu if self.W == 1 else self.mu[w])

    def sweep(self, est: Optional[GreensEstimator] = None):
        """Draw and run one sweep (theta drawn with an estimator). Returns
        (thetas, SweepStats), lists over walkers."""
        params, radial = self._params(), self.cfg.use_radial_updates
        if self.W == 1:
            draws = draw_walker(self.gens[0], self.ctx, self.state.precond, params, est, radial)
            self.state, st = sweep(self.context(), self.state, params, draws, self.recenter)
            return [draws.theta], _as_lists(st)
        use_shared = self.cfg.shared_precond and self.pc.choose()
        draws = [draw_walker(g, self.ctx, self.states.precond[w], params, est, radial)
                 for w, g in enumerate(self.gens)]
        v_shared = draw_shared(self.shared_gen, self.ctx, self.states.precond[0]) if use_shared else None
        self.states, st = walker_sweep(self.ctx, self.states, params, draws, shared_precond=use_shared,
                                       mus=self.mu, recenter=self.recenter, v_shared=v_shared)
        self.pc.record(sum(h.iters_avg for h in st.hmc) / self.W, use_shared)
        self.fallback += not use_shared
        return [d.theta for d in draws], st

    def refresh(self, est: GreensEstimator, thetas) -> List[EstimatorUpdate]:
        """Each walker's estimator refresh at its field, mu and preconditioner."""
        if self.W == 1:
            return [update_greens_estimator(est, make_fdm(self.context(), self.state.x), thetas[0],
                                            precond=self.state.precond, **_solve_opts(self.cfg))]
        return walker_refresh(self.ctx, self.states, est, thetas, self.mu, **_solve_opts(self.cfg))

    def measured_sweep(self, est: GreensEstimator, spec: MeasurementSpec) -> _Pass:
        """A sweep, each walker's estimator refresh and measurement pass."""
        if self.W == 1:
            draws = draw_walker(self.gens[0], self.ctx, self.state.precond, self._params(), est,
                                self.cfg.use_radial_updates)
            m = measured_sweep(self.context(), self.state, self._params(), draws, est, spec, self.cfg, self.recenter)
            self.state = m.state
            return _Pass(_as_lists(m.stats), [m.update], [m.out], m.t_refresh_s, m.t_measurements_s)
        thetas, stats = self.sweep(est)
        m = walker_measure(self.ctx, spec, self.states, est, thetas, self.mu, **_solve_opts(self.cfg))
        return _Pass(stats, m.updates, m.outs, m.t_refresh_s, m.t_measurements_s)

    def state_dict(self) -> Dict:
        """The chains' checkpoint: fields, preconditioner(s), generator
        state(s) and, at W >= 2, the fallback controller."""
        if self.W == 1:
            return {"x": self.state.x, "precond": self.state.precond, "generator": self.gens[0].get_state()}
        return {"x": self.states.x, "precond": list(self.states.precond),
                "generator": [g.get_state() for g in self.gens], "controller": self.pc.state_dict(),
                "fallback": self.fallback, "shared_generator": self.shared_gen.get_state()}

    def load_state(self, s: Dict) -> None:
        x = torch.as_tensor(s["x"], device=self.ctx.device)
        if self.W == 1:
            self.state = QMCState(x=x, precond=s["precond"])
            self.gens[0].set_state(torch.as_tensor(s["generator"]))
            return
        self.states = dataclasses.replace(self.states, x=x, precond=list(s["precond"]))
        for g, gs in zip(self.gens, s["generator"]):
            g.set_state(torch.as_tensor(gs))
        self.pc.load_state(s["controller"])
        self.fallback = int(s["fallback"])
        self.shared_gen.set_state(torch.as_tensor(s["shared_generator"]))


def _mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def _record_sweep(metadata: Dict, st: SweepStats) -> None:
    """Add one sweep's walker-mean acceptance flags and iterations to the
    run's sums. Without radial updates the radial entry takes the
    reflection's flag, as the JAX package's sweep does."""
    metadata["reflection_acceptance_rate"] += _mean(float(r.accepted) for r in st.reflection)
    metadata["swap_acceptance_rate"] += _mean(float(s.accepted) for s in st.swap)
    metadata["radial_acceptance_rate"] += _mean(float(r.accepted) for r in (st.radial or st.reflection))
    metadata["hmc_acceptance_rate"] += _mean(float(h.accepted) for h in st.hmc)
    metadata["reflection_iters"] += _mean(float(r.iters) for r in st.reflection)
    metadata["swap_iters"] += _mean(float(s.iters) for s in st.swap)
    metadata["hmc_iters"] += _mean(float(h.iters_avg) for h in st.hmc)
    metadata["all_converged"] = metadata["all_converged"] and all(u.converged for ups in st for u in ups)


def _rates() -> Dict:
    return {f"{k}_{m}": 0.0 for m in ("acceptance_rate", "iters") for k in ("hmc", "reflection", "swap", "radial")
            if f"{k}_{m}" != "radial_iters"}


# ----------------------------------------------------------------------
# Update sweeps
# ----------------------------------------------------------------------


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
    inside a profiler range named "sweep". The timestep law of
    `target_acceptance` runs on every sweep; mu tuning needs the measured
    simulation. hmc_delta_H is a list a walker at W >= 2, with
    walker_converged and precond_fallback_sweeps."""
    _check_ported(cfg)
    if cfg.target_density is not None:
        raise ValueError("SimulationConfig.target_density tunes mu from measurements: use simulate / run_simulation")
    device = elph.device
    gen, ctx, state, t_init = _init_chain(tbp, elph, cfg)
    params = _hmc_params(cfg)
    chains = _Chains(ctx, state, gen, cfg, params)
    W = cfg.n_walkers
    dt0 = chains.dt
    meta: Dict = {
        "n_sweeps": n_sweeps,
        "n_walkers": W,
        "Nt": cfg.Nt,
        "tol": cfg.tol,
        "seed": cfg.seed,
        "Ltau": elph.Ltau,
        "n_sites": tbp.n_sites,
        "device": str(device),
        "t_init_s": t_init,
        "all_converged": True,
        **_rates(),
    }
    converged = [True] * W
    delta_H = [[] for _ in range(W)]
    sweep_s = []
    for _ in range(n_sweeps):
        t0 = time.perf_counter()
        with torch.profiler.record_function("sweep"):
            _, st = chains.sweep()
            sync_device(device)
        sweep_s.append(time.perf_counter() - t0)
        _record_sweep(meta, st)
        if cfg.target_acceptance is not None:
            chains.dt = dt_law(chains.dt, _mean(float(h.accepted) for h in st.hmc), cfg.target_acceptance, dt0)
        for w in range(W):
            converged[w] = converged[w] and all(ups[w].converged for ups in st)
            delta_H[w].append(st.hmc[w].delta_H)
    n = max(n_sweeps, 1)
    for k in _rates():
        meta[k] /= n
    meta.update({"sweep_s": sweep_s, "x_final": chains.x})
    if cfg.target_acceptance is not None:
        meta["hmc_dt_final"] = chains.dt
    fold_kpm_diagnostics(meta, chains.preconds)
    if W == 1:
        meta["hmc_delta_H"] = delta_H[0]
    else:
        meta.update({"hmc_delta_H": delta_H, "walker_converged": converged,
                     "precond_fallback_sweeps": chains.fallback})
    return meta


# ----------------------------------------------------------------------
# The measured simulation
# ----------------------------------------------------------------------


def _tuner_inputs(upds: List[EstimatorUpdate], W: int):
    """(2 n, <N^2>) of each walker's refreshed estimator: floats at W = 1,
    (W,) float64 CPU tensors at W >= 2 (the estimator's dtype, read as
    float64, as the JAX package's tuner reads its f32 measurements)."""
    n = [float(2.0 * measure_n(u.estimator).real) for u in upds]
    N2 = [float(measure_Nsqrd(u.estimator).real) for u in upds]
    if W == 1:
        return n[0], N2[0]
    return torch.tensor(n, dtype=torch.float64), torch.tensor(N2, dtype=torch.float64)


def _copy_leaf(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


def simulate(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    recenter=None,
    resume: bool = True,
    device="cuda",
):
    """The measured simulation on `device` (the card unless the caller asks
    for the CPU) as a generator: it writes the data folder's model summary,
    its checkpoints and, when tuning mu, one density-tuning profile a walker
    at the end, and yields each bin as it completes: (bin index, bin-averaged
    NumPy tree) at W = 1, (pID, bin index, tree) for each walker at W >= 2
    (pID = walker index). It returns (metadata, finished), finished False
    when the runtime limit stopped it. `run_simulation` writes the bins to
    HDF5 and post-processes a finished run; `simulate` itself needs no h5py.

    The metadata are the JAX package's keys (acceptance rates and CG
    iterations per solve, walker means at W >= 2; the phases' timings;
    n_walkers, precond_fallback_sweeps and final_mu_per_walker at W >= 2,
    final_mu at W = 1, hmc_dt_final with target_acceptance) plus
    `all_converged` (every update and estimator solve converged),
    `t_refresh_s` and `t_measurements_s` (seconds in estimator refreshes and
    in measurement passes). With resume, a checkpoint in the data folder
    (under sim_info.pID) restores the fields, the preconditioner(s), the
    generators' states, the fallback controller, the loop counters, the
    metadata, dt, mu, the tuner(s) and the tuning history, and each walker's
    partial-bin sums, so that a resumed run yields the bins an uninterrupted
    one yields, bit for bit."""
    _check_ported(cfg)
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
    chains = _Chains(ctx, state, gen, cfg, params, recenter)
    W = cfg.n_walkers
    dt0 = chains.dt
    tuner: Optional[MuTunerState] = None
    history: list = []  # one (mu, n, N^2) a tuner update
    if cfg.target_density is not None:
        tuner = init_mu_tuner(cfg.target_density, cfg.beta, tbp.n_sites, float(tbp.mu),
                              n_walkers=W if W > 1 else 0)
        chains.mu = tuner.mu
    metadata: Dict = {
        **({"n_walkers": W} if W > 1 else {}),
        "N_therm": cfg.N_therm,
        "N_measurements": cfg.N_measurements,
        "N_bins": cfg.N_bins,
        "Nt": cfg.Nt,
        "Nrv": cfg.Nrv,
        "tol": cfg.tol,
        "maxiter": cfg.maxiter,
        "seed": cfg.seed,
        **_rates(),
        "measurement_iters": 0.0,
        "all_converged": True,
        "t_refresh_s": 0.0,
        "t_measurements_s": 0.0,
    }

    therm_done = 0
    meas_done = 0
    cp_stamp: Optional[float] = None
    bin_size = max(cfg.N_measurements // cfg.N_bins, 1)
    accs = [MeasurementAccumulator(spec) for _ in range(W)]
    if resume:
        cp = read_checkpoint(sim_info.datafolder, sim_info.pID)
        if cp is not None:
            s = cp["state"]
            chains.load_state(s)
            therm_done = int(s["therm_done"])
            meas_done = int(s["meas_done"])
            metadata.update(s["metadata"])
            chains.dt = float(s["dt"])
            if tuner is not None:
                tuner = tuner.with_leaves(s["tuner"])
                chains.mu = tuner.mu
                history = list(s["tuning_history"])
            for a, sums, count in zip(accs, s["acc_sums"], s["acc_count"]):
                if sums is not None:
                    a.sums = tree_map(lambda v: torch.as_tensor(v, device=device), sums)
                    a.count = int(count)

    def maybe_checkpoint():
        nonlocal cp_stamp
        # frequency gate first (the test write_checkpoint applies), so a
        # closed gate costs nothing per sweep
        if cp_stamp is not None and (time.time() - cp_stamp) < cfg.checkpoint_freq_hours * 3600.0:
            return
        tree = {
            **chains.state_dict(),
            "therm_done": therm_done,
            "meas_done": meas_done,
            "metadata": dict(metadata),
            "dt": chains.dt,
            "tuner": None if tuner is None else tuner.leaves(),
            "tuning_history": list(history),
            "acc_sums": [a.sums for a in accs],
            "acc_count": [a.count for a in accs],
        }
        cp_stamp = write_checkpoint(sim_info.datafolder, tree, pID=sim_info.pID, checkpoint_timestamp=cp_stamp,
                                    checkpoint_freq_hours=cfg.checkpoint_freq_hours)

    def out_of_time() -> bool:
        return runtime_exceeded(start_time, cfg.runtime_limit_hours)

    def tune(upds):
        nonlocal tuner
        n, N2 = _tuner_inputs(upds, W)
        tuner = mu_tuner_update(tuner, n, N2)
        chains.mu = tuner.mu
        history.append((_copy_leaf(tuner.mu), n, N2))

    # ------------------------------------------------------------------
    # thermalize (the first sweep of a phase carries its warm-up); dt
    # follows the acceptance law, mu the tuner
    # ------------------------------------------------------------------
    t_phase = time.time()
    n_timed = 0
    while therm_done < cfg.N_therm:
        thetas, st = chains.sweep(est if tuner is not None else None)
        _record_sweep(metadata, st)
        if cfg.target_acceptance is not None:
            chains.dt = dt_law(chains.dt, _mean(float(h.accepted) for h in st.hmc), cfg.target_acceptance, dt0)
        if tuner is not None:
            tune(chains.refresh(est, thetas))
        therm_done += 1
        n_timed += 1
        if n_timed == 1:
            metadata["t_first_therm_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_therm_batch"] = 1
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time():
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, chains.preconds)
            return metadata, False
    if n_timed:
        metadata["t_therm_s"] = round(time.time() - t_phase, 3)
        metadata["n_therm_timed"] = n_timed

    # ------------------------------------------------------------------
    # measure (dt frozen; mu tuned from each measured sweep's refresh)
    # ------------------------------------------------------------------
    t_phase = time.time()
    n_timed = 0
    while meas_done < cfg.N_measurements:
        m = chains.measured_sweep(est, spec)
        _record_sweep(metadata, m.stats)
        metadata["measurement_iters"] += _mean(float(u.iters) for u in m.updates)
        metadata["all_converged"] = metadata["all_converged"] and all(bool(u.converged) for u in m.updates)
        metadata["t_refresh_s"] += m.t_refresh_s
        metadata["t_measurements_s"] += m.t_measurements_s
        for a, out in zip(accs, m.outs):
            a.accumulate(out)
        if tuner is not None:
            tune(m.updates)
        meas_done += 1
        n_timed += 1
        if n_timed == 1:
            sync_device(device)
            metadata["t_first_measured_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_measured_batch"] = 1
        if meas_done % bin_size == 0:
            b = meas_done // bin_size - 1
            if W == 1:
                yield b, accs[0].finalize_bin()
            else:
                for w, a in enumerate(accs):
                    yield w, b, a.finalize_bin()
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time() and meas_done < cfg.N_measurements:
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, chains.preconds)
            return metadata, False
    if n_timed:
        sync_device(device)
        metadata["t_measure_s"] = round(time.time() - t_phase, 3)
        metadata["n_measure_timed"] = n_timed

    n_updates = cfg.N_therm + cfg.N_measurements
    for k in _rates():
        metadata[k] /= max(n_updates, 1)
    metadata["measurement_iters"] /= max(cfg.N_measurements, 1)
    fold_kpm_diagnostics(metadata, chains.preconds)
    if W > 1:
        metadata["precond_fallback_sweeps"] = chains.fallback
    if cfg.target_acceptance is not None:
        metadata["hmc_dt_final"] = chains.dt
    if tuner is not None:
        if W == 1:
            metadata["final_mu"] = float(tuner.mu)
            save_density_tuning_profile(sim_info, history)
        else:
            metadata["final_mu_per_walker"] = [float(v) for v in tuner.mu]
            for w in range(W):
                save_density_tuning_profile(sim_info.with_pID(w), [tuple(float(v[w]) for v in row) for row in history])
    return metadata, True


def run_simulation(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    recenter=None,
    resume: bool = True,
    device="cuda",
) -> Dict:
    """Full simulation (`simulate`) with its binned HDF5 output: each bin to
    bins/bin-<k>_pID-<p>.h5 as it completes (p = the walker's pID at
    W >= 2); a finished run then merges the bins, writes
    simulation_info.toml, the statistics (stats.h5, CSVs) and deletes its
    checkpoints. Returns the metadata dict."""
    from .io.measurements_io import merge_bins, process_measurements, write_measurement_bin

    run = simulate(sim_info, tight_binding_model, electron_phonon_model, spec, cfg, recenter=recenter, resume=resume,
                   device=device)
    while True:
        try:
            item = next(run)
        except StopIteration as done:
            metadata, finished = done.value
            break
        info = sim_info if len(item) == 2 else sim_info.with_pID(item[0])
        write_measurement_bin(info, item[-2], item[-1], spec, dtau=cfg.dtau)
    if finished:
        merge_bins(sim_info)
        save_simulation_info(sim_info, metadata)
        process_measurements(sim_info.datafolder, n_bins=cfg.N_bins, spec=spec)
        delete_checkpoints(sim_info.datafolder, sim_info.pID)
    return metadata
