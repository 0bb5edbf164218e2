"""The simulation driver (port of the JAX package's driver.py).

`run_simulation` is the measured simulation (the JAX run_simulation and
_run_multiwalker): model expansion from `cfg.seed`, thermalization sweeps,
measured sweeps (a sweep, the Green's-estimator refresh, the measurement
pass and the bin sums), a bin written every N_measurements // N_bins
sweeps, wall-clock-gated checkpoints with runtime-limit self-termination,
bit-identical resume, and the final statistics (merged bins, stats.h5, CSVs,
simulation_info.toml). Its loop is `simulate`, a generator that yields the
bins in memory and needs no h5py; only the HDF5 writing and post-processing
import h5py.

Sweeps run in batches of `cfg.sweeps_per_dispatch` on the JAX package's
absolute grid (`_batch`): a batch ends at a multiple of k, at the end of its
phase and, when measuring, at the next bin end, so a resumed run partitions
its sweeps as an uninterrupted one does; mu tuning forces k = 1. Each sweep
of a batch records its statistics, its timestep-law step and its bin sums as
at k = 1; once a batch come the fallback controller's choice and feedback,
the checkpoint and stop decisions and the timing points. The port runs
eagerly, so a batch coarsens the host's bookkeeping and replays nothing.

In a fleet (`parallel.distributed`: P processes, one a card) each process
runs the walkers of its block (`local_walker_ids`), with the chains one
process with all W walkers gives: the shared refresh, the controller, the
timestep law and the metadata's walker means read every walker's values
(gathered); rank 0 alone creates the data folder (its sID broadcast), writes
the model summary, decides when to checkpoint and stop, and runs the final
merge and statistics; each process yields and writes the bins of its own
pIDs and checkpoints its block under its rank.

The run's `cfg.n_walkers` = W chains are a walker batch, one chain a batch
of one: every sweep runs `parallel.walkers.walker_sweep` and every measured
sweep `walker_measure`, whatever W. At W = 1 every random number comes from
one `torch.Generator` seeded with `cfg.seed` and each trajectory refreshes
the chain's preconditioner at its start; at W >= 2 each walker has its own
generator, seeded from `cfg.seed` and its index, the sweeps take the shared
preconditioner refresh under its fallback controller, and each walker writes
its own pID-tagged bin stream (pID = walker index). One sweep's draws, per
generator, come in the order the sweep runs: reflection, swap, radial (with
`use_radial_updates`), HMC, then the estimator's phases theta (measured
sweeps, and thermalization sweeps when tuning mu). With every option off
these are the draws of reflection + swap + HMC alone.

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

from .io.checkpoint import checkpoint_due, delete_checkpoints, read_checkpoint, runtime_exceeded, write_checkpoint
from .io.simulation_info import (
    SimulationInfo,
    initialize_datafolder,
    model_summary,
    save_density_tuning_profile,
    save_simulation_info,
)
from .measure.container import MeasurementAccumulator, MeasurementSpec
from .measure.greens_estimator import EstimatorUpdate, GreensEstimator, build_greens_estimator
from .measure.scalar import measure_n, measure_Nsqrd
from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .ops.kpm import KPMPreconditioner
from .ops.preconditioner import resolve_kind
from .parallel.distributed import (
    all_gather_object,
    barrier,
    broadcast_object,
    gather_walkers,
    local_walker_ids,
    process_count,
    process_index,
)
from .parallel.walkers import (
    PrecondFallbackController,
    SweepStats,
    WalkerStates,
    draw_shared,
    draw_walker,
    init_walker_states,
    sync_device,
    walker_measure,
    walker_refresh,
    walker_sweep,
)
from .tracing import FORCE_ROUTES, force_routes_since, span
from .tree import tree_map
from .updates.context import QMCContext, QMCState, complex_hops, initialize_qmc
from .updates.hmc import HMCParams
from .updates.mu_tuner import MuTunerState, init_mu_tuner, mu_tuner_update


@dataclasses.dataclass
class SimulationConfig:
    """The JAX package's SimulationConfig, field for field."""

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
    n_walkers: int = 1
    # W >= 2: one preconditioner refresh per sweep from the walker-mean
    # fermion matrix, guarded by PrecondFallbackController (per-walker refresh
    # when a sweep's iterations exceed precond_fallback_ratio x the best seen,
    # re-probing every precond_retry_every sweeps); False = always per walker
    shared_precond: bool = True
    precond_fallback_ratio: float = 1.5
    precond_retry_every: int = 32
    # sweeps a batch, on the absolute grid of `_batch` (1 while tuning mu);
    # the fallback controller's feedback and the checkpoint / stop checks
    # come once a batch
    sweeps_per_dispatch: int = 1


def _batch(done: int, k_disp: int, *ends: int) -> int:
    """The size of the batch that starts after `done` sweeps: up to the next
    multiple of k_disp, clipped at each of `ends` (the JAX package's driver
    _batch, its sweep-index grid absolute so that a resumed run partitions
    its sweeps as an uninterrupted one does)."""
    k = k_disp - done % k_disp
    for e in ends:
        k = min(k, e - done)
    return max(k, 1)


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
    other preconditioners. In a fleet `preconds` are this process's block,
    and every process's walkers are folded in (`distributed.gather_walkers`)."""
    pres = [p for p in preconds if isinstance(p, KPMPreconditioner)]
    if not pres:
        return
    flags = torch.tensor([[float(not p.active), float(p.order_clip_count)] for p in pres], dtype=torch.float64)
    flags = gather_walkers(flags)
    n_inactive = int(flags[:, 0].sum())
    clips = int(flags[:, 1].max())
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


def _msolve_dtype(cfg: SimulationConfig) -> Optional[str]:
    """Estimator-refresh solve dtype: cfg.measure_solve_dtype, else
    cfg.measurement_dtype ('float32', or None for the rhs's float64)."""
    dt = cfg.measure_solve_dtype or cfg.measurement_dtype
    return "float32" if dt == "float32" else None


def _solve_opts(cfg: SimulationConfig) -> Dict:
    return dict(tol=cfg.tol, maxiter=cfg.maxiter, mixed=cfg.mixed_precision, solve_dtype=_msolve_dtype(cfg))


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
    return HMCParams(Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, integrator=cfg.hmc_integrator)


# a sweep's row a walker (`_walker_rows`): the acceptance flags and iteration
# counts the metadata average over walkers, whether its updates converged
# and, for a measured sweep, its estimator refresh's iterations and
# convergence
_RATE_COLS = ("reflection_acceptance_rate", "swap_acceptance_rate", "radial_acceptance_rate", "hmc_acceptance_rate",
              "reflection_iters", "swap_iters", "hmc_iters")
_HMC_ACC, _HMC_ITERS, _CONVERGED, _MEAS_ITERS, _MEAS_CONVERGED = 3, 6, 7, 8, 9


def _walker_rows(st: SweepStats, updates: Optional[List[EstimatorUpdate]] = None) -> torch.Tensor:
    """(walkers, 8), with updates (walkers, 10), float64 rows of one sweep
    (the columns above). Without radial updates the radial entry takes the
    reflection's flag, as the JAX package's sweep does."""
    cols = [[float(r.accepted) for r in st.reflection], [float(s.accepted) for s in st.swap],
            [float(r.accepted) for r in (st.radial or st.reflection)], [float(h.accepted) for h in st.hmc],
            [float(r.iters) for r in st.reflection], [float(s.iters) for s in st.swap],
            [float(h.iters_avg) for h in st.hmc],
            [float(all(ups[w].converged for ups in st)) for w in range(len(st.hmc))]]
    if updates is not None:
        cols += [[float(u.iters) for u in updates], [float(bool(u.converged)) for u in updates]]
    return torch.tensor(cols, dtype=torch.float64).T


def _col_mean(rows: torch.Tensor, j: int) -> float:
    """The walker mean of column j, summed in walker order."""
    values = rows[:, j].tolist()
    return sum(values) / len(values)


def _record_rows(metadata: Dict, rows: torch.Tensor) -> None:
    """Add one sweep's walker-mean acceptance flags and iterations to the
    run's sums."""
    for j, key in enumerate(_RATE_COLS):
        metadata[key] += _col_mean(rows, j)
    metadata["all_converged"] = metadata["all_converged"] and bool(rows[:, _CONVERGED].all())


def _rates() -> Dict:
    return {f"{k}_{m}": 0.0 for m in ("acceptance_rate", "iters") for k in ("hmc", "reflection", "swap", "radial")
            if f"{k}_{m}" != "radial_iters"}


class _Sweep(NamedTuple):
    """A sweep of every walker: lists over this process's walkers, and the
    rows of every walker (`_walker_rows`, gathered in a fleet)."""

    thetas: list
    stats: SweepStats
    rows: torch.Tensor


class _Pass(NamedTuple):
    """A measured sweep of every walker: lists over this process's walkers,
    and the rows of every walker."""

    stats: SweepStats
    updates: List[EstimatorUpdate]
    outs: List[Dict]
    rows: torch.Tensor
    t_refresh_s: float
    t_measurements_s: float


class _Chains:
    """The run's Markov chains: a batch of W walkers (`states`, fields (owned
    walkers, n_phonon, Ltau)), each with its generator (`gens`), swept by
    walker_sweep and measured by walker_measure. This process runs the
    walkers `owned`: its block of pIDs in a fleet (`local_walker_ids`), all
    W otherwise; what the walkers share is gathered from every process. At
    W >= 2 walker w's generator is seeded from (cfg.seed, w) and its first
    draws jitter its initial field (0.1 N(0, 1)); the shared refresh and its
    fallback controller run. `mu` is None (the model's mu, the context
    untouched), a float (the scalar tuner's, W = 1) or the owned walkers'
    float64 values; `dt` is the HMC timestep."""

    def __init__(self, ctx: QMCContext, state: QMCState, gen: torch.Generator, cfg: SimulationConfig,
                 params: HMCParams, recenter=None):
        self.ctx, self.cfg, self.params, self.recenter = ctx, cfg, params, recenter
        self.W = cfg.n_walkers
        self.mu = None
        self.dt = params.timestep()
        self.owned = list(local_walker_ids(self.W))
        if self.W == 1:  # the one-chain run: every draw from `gen` (seeded with cfg.seed), the field unjittered
            self.gens, self.states = [gen], WalkerStates(x=state.x[None], precond=[state.precond])
            return
        self.gens = [torch.Generator(device="cpu").manual_seed(walker_seed(cfg.seed, w)) for w in self.owned]
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
        """The owned walkers' fields; at W = 1 the chain's (n_phonon, Ltau),
        the shape of run_updates' x_final."""
        return self.states.x[0] if self.W == 1 else self.states.x

    @property
    def mus(self) -> Optional[torch.Tensor]:
        """The owned walkers' mu as the walker functions take it: None or
        (owned walkers,) float64."""
        return None if self.mu is None else torch.as_tensor(self.mu, dtype=torch.float64).reshape(-1)

    def _params(self) -> HMCParams:
        return self.params if self.cfg.target_acceptance is None else dataclasses.replace(self.params, dt=self.dt)

    def _sweep(self, est: Optional[GreensEstimator], use_shared: bool):
        """Draw and run one sweep (theta drawn with an estimator). Returns
        (thetas, SweepStats), lists over the owned walkers."""
        params, radial = self._params(), self.cfg.use_radial_updates
        draws = [draw_walker(g, self.ctx, self.states.precond[i], params, est, radial)
                 for i, g in enumerate(self.gens)]
        v_shared = draw_shared(self.shared_gen, self.ctx, self.states.precond[0]) if use_shared else None
        self.states, st = walker_sweep(self.ctx, self.states, params, draws, shared_precond=use_shared,
                                       mus=self.mus, recenter=self.recenter, v_shared=v_shared)
        return [d.theta for d in draws], st

    def _measured(self, est: GreensEstimator, spec: MeasurementSpec, use_shared: bool) -> _Pass:
        """A sweep, each walker's estimator refresh and measurement pass."""
        thetas, stats = self._sweep(est, use_shared)
        m = walker_measure(self.ctx, spec, self.states, est, thetas, self.mus, **_solve_opts(self.cfg))
        return _Pass(stats, m.updates, m.outs, gather_walkers(_walker_rows(stats, m.updates)), m.t_refresh_s,
                     m.t_measurements_s)

    def batch(self, k: int, est: Optional[GreensEstimator] = None, spec: Optional[MeasurementSpec] = None):
        """Run a batch of k sweeps, yielding each sweep's _Sweep (theta drawn
        with an estimator), or with `spec` each measured sweep's _Pass. At
        W >= 2 the fallback controller chooses the refresh once for the batch
        and, once the batch is through, records the last sweep's walker-mean
        trajectory iteration count, as the JAX package's batched walker sweep
        feeds it: its own counters count batches, `fallback` counts sweeps.
        At W = 1 each trajectory refreshes the chain's own preconditioner."""
        use_shared = self.W > 1 and self.cfg.shared_precond and self.pc.choose()
        for _ in range(k):
            if spec is not None:
                res = self._measured(est, spec, use_shared)
            else:
                thetas, st = self._sweep(est, use_shared)
                res = _Sweep(thetas, st, gather_walkers(_walker_rows(st)))
            yield res
        if self.W > 1:
            self.pc.record(_col_mean(res.rows, _HMC_ITERS), use_shared)
            self.fallback += 0 if use_shared else k

    def refresh(self, est: GreensEstimator, thetas) -> List[EstimatorUpdate]:
        """Each owned walker's estimator refresh at its field, mu and preconditioner."""
        return walker_refresh(self.ctx, self.states, est, thetas, self.mus, **_solve_opts(self.cfg))

    def fold_kpm(self, metadata: Dict) -> None:
        fold_kpm_diagnostics(metadata, self.states.precond)

    def state_dict(self) -> Dict:
        """The chains' checkpoint: fields, preconditioner(s), generator
        state(s) and, at W >= 2, the fallback controller (the owned walkers'
        in a fleet)."""
        if self.W == 1:  # the one-chain checkpoint's keys and shapes, which older checkpoints and readers have
            return {"x": self.x, "precond": self.states.precond[0], "generator": self.gens[0].get_state()}
        return {"x": self.states.x, "precond": list(self.states.precond),
                "generator": [g.get_state() for g in self.gens], "controller": self.pc.state_dict(),
                "fallback": self.fallback, "shared_generator": self.shared_gen.get_state()}

    def load_state(self, s: Dict) -> None:
        x = torch.as_tensor(s["x"], device=self.ctx.device)
        if self.W == 1:  # state_dict's one-chain form
            self.states = WalkerStates(x=x[None], precond=[s["precond"]])
            self.gens[0].set_state(torch.as_tensor(s["generator"]))
            return
        self.states = WalkerStates(x=x, precond=list(s["precond"]))
        for g, gs in zip(self.gens, s["generator"]):
            g.set_state(torch.as_tensor(gs))
        self.pc.load_state(s["controller"])
        self.fallback = int(s["fallback"])
        self.shared_gen.set_state(torch.as_tensor(s["shared_generator"]))


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
    caller with tables of its own, such as relabelled sites). The sweeps run
    in batches of cfg.sweeps_per_dispatch on the absolute grid, each batch
    a `sweep` span (`tracing`, phase 'therm') that closes after the batch's
    device sync (a sweep and its sync at k = 1); sweep_s holds each sweep's
    seconds (a batch's span seconds over its sweeps). The timestep law of
    `target_acceptance` runs on every sweep; mu tuning needs the measured
    simulation. hmc_delta_H is a list a walker at W >= 2, with
    walker_converged and precond_fallback_sweeps; in a fleet hmc_delta_H and
    x_final cover this process's walkers, the rest every walker. force_routes
    counts the call's trajectory force evaluations by route
    (`tracing.FORCE_ROUTES`)."""
    if cfg.target_density is not None:
        raise ValueError("SimulationConfig.target_density tunes mu from measurements: use simulate / run_simulation")
    device = elph.device
    gen, ctx, state, t_init = _init_chain(tbp, elph, cfg)
    params = _hmc_params(cfg)
    chains = _Chains(ctx, state, gen, cfg, params)
    W = cfg.n_walkers
    routes0 = dict(FORCE_ROUTES)
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
    delta_H = [[] for _ in chains.owned]
    sweep_s = []
    k_disp = max(int(cfg.sweeps_per_dispatch), 1)
    done = 0
    while done < n_sweeps:
        k = _batch(done, k_disp, n_sweeps)
        with span("sweep", phase="therm", sweep=done) as batch:
            for s in chains.batch(k):
                _record_rows(meta, s.rows)
                if cfg.target_acceptance is not None:
                    chains.dt = dt_law(chains.dt, _col_mean(s.rows, _HMC_ACC), cfg.target_acceptance, dt0)
                for w in range(W):
                    converged[w] = converged[w] and bool(s.rows[w, _CONVERGED])
                for dh, h in zip(delta_H, s.stats.hmc):
                    dh.append(h.delta_H)
            sync_device(device)
        sweep_s += [batch.seconds / k] * k
        done += k
    n = max(n_sweeps, 1)
    for k in _rates():
        meta[k] /= n
    meta.update({"sweep_s": sweep_s, "x_final": chains.x, "force_routes": force_routes_since(routes0)})
    if cfg.target_acceptance is not None:
        meta["hmc_dt_final"] = chains.dt
    chains.fold_kpm(meta)
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
    float64 CPU tensors of the owned walkers at W >= 2 (the estimator's
    dtype, read as float64, as the JAX package's tuner reads its f32
    measurements)."""
    n = [float(2.0 * measure_n(u.estimator).real) for u in upds]
    N2 = [float(measure_Nsqrd(u.estimator).real) for u in upds]
    if W == 1:
        return n[0], N2[0]
    return torch.tensor(n, dtype=torch.float64), torch.tensor(N2, dtype=torch.float64)


def _hmc_last(hmc: list, W: int) -> Dict:
    """The last trajectory of each owned walker (its HMCStats' host values):
    Delta H, the accept flag and convergence, plain values at W = 1, lists
    over the owned walkers at W >= 2."""
    last = {"delta_H": [h.delta_H for h in hmc], "accepted": [h.accepted for h in hmc],
            "converged": [h.converged for h in hmc]}
    return {k: v[0] for k, v in last.items()} if W == 1 else last


def _copy_leaf(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


def _checkpoint_pID(sim_info: SimulationInfo) -> int:
    """The pID a process checkpoints under: its rank in a fleet."""
    return process_index() if process_count() > 1 else sim_info.pID


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
    `t_refresh_s` and `t_measurements_s` (the summed seconds of the
    `refresh` and `measure` spans: estimator refreshes and measurement
    passes), `hmc_last` (each owned walker's last trajectory, `_hmc_last`)
    and `force_routes` (this call's trajectory force evaluations by route,
    `tracing.FORCE_ROUTES`, its owned walkers'). A run the runtime limit
    stops returns the sums undivided, with hmc_last, force_routes and, at
    W >= 2, precond_fallback_sweeps. Each batch of
    sweeps is a `sweep` span (`tracing`: phase 'therm' or 'measure', the
    index of its first sweep in the phase; it covers the whole batch at
    sweeps_per_dispatch k > 1). With resume, a checkpoint in the data folder
    (under sim_info.pID) restores the fields, the preconditioner(s), the
    generators' states, the fallback controller, the loop counters, the
    metadata, dt, mu, the tuner(s) and the tuning history, and each walker's
    partial-bin sums, so that a resumed run yields the bins an uninterrupted
    one yields, bit for bit.

    In a fleet (`parallel.distributed.initialize_distributed`, W a multiple
    of the process count P) every process calls simulate with the same
    arguments: it runs, yields and checkpoints (under its rank) the walkers
    of its block, its tuning profiles and final_mu_per_walker ({pID: mu})
    cover them; rank 0 creates the data folder, whose sID every process then
    takes (sim_info.sID is set to it), and writes the model summary. A
    checkpoint records the walkers it holds: resuming with a block that
    differs (another process count) raises ValueError on every process."""
    device = torch.device(device)
    start_time = time.time()
    W = cfg.n_walkers
    fleet = process_count() > 1
    if process_index() == 0:
        initialize_datafolder(sim_info)
        model_summary(sim_info, cfg.beta, cfg.dtau, spec.geometry, tight_binding_model, (electron_phonon_model,))
    if fleet:
        sim_info.sID = broadcast_object(sim_info.sID)
        barrier("datafolder_init")
    geo = spec.geometry
    tbp, elph = _expand(tight_binding_model, electron_phonon_model, cfg, device)
    gen, ctx, state, _ = _init_chain(tbp, elph, cfg)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=cfg.Nrv, dtype=cfg.measurement_dtype,
                                 device=device)
    params = _hmc_params(cfg)
    chains = _Chains(ctx, state, gen, cfg, params, recenter)
    dt0 = chains.dt
    routes0 = dict(FORCE_ROUTES)
    tuner: Optional[MuTunerState] = None
    history: list = []  # one (mu, n, N^2) a tuner update
    if cfg.target_density is not None:
        tuner = init_mu_tuner(cfg.target_density, cfg.beta, tbp.n_sites, float(tbp.mu),
                              n_walkers=len(chains.owned) if W > 1 else 0)
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
    cp_pID = _checkpoint_pID(sim_info)
    bin_size = max(cfg.N_measurements // cfg.N_bins, 1)
    accs = [MeasurementAccumulator(spec) for _ in chains.owned]
    cp = read_checkpoint(sim_info.datafolder, cp_pID) if resume else None
    # every process's (walkers, therm_done, meas_done) from its checkpoint
    held = all_gather_object(None if cp is None else
                             (cp["state"]["walkers"], int(cp["state"]["therm_done"]), int(cp["state"]["meas_done"])))
    moved = {r: h[0] for r, h in enumerate(held) if h is not None and h[0] != list(local_walker_ids(W, r))}
    if moved:
        raise ValueError(f"the checkpoints hold other walkers than the processes now own (rank: walkers held) "
                         f"{moved}: resume with the number of processes that wrote them")
    if len({(0, 0) if h is None else h[1:] for h in held}) > 1:
        raise RuntimeError(f"the fleet's checkpoints are at different sweeps (walkers, therm, measured a rank): {held}")
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

    def checkpoint():
        nonlocal cp_stamp
        tree = {
            **chains.state_dict(),
            "walkers": chains.owned,
            "therm_done": therm_done,
            "meas_done": meas_done,
            "metadata": dict(metadata),
            "dt": chains.dt,
            "tuner": None if tuner is None else tuner.leaves(),
            "tuning_history": list(history),
            "acc_sums": [a.sums for a in accs],
            "acc_count": [a.count for a in accs],
        }
        cp_stamp = write_checkpoint(sim_info.datafolder, tree, pID=cp_pID)

    def decide(stop: bool):
        """After a batch: (write a checkpoint, stop the run), rank 0's in a
        fleet. A checkpoint is written when the frequency gate is open and
        the run checkpoints on a clock or stops (the gate first, so that a
        closed gate costs nothing)."""
        due = (cfg.checkpoint_freq_hours < np.inf or stop) and checkpoint_due(cp_stamp, cfg.checkpoint_freq_hours)
        return broadcast_object((due, stop)) if fleet else (due, stop)

    def out_of_time() -> bool:
        return runtime_exceeded(start_time, cfg.runtime_limit_hours)

    def close() -> None:
        """The keys of every return: KPM diagnostics, the trajectory force
        evaluations by route and the fallback count."""
        chains.fold_kpm(metadata)
        metadata["force_routes"] = force_routes_since(routes0)
        if W > 1:
            metadata["precond_fallback_sweeps"] = chains.fallback

    def tune(upds):
        nonlocal tuner
        n, N2 = _tuner_inputs(upds, W)
        tuner = mu_tuner_update(tuner, n, N2)
        chains.mu = tuner.mu
        history.append((_copy_leaf(tuner.mu), n, N2))

    k_disp = 1 if tuner is not None else max(int(cfg.sweeps_per_dispatch), 1)

    # ------------------------------------------------------------------
    # thermalize (the first batch of a phase carries its warm-up); dt
    # follows the acceptance law, mu the tuner
    # ------------------------------------------------------------------
    t_phase = time.time()
    n_timed = 0
    while therm_done < cfg.N_therm:
        k = _batch(therm_done, k_disp, cfg.N_therm)
        with span("sweep", phase="therm", sweep=therm_done):
            for s in chains.batch(k, est if tuner is not None else None):
                _record_rows(metadata, s.rows)
                if cfg.target_acceptance is not None:
                    chains.dt = dt_law(chains.dt, _col_mean(s.rows, _HMC_ACC), cfg.target_acceptance, dt0)
                if tuner is not None:
                    tune(chains.refresh(est, s.thetas))
            metadata["hmc_last"] = _hmc_last(s.stats.hmc, W)
        therm_done += k
        n_timed += k
        if n_timed == k:
            metadata["t_first_therm_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_therm_batch"] = k
        save, stop = decide(out_of_time())
        if save:
            checkpoint()
        if stop:
            close()
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
        k = _batch(meas_done, k_disp, cfg.N_measurements, meas_done + bin_size - meas_done % bin_size)
        with span("sweep", phase="measure", sweep=meas_done):
            for m in chains.batch(k, est, spec):
                _record_rows(metadata, m.rows)
                metadata["measurement_iters"] += _col_mean(m.rows, _MEAS_ITERS)
                metadata["all_converged"] = metadata["all_converged"] and bool(m.rows[:, _MEAS_CONVERGED].all())
                metadata["t_refresh_s"] += m.t_refresh_s
                metadata["t_measurements_s"] += m.t_measurements_s
                for a, out in zip(accs, m.outs):
                    a.accumulate(out)
                if tuner is not None:
                    tune(m.updates)
            metadata["hmc_last"] = _hmc_last(m.stats.hmc, W)
        meas_done += k
        n_timed += k
        if n_timed == k:
            sync_device(device)
            metadata["t_first_measured_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_measured_batch"] = k
        if meas_done % bin_size == 0:
            b = meas_done // bin_size - 1
            if W == 1:
                yield b, accs[0].finalize_bin()
            else:
                for w, a in zip(chains.owned, accs):
                    yield w, b, a.finalize_bin()
        save, stop = decide(out_of_time() and meas_done < cfg.N_measurements)
        if save:
            checkpoint()
        if stop:
            close()
            return metadata, False
    if n_timed:
        sync_device(device)
        metadata["t_measure_s"] = round(time.time() - t_phase, 3)
        metadata["n_measure_timed"] = n_timed

    n_updates = cfg.N_therm + cfg.N_measurements
    for k in _rates():
        metadata[k] /= max(n_updates, 1)
    metadata["measurement_iters"] /= max(cfg.N_measurements, 1)
    close()
    if cfg.target_acceptance is not None:
        metadata["hmc_dt_final"] = chains.dt
    if tuner is not None:
        if W == 1:
            metadata["final_mu"] = float(tuner.mu)
            save_density_tuning_profile(sim_info, history)
        else:
            mus = [float(v) for v in tuner.mu]
            metadata["final_mu_per_walker"] = dict(zip(chains.owned, mus)) if fleet else mus
            for i, w in enumerate(chains.owned):
                save_density_tuning_profile(sim_info.with_pID(w), [tuple(float(v[i]) for v in row) for row in history])
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
    checkpoints. Returns the metadata dict. In a fleet each process writes
    its walkers' bins and deletes its checkpoint; rank 0 merges and writes
    the statistics once every process has written its bins."""
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
        barrier("bins_complete")
        if process_index() == 0:
            merge_bins(sim_info)
            save_simulation_info(sim_info, metadata)
            process_measurements(sim_info.datafolder, n_bins=cfg.N_bins, spec=spec)
        delete_checkpoints(sim_info.datafolder, _checkpoint_pID(sim_info))
        barrier("finalize_done")
    return metadata
