"""Walker batching: W independent Markov chains on one device (port of
the JAX package's parallel/walkers.py without the device mesh). Every run of
the driver sweeps through here, its one-chain run (W = 1) as a batch of one.

The JAX package vmaps one traced sweep over a leading walker axis. Here the
axis is written out: the field is (W, n_phonon, Ltau); reflection, swap and
radial moves, each a Metropolis decision on f64 solves (K1 / K2), run walker
by walker; with one shared preconditioner the HMC trajectories of all
walkers run together in one `updates.hmc.hmc_update`, every kick's W force
solves in one launch of kernel K3 where it applies (spectral, real,
symmetric, no SSH couplings), else walker by walker: K1 + K6 / K7 with a
real KPM preconditioner, the complex M^dag M + K8 with a complex one. The
shared refresh of a KPM preconditioner starts its Lanczos iteration from a
vector of its own stream (`draw_shared`). Each walker may carry its own chemical
potential (`mus`): its moves, its trajectory's fermion matrix (K3 reads the
walkers' exp_nV planes with a walker stride) and its measurements use it,
and the shared refresh uses the walker-mean mu. Draws are per walker
(`WalkerDraws`), so a walker's chain does not depend on W.

Without the shared preconditioner (and always at W = 1) each walker
refreshes its own preconditioner at trajectory start and runs its own
trajectory: the JAX package's one-chain sweep, walker by walker.

`walker_measure` refreshes each walker's Green's estimator (one K2 launch of
2 Nrv systems at that walker's fermion matrix: K2 takes one fermion matrix a
launch; with a KPM preconditioner or complex hoppings the CG path with the
walker's preconditioner) and takes its measurement pass. The `update`,
`refresh` and `measure` spans (`tracing`) each end with a device sync, so
each times its work until the device has finished it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..measure.container import make_measurements
from ..measure.greens_estimator import EstimatorUpdate, GreensEstimator, draw_theta, update_greens_estimator
from ..ops.checkerboard import build_checkerboard_op
from ..ops.kpm import KPMPreconditioner
from ..ops.preconditioner import refresh_preconditioner
from ..tracing import span
from ..updates.context import QMCContext, QMCState, make_fdm, with_mu
from ..updates.global_updates import (
    RadialDraws,
    ReflectionDraws,
    SwapDraws,
    draw_radial,
    draw_reflection,
    draw_swap,
    radial_update,
    reflection_update,
    swap_update,
)
from ..updates.hmc import HMCDraws, HMCParams, draw_hmc, hmc_update
from .distributed import gather_walkers, process_count


@dataclasses.dataclass
class WalkerStates:
    x: torch.Tensor  # (W, n_phonon, Ltau)
    precond: List[Optional[object]]  # per walker; one shared object after a shared refresh

    @property
    def n_walkers(self) -> int:
        return self.x.shape[0]

    def walker(self, w: int) -> QMCState:
        return QMCState(x=self.x[w], precond=self.precond[w])


@dataclasses.dataclass
class WalkerDraws:
    """One walker's draws for one sweep (at W = 1, the chain's): theta
    (Nrv, Ltau, N) for the estimator refresh of a measured or tuning sweep,
    radial for a sweep with radial updates."""

    reflection: ReflectionDraws
    swap: SwapDraws
    hmc: HMCDraws
    theta: Optional[torch.Tensor] = None
    radial: Optional[RadialDraws] = None


def draw_walker(gen: torch.Generator, ctx: QMCContext, precond=None, params: Optional[HMCParams] = None,
                est: Optional[GreensEstimator] = None, radial: bool = False) -> WalkerDraws:
    """A sweep's draws from one generator, in the order the sweep runs:
    reflection, swap, radial (only when on), HMC, then, with an estimator,
    the phases of its refresh. With every option off these are the draws of
    a reflection + swap + HMC sweep alone."""
    r = draw_reflection(gen, ctx, precond=precond)
    s = draw_swap(gen, ctx, precond=precond)
    rad = draw_radial(gen, ctx, precond) if radial else None
    h = draw_hmc(gen, ctx, precond, params)
    theta = draw_theta(gen, est, ctx.device) if est is not None else None
    return WalkerDraws(r, s, h, theta=theta, radial=rad)


class SweepStats(tuple):
    """A sweep's update stats in the order the updates ran: (reflection,
    swap, hmc), with radial after swap when the sweep ran one; each entry a
    list over walkers."""

    def __new__(cls, reflection, swap, hmc, radial=None):
        self = super().__new__(cls, (reflection, swap) + (() if radial is None else (radial,)) + (hmc,))
        self.reflection, self.swap, self.hmc, self.radial = reflection, swap, hmc, radial
        return self


def init_walker_states(ctx: QMCContext, base_state: QMCState, noise: torch.Tensor) -> WalkerStates:
    """Replicate the chain state over W walkers with jittered fields
    x = base x + noise, noise (W, n_phonon, Ltau) (the JAX package draws
    0.1 N(0, 1)); every walker starts from the base preconditioner."""
    x = base_state.x[None] + noise.to(base_state.x)
    return WalkerStates(x=x, precond=[base_state.precond] * x.shape[0])


def walker_mean_fdm(fdm):
    """The walker mean of a walker batch's fermion matrix (make_fdm of a
    (W, n_phonon, Ltau) field): every factor averaged over the walkers,
    exp_nV, and with SSH couplings cosh_hop, sinh_hop and sinh_hop_im (the
    checkerboard planes rebuilt from the means), as the JAX package averages
    every leaf (parallel/walkers.py:79)."""
    mean = dataclasses.replace(fdm, exp_nV=fdm.exp_nV.mean(dim=0)[0])
    if not fdm.static_hops:
        cosh, sinh = fdm.cosh_hop.mean(dim=0), fdm.sinh_hop.mean(dim=0)
        sinh_im = None if fdm.sinh_hop_im is None else fdm.sinh_hop_im.mean(dim=0)
        mean = dataclasses.replace(mean, cosh_hop=cosh, sinh_hop=sinh, sinh_hop_im=sinh_im,
                                   cb=build_checkerboard_op(fdm.structure, cosh, sinh, sinh_im))
    return mean


def shared_precond_refresh(ctx: QMCContext, states: WalkerStates, v0: Optional[torch.Tensor] = None) -> WalkerStates:
    """Refresh the preconditioner once from the walker-mean fermion matrix
    (`walker_mean_fdm`, at the context's mu: the walker sweep passes the
    walker-mean mu) and give it to every walker. In a fleet the mean runs
    over every process's walkers (`distributed.gather_walkers`). A KPM
    preconditioner's Lanczos iteration starts from v0 (ctx.lanczos_dim,)
    (`draw_shared`; the JAX package draws it from walker 0's key).
    Preconditioner quality moves only iteration counts, never the sampled
    distribution."""
    if states.precond[0] is None:
        return states
    pre = refresh_preconditioner(states.precond[0], walker_mean_fdm(make_fdm(ctx, gather_walkers(states.x))), v0)
    return WalkerStates(x=states.x, precond=[pre] * states.n_walkers)


def draw_shared(gen: torch.Generator, ctx: QMCContext, precond) -> Optional[torch.Tensor]:
    """The shared refresh's Lanczos start vector (ctx.lanczos_dim,) ~ N(0, 1)
    from a generator of its own, which no walker's chain draws from; None
    (and no draw) unless the walkers carry a KPM preconditioner."""
    if not isinstance(precond, KPMPreconditioner):
        return None
    return torch.randn((ctx.lanczos_dim,), generator=gen, dtype=torch.float64).to(ctx.device)


class PrecondFallbackController:
    """Host-side guard for the shared walker-mean preconditioner refresh.

    Tracks the running minimum of per-sweep mean trajectory iteration counts; a
    shared-mode sweep above `ratio` x that floor demotes to per-walker refresh,
    and a probe sweep every `retry_every` sweeps promotes back once shared mode
    is healthy again. A sweep's count is resolved at the next `choose()` (one
    sweep late), so a device scalar may be recorded without a host sync."""

    def __init__(self, ratio: float = 1.5, retry_every: int = 32, enabled: bool = True):
        self.ratio = float(ratio)
        self.retry_every = max(int(retry_every), 1)
        self.enabled = bool(enabled) and np.isfinite(ratio)
        self.mode = "shared"
        self.floor = np.inf
        self.pw_count = 0  # sweeps since entering per-walker mode
        self.fallback_sweeps = 0  # total sweeps run with per-walker refresh
        self._pending = None  # (iters: tensor or float, was_shared)

    def _resolve(self) -> None:
        if self._pending is None:
            return
        it_dev, was_shared = self._pending
        self._pending = None
        it = float(it_dev)
        if not np.isfinite(it) or it <= 0.0:
            return
        self.floor = min(self.floor, it)
        healthy = it <= self.ratio * self.floor
        if was_shared:
            self.mode = "shared" if healthy else "perwalker"

    def choose(self) -> bool:
        """True = refresh shared this sweep (includes periodic probe sweeps)."""
        if not self.enabled:
            return True
        self._resolve()
        probing = self.mode == "perwalker" and self.pw_count % self.retry_every == self.retry_every - 1
        return self.mode == "shared" or probing

    def record(self, iters, used_shared: bool) -> None:
        """Feed back this sweep's mean trajectory iteration count."""
        if not self.enabled:
            return
        self._pending = (iters, used_shared)
        if not used_shared:
            self.fallback_sweeps += 1
        if self.mode == "perwalker":
            self.pw_count += 1
        else:
            self.pw_count = 0

    def state_dict(self) -> dict:
        """Checkpointable state (resolves a pending count first)."""
        self._resolve()
        return {
            "mode": self.mode,
            "floor": float(self.floor),
            "pw_count": int(self.pw_count),
            "fallback_sweeps": int(self.fallback_sweeps),
        }

    def load_state(self, d: dict) -> None:
        self.mode = str(d["mode"])
        self.floor = float(d["floor"])
        self.pw_count = int(d["pw_count"])
        self.fallback_sweeps = int(d["fallback_sweeps"])
        self._pending = None


def walker_sweep(ctx: QMCContext, states: WalkerStates, params: HMCParams, draws: Sequence[WalkerDraws],
                 shared_precond: bool = True, mus: Optional[torch.Tensor] = None, recenter=None,
                 v_shared: Optional[torch.Tensor] = None):
    """One (reflection + swap [+ radial] + HMC) sweep of every walker, walker
    w with draws[w] (radial where draws[w].radial is set) and, with mus (W,)
    float64, at chemical potential mus[w]. With shared_precond the
    preconditioner is refreshed once per sweep from the walker-mean fermion
    matrix at the walker-mean mu (a KPM preconditioner's Lanczos iteration
    from v_shared, `draw_shared`) and the W trajectories run as one batch, at
    W >= 2 with fused_step_force (every force solve through K3, as the JAX
    package's walker_sweep sets it); otherwise each walker refreshes its own
    preconditioner at trajectory start and runs its own trajectory (the JAX
    package drops K3 in that mode), its forces through the K2 solve and
    kernel K4 where `updates.hmc.force_route` takes them (the card, the
    Holstein planes). `recenter` acts on each walker's field
    after every drift. In a fleet the states and mus are this process's
    block, and the shared refresh and the W >= 2 test take every process's
    walkers (`distributed.gather_walkers`). Returns (states, SweepStats of
    lists over this block's walkers). The sweep is the `update` span
    (`tracing`), closed once the device has finished the sweep."""
    with span("update"):
        W = states.n_walkers
        shared = shared_precond and states.precond[0] is not None
        ctxs = [ctx if mus is None else with_mu(ctx, mus[w]) for w in range(W)]
        if shared:
            if ctx.refresh_precond_global or params.refresh_precond_every_step:
                raise ValueError("a walker batch shares one preconditioner, refreshed once a sweep: "
                                 "refresh_precond_global and refresh_precond_every_step need shared_precond=False")
            ctx_mean = ctx if mus is None else with_mu(ctx, gather_walkers(mus).mean())
            states = shared_precond_refresh(ctx_mean, states, v_shared)
            params = dataclasses.replace(params, refresh_precond_at_start=False)
            if W * process_count() >= 2:
                params = dataclasses.replace(params, fused_step_force=True)
        xs, pres, rs, ss, rads = [], [], [], [], []
        for w in range(W):
            st, r = reflection_update(ctxs[w], states.walker(w), draws[w].reflection)
            st, s = swap_update(ctxs[w], st, draws[w].swap)
            if draws[w].radial is not None:
                with span("radial", walker=w):
                    st, rad = radial_update(ctxs[w], st, draws[w].radial)
                rads.append(rad)
            xs.append(st.x)
            pres.append(st.precond)
            rs.append(r)
            ss.append(s)
        rads = rads or None
        if shared:
            batch_ctx = ctx if mus is None else with_mu(ctx, mus)
            st, hs = hmc_update(batch_ctx, QMCState(x=torch.stack(xs), precond=pres[0]), params,
                                [d.hmc for d in draws], recenter=recenter)
            states = WalkerStates(x=st.x, precond=[st.precond] * W)
        else:
            hs = []
            for w in range(W):
                st, h = hmc_update(ctxs[w], QMCState(x=xs[w], precond=pres[w]), params, draws[w].hmc,
                                   recenter=recenter)
                xs[w], pres[w] = st.x, st.precond
                hs.append(h)
            # a one-chain run (one walker over every process) keeps its field's layout: a stacked
            # copy would send its elementwise CPU ops down other (vectorized) paths and move its last bits
            states = WalkerStates(x=torch.stack(xs) if W * process_count() > 1 else xs[0][None], precond=pres)
        sync_device(ctx.device)
    return states, SweepStats(rs, ss, hs, rads)


def walker_refresh(ctx: QMCContext, states: WalkerStates, est: GreensEstimator, thetas: Sequence[torch.Tensor],
                   mus: Optional[torch.Tensor] = None, **solve) -> List[EstimatorUpdate]:
    """Each walker's estimator refresh from the one template `est` with its
    own phases thetas[w], at its own field, mu and preconditioner: one K2
    launch of 2 Nrv systems a walker with f32 solves. `solve` goes to
    update_greens_estimator (tol, maxiter, mixed, solve_dtype)."""
    out = []
    for w in range(states.n_walkers):
        c = ctx if mus is None else with_mu(ctx, mus[w])
        out.append(update_greens_estimator(est, make_fdm(c, states.x[w]), thetas[w], precond=states.precond[w],
                                           **solve))
    return out


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WalkerMeasurement(NamedTuple):
    outs: List[Dict]  # the measurement trees, one a walker
    updates: List[EstimatorUpdate]  # the refreshed estimators, their iterations and convergence
    t_refresh_s: float  # the `refresh` span's seconds: the W refreshes, synchronised
    t_measurements_s: float  # the `measure` span's seconds: the W measurement passes, synchronised


def walker_measure(ctx: QMCContext, spec, states: WalkerStates, est: GreensEstimator, thetas: Sequence[torch.Tensor],
                   mus: Optional[torch.Tensor] = None, **solve) -> WalkerMeasurement:
    """Refresh each walker's estimator (walker_refresh) and take its
    measurement pass with its own context: the measured half of the driver's
    measured sweep, timed by the `refresh` and `measure` spans (`tracing`)."""
    with span("refresh") as refresh:
        upds = walker_refresh(ctx, states, est, thetas, mus, **solve)
        sync_device(ctx.device)
    with span("measure") as measure:
        outs = [make_measurements(ctx if mus is None else with_mu(ctx, mus[w]), spec, u.estimator, states.x[w])
                for w, u in enumerate(upds)]
        sync_device(ctx.device)
    return WalkerMeasurement(outs, upds, refresh.seconds, measure.seconds)
