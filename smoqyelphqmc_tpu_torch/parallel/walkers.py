"""Walker batching: W independent Markov chains on one device (port of
the JAX package's parallel/walkers.py without the device mesh).

The JAX package vmaps one traced sweep over a leading walker axis. Here the
axis is written out: the field is (W, n_phonon, Ltau); reflection and swap,
each a Metropolis decision on f64 solves (K1 / K2), run walker by walker; with
one shared preconditioner the HMC trajectories of all walkers run together
in one `updates.hmc.hmc_update`, every leapfrog step's W force solves in one
launch of kernel K3. Draws are per walker (`WalkerDraws`), so a
walker's chain does not depend on W.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.preconditioner import refresh_preconditioner
from ..updates.context import QMCContext, QMCState, make_fdm
from ..updates.global_updates import (
    ReflectionDraws,
    SwapDraws,
    draw_reflection,
    draw_swap,
    reflection_update,
    swap_update,
)
from ..updates.hmc import HMCDraws, HMCParams, draw_hmc, hmc_update


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
    """One walker's draws for one sweep."""

    reflection: ReflectionDraws
    swap: SwapDraws
    hmc: HMCDraws


def draw_walker(gen: torch.Generator, ctx: QMCContext) -> WalkerDraws:
    """A sweep's draws from one walker's generator, in the W = 1 sweep's order."""
    return WalkerDraws(draw_reflection(gen, ctx), draw_swap(gen, ctx), draw_hmc(gen, ctx))


def init_walker_states(ctx: QMCContext, base_state: QMCState, noise: torch.Tensor) -> WalkerStates:
    """Replicate the chain state over W walkers with jittered fields
    x = base x + noise, noise (W, n_phonon, Ltau) (the JAX package draws
    0.1 N(0, 1)); every walker starts from the base preconditioner."""
    x = base_state.x[None] + noise.to(base_state.x)
    return WalkerStates(x=x, precond=[base_state.precond] * x.shape[0])


def shared_precond_refresh(ctx: QMCContext, states: WalkerStates) -> WalkerStates:
    """Refresh the preconditioner once from the walker-mean fermion matrix
    (the mean of the walkers' exp(-dtau V) planes) and give it to every
    walker. Preconditioner quality moves only iteration counts, never the
    sampled distribution."""
    if states.precond[0] is None:
        return states
    fdm = make_fdm(ctx, states.x)
    fdm_mean = dataclasses.replace(fdm, exp_nV=fdm.exp_nV.mean(dim=0)[0])
    pre = refresh_preconditioner(states.precond[0], fdm_mean)
    return WalkerStates(x=states.x, precond=[pre] * states.n_walkers)


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
                 shared_precond: bool = True):
    """One (reflection + swap + HMC) sweep of every walker, walker w with
    draws[w]. With shared_precond the preconditioner is refreshed once per
    sweep from the walker-mean fermion matrix and the W trajectories run as
    one batch, at W >= 2 with fused_step_force (every force solve through K3,
    as the JAX package's walker_sweep sets it); otherwise each walker
    refreshes its own preconditioner at trajectory start and runs its own
    trajectory (the JAX package drops K3 in that mode). Returns
    (states, (reflection stats, swap stats, HMC stats)), each a list over
    walkers."""
    W = states.n_walkers
    shared = shared_precond and states.precond[0] is not None
    if shared:
        states = shared_precond_refresh(ctx, states)
        params = dataclasses.replace(params, refresh_precond_at_start=False)
        if W >= 2:
            params = dataclasses.replace(params, fused_step_force=True)
    xs, pres, rs, ss = [], [], [], []
    for w in range(W):
        st, r = reflection_update(ctx, states.walker(w), draws[w].reflection)
        st, s = swap_update(ctx, st, draws[w].swap)
        xs.append(st.x)
        pres.append(st.precond)
        rs.append(r)
        ss.append(s)
    if shared:
        st, hs = hmc_update(ctx, QMCState(x=torch.stack(xs), precond=pres[0]), params, [d.hmc for d in draws])
        return WalkerStates(x=st.x, precond=[st.precond] * W), (rs, ss, hs)
    hs = []
    for w in range(W):
        st, h = hmc_update(ctx, QMCState(x=xs[w], precond=pres[w]), params, draws[w].hmc)
        xs[w], pres[w] = st.x, st.precond
        hs.append(h)
    return WalkerStates(x=torch.stack(xs), precond=pres), (rs, ss, hs)
