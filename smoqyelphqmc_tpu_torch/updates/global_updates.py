"""Global phonon-field moves: reflection and swap (port of
smoqyelphqmc_tpu/updates/global_updates.py; the radial update waits, ROADMAP
Queue 1, item 17).

Both sample fresh pseudofermions (initial action exactly |R|^2), propose a
global change of x, evaluate the new action with one f64 solve and
Metropolis-accept. Frozen modes are never selected. Draws come in as
`ReflectionDraws` / `SwapDraws`; `draw_reflection` / `draw_swap` make them."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bosonic import bosonic_action
from ..ops.pff import fermionic_action, sample_pseudofermion_fields
from .context import QMCContext, QMCState, make_fdm
from .hmc import metropolis_probability


class GlobalUpdateStats(NamedTuple):
    accepted: bool
    delta_S: float
    iters: int
    converged: bool


@dataclasses.dataclass
class ReflectionDraws:
    """mode: index into the candidate modes; R: (2, Ltau, N) ~ N(0, 1/2); u_acc ~ U(0,1)."""

    mode: int
    R: torch.Tensor
    u_acc: float


@dataclasses.dataclass
class SwapDraws:
    """pair: index into the type pairs; c1: first cell; shift in [1, n_cells)
    picks the second cell when both types coincide, c2_other in [0, n_cells)
    when they differ."""

    pair: int
    c1: int
    shift: int
    c2_other: int
    R: torch.Tensor
    u_acc: float


def _candidate_modes(ctx: QMCContext, phonon_types: Optional[Sequence[int]]) -> np.ndarray:
    elph = ctx.elph
    types = range(elph.nphonon) if phonon_types is None else phonon_types
    cands = []
    for t in types:
        if not 0 <= t < elph.nphonon:
            raise ValueError(f"phonon type {t} out of range: model has {elph.nphonon} phonon mode type(s)")
        modes = t * elph.n_cells + np.arange(elph.n_cells)
        cands.append(modes[~elph.frozen_mask[modes]])
    return np.concatenate(cands).astype(np.int64) if cands else np.zeros(0, np.int64)


def _type_pairs(ctx: QMCContext, phonon_type_pairs) -> np.ndarray:
    elph = ctx.elph
    if phonon_type_pairs is None:
        types = [t for t in range(elph.nphonon)
                 if not np.all(elph.frozen_mask[t * elph.n_cells:(t + 1) * elph.n_cells])]
        return np.asarray([(t, t) for t in types], dtype=np.int64).reshape(-1, 2)
    return np.asarray(list(phonon_type_pairs), dtype=np.int64).reshape(-1, 2)


def _noise(gen: torch.Generator, ctx: QMCContext) -> Tuple[torch.Tensor, float]:
    R = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=torch.float64) / math.sqrt(2.0)
    return R.to(ctx.device), float(torch.rand((), generator=gen, dtype=torch.float64))


def _randint(gen: torch.Generator, lo: int, hi: int) -> int:
    return int(torch.randint(lo, hi, (), generator=gen))


def draw_reflection(gen: torch.Generator, ctx: QMCContext, phonon_types=None) -> ReflectionDraws:
    mode = _randint(gen, 0, len(_candidate_modes(ctx, phonon_types)))
    R, u_acc = _noise(gen, ctx)
    return ReflectionDraws(mode=mode, R=R, u_acc=u_acc)


def draw_swap(gen: torch.Generator, ctx: QMCContext, phonon_type_pairs=None) -> SwapDraws:
    n_cells = ctx.elph.n_cells
    pair = _randint(gen, 0, len(_type_pairs(ctx, phonon_type_pairs)))
    c1 = _randint(gen, 0, n_cells)
    shift = _randint(gen, 1, max(n_cells, 2))
    c2_other = _randint(gen, 0, n_cells)
    R, u_acc = _noise(gen, ctx)
    return SwapDraws(pair=pair, c1=c1, shift=shift, c2_other=c2_other, R=R, u_acc=u_acc)


def _metropolis_core(ctx: QMCContext, state: QMCState, x_new: torch.Tensor, extra_log_weight: float,
                     R: torch.Tensor, u_acc: float) -> tuple[QMCState, GlobalUpdateStats]:
    """Fresh Phi at x_old gives S_f = |R|^2 exactly; the proposal costs one solve."""
    elph = ctx.elph
    x_old = state.x
    Phi, Sf_old = sample_pseudofermion_fields(R, elph, make_fdm(ctx, x_old), x_old)
    S_old = Sf_old + bosonic_action(elph, x_old)
    # the carried preconditioner is not refreshed for a global move: one mode
    # out of n_phonon barely moves the tau- and site-averaged Bbar
    res = fermionic_action(Phi, elph, make_fdm(ctx, x_new), x_new, precond=state.precond, tol=ctx.tol,
                           maxiter=ctx.maxiter, mixed=ctx.mixed_precision)
    dS = float(res.Sf + bosonic_action(elph, x_new) - S_old)
    ok = bool(res.stats.converged) and math.isfinite(dS)
    accepted = u_acc < metropolis_probability(dS, ok, extra_log_weight)
    stats = GlobalUpdateStats(accepted=accepted, delta_S=dS, iters=int(res.stats.iters), converged=ok)
    return QMCState(x=x_new if accepted else x_old, precond=state.precond), stats


def reflection_update(ctx: QMCContext, state: QMCState, draws: ReflectionDraws,
                      phonon_types: Optional[Sequence[int]] = None) -> tuple[QMCState, GlobalUpdateStats]:
    """Flip x -> -x on all time slices of one phonon mode."""
    cands = _candidate_modes(ctx, phonon_types)
    if len(cands) == 0:
        raise ValueError(f"reflection_update: no unfrozen phonon modes match phonon_types={phonon_types}")
    x_new = state.x.clone()
    x_new[int(cands[draws.mode])] *= -1.0
    return _metropolis_core(ctx, state, x_new, 0.0, draws.R, draws.u_acc)


def swap_update(ctx: QMCContext, state: QMCState, draws: SwapDraws,
                phonon_type_pairs: Optional[Sequence[Tuple[int, int]]] = None) -> tuple[QMCState, GlobalUpdateStats]:
    """Exchange the tau-trajectories of two phonon modes (two distinct cells of
    one type by default)."""
    n_cells = ctx.elph.n_cells
    pairs = _type_pairs(ctx, phonon_type_pairs)
    if len(pairs) == 0:
        raise ValueError(f"swap_update: no unfrozen phonon-type pairs match {phonon_type_pairs}")
    t1, t2 = (int(v) for v in pairs[draws.pair])
    c2 = (draws.c1 + draws.shift) % n_cells if t1 == t2 else draws.c2_other
    p1, p2 = t1 * n_cells + draws.c1, t2 * n_cells + c2
    x_new = state.x.clone()
    x_new[p1], x_new[p2] = state.x[p2], state.x[p1]
    return _metropolis_core(ctx, state, x_new, 0.0, draws.R, draws.u_acc)
