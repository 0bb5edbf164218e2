"""Global phonon-field moves: reflection, swap and radial updates (port of
the JAX package's updates/global_updates.py).

Each samples fresh pseudofermions (initial action exactly |R|^2), proposes
a global change of x, evaluates the new action with one f64 solve and
Metropolis-accepts. Frozen modes are never selected and never scaled. Draws
come in as `ReflectionDraws` / `SwapDraws` / `RadialDraws`; `draw_reflection`
/ `draw_swap` / `draw_radial` make them. With `ctx.refresh_precond_global`
each proposal refreshes the carried preconditioner at x_new; a KPM
preconditioner's Lanczos start vector `v_pre` is then the move's last draw
(drawn only then, so other chains keep their random streams)."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bosonic import bosonic_action
from ..ops.kpm import KPMPreconditioner
from ..ops.preconditioner import refresh_preconditioner
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
    v_pre: Optional[torch.Tensor] = None


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
    v_pre: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RadialDraws:
    """z ~ N(0, 1) (gamma = z sigma / sqrt(d)); R and u_acc as for the others."""

    z: float
    R: torch.Tensor
    u_acc: float
    v_pre: Optional[torch.Tensor] = None


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


def _pre_draw(gen: torch.Generator, ctx: QMCContext, precond) -> Optional[torch.Tensor]:
    """The Lanczos start vector of a proposal's refresh: drawn only with
    ctx.refresh_precond_global and a KPM preconditioner."""
    if not (ctx.refresh_precond_global and isinstance(precond, KPMPreconditioner)):
        return None
    return torch.randn((ctx.lanczos_dim,), generator=gen, dtype=torch.float64).to(ctx.device)


def draw_reflection(gen: torch.Generator, ctx: QMCContext, phonon_types=None, precond=None) -> ReflectionDraws:
    mode = _randint(gen, 0, len(_candidate_modes(ctx, phonon_types)))
    R, u_acc = _noise(gen, ctx)
    return ReflectionDraws(mode=mode, R=R, u_acc=u_acc, v_pre=_pre_draw(gen, ctx, precond))


def draw_swap(gen: torch.Generator, ctx: QMCContext, phonon_type_pairs=None, precond=None) -> SwapDraws:
    n_cells = ctx.elph.n_cells
    pair = _randint(gen, 0, len(_type_pairs(ctx, phonon_type_pairs)))
    c1 = _randint(gen, 0, n_cells)
    shift = _randint(gen, 1, max(n_cells, 2))
    c2_other = _randint(gen, 0, n_cells)
    R, u_acc = _noise(gen, ctx)
    return SwapDraws(pair=pair, c1=c1, shift=shift, c2_other=c2_other, R=R, u_acc=u_acc,
                     v_pre=_pre_draw(gen, ctx, precond))


def draw_radial(gen: torch.Generator, ctx: QMCContext, precond=None) -> RadialDraws:
    z = float(torch.randn((), generator=gen, dtype=torch.float64))
    R, u_acc = _noise(gen, ctx)
    return RadialDraws(z=z, R=R, u_acc=u_acc, v_pre=_pre_draw(gen, ctx, precond))


def _metropolis_core(ctx: QMCContext, state: QMCState, x_new: torch.Tensor, extra_log_weight: float,
                     R: torch.Tensor, u_acc: float, v_pre: Optional[torch.Tensor] = None
                     ) -> tuple[QMCState, GlobalUpdateStats]:
    """Fresh Phi at x_old gives S_f = |R|^2 exactly; the proposal costs one
    solve. The preconditioner is refreshed at x_new only with
    ctx.refresh_precond_global (by default one mode out of n_phonon barely
    moves the tau- and site-averaged Bbar); the state keeps the refreshed one
    either way, as the JAX package's does."""
    elph = ctx.elph
    x_old = state.x
    Phi, Sf_old = sample_pseudofermion_fields(R, elph, make_fdm(ctx, x_old), x_old)
    S_old = Sf_old + bosonic_action(elph, x_old)
    fdm_new = make_fdm(ctx, x_new)
    precond = state.precond
    if precond is not None and ctx.refresh_precond_global:
        precond = refresh_preconditioner(precond, fdm_new, v_pre)
    res = fermionic_action(Phi, elph, fdm_new, x_new, precond=precond, tol=ctx.tol, maxiter=ctx.maxiter,
                           mixed=ctx.mixed_precision)
    dS = float(res.Sf + bosonic_action(elph, x_new) - S_old)
    ok = bool(res.stats.converged) and math.isfinite(dS)
    accepted = u_acc < metropolis_probability(dS, ok, extra_log_weight)
    stats = GlobalUpdateStats(accepted=accepted, delta_S=dS, iters=int(res.stats.iters), converged=ok)
    return QMCState(x=x_new if accepted else x_old, precond=precond), stats


def reflection_update(ctx: QMCContext, state: QMCState, draws: ReflectionDraws,
                      phonon_types: Optional[Sequence[int]] = None) -> tuple[QMCState, GlobalUpdateStats]:
    """Flip x -> -x on all time slices of one phonon mode."""
    cands = _candidate_modes(ctx, phonon_types)
    if len(cands) == 0:
        raise ValueError(f"reflection_update: no unfrozen phonon modes match phonon_types={phonon_types}")
    x_new = state.x.clone()
    x_new[int(cands[draws.mode])] *= -1.0
    return _metropolis_core(ctx, state, x_new, 0.0, draws.R, draws.u_acc, draws.v_pre)


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
    return _metropolis_core(ctx, state, x_new, 0.0, draws.R, draws.u_acc, draws.v_pre)


def _radial_selection(ctx: QMCContext, phonon_id: Optional[int] = None) -> np.ndarray:
    """The modes a radial move scales: every unfrozen mode, or those of one
    phonon type."""
    elph = ctx.elph
    n_cells = elph.n_cells
    if phonon_id is None:
        return ~elph.frozen_mask
    sel = np.zeros(elph.n_phonon, dtype=bool)
    block = slice(phonon_id * n_cells, (phonon_id + 1) * n_cells)
    sel[block] = ~elph.frozen_mask[block]
    return sel


def radial_update(ctx: QMCContext, state: QMCState, draws: RadialDraws, phonon_id: Optional[int] = None,
                  sigma: float = 1.0) -> tuple[QMCState, GlobalUpdateStats]:
    """Rescale x -> e^gamma x on the selected modes with gamma ~ N(0,
    sigma / sqrt(d)), d = selected modes x Ltau; the acceptance carries the
    Jacobian term d gamma (radial_update!, arXiv:2411.18218 Algorithm 1)."""
    sel = _radial_selection(ctx, phonon_id)
    d = int(sel.sum()) * ctx.Ltau
    if d == 0:
        raise ValueError(f"radial_update: no unfrozen phonon fields selected (phonon_id={phonon_id})")
    gamma = draws.z * (sigma / np.sqrt(max(d, 1)))
    sel_t = torch.as_tensor(sel, device=state.x.device)[:, None]
    g = torch.tensor(gamma, dtype=torch.float64, device=state.x.device)
    scale = torch.where(sel_t, torch.exp(g), torch.ones((), dtype=torch.float64, device=state.x.device))
    return _metropolis_core(ctx, state, state.x * scale, d * gamma, draws.R, draws.u_acc, draws.v_pre)
