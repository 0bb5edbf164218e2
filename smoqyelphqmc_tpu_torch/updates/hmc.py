"""EFA-PFF-HMC update of the phonon fields (port of smoqyelphqmc_tpu/updates/hmc.py).

Leapfrog with the harmonic part integrated exactly in omega space, fresh
pseudofermions at trajectory start, warm-started f32 force solves (quadratic
extrapolation at warm_order=3) and one f64 endpoint action solve. Omelyan
waits (ROADMAP Queue 1, item 17). Random draws come in as `HMCDraws`;
`draw_hmc` makes them from a torch.Generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.bosonic import add_anharmonic_force, bosonic_action
from ..ops.preconditioner import refresh_preconditioner
from ..ops.pff import fermionic_action, fermionic_action_and_force, sample_pseudofermion_fields
from .context import QMCContext, QMCState, make_fdm

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class HMCParams:
    Nt: int = 24
    dt: float = 0.0  # 0 -> pi / (2 Nt)
    jitter: float = 0.05
    integrator: str = "leapfrog"
    warm_order: int = 3

    def timestep(self) -> float:
        return self.dt if self.dt > 0 else math.pi / (2 * self.Nt)


@dataclasses.dataclass
class HMCDraws:
    """The trajectory's random numbers: timestep jitter u_dt ~ U(0,1),
    pseudofermion noise R (2, Ltau, N) ~ N(0, 1/2), momentum noise xi
    (n_phonon, Ltau) ~ N(0, 1), acceptance u_acc ~ U(0,1)."""

    u_dt: float
    R: torch.Tensor
    xi: torch.Tensor
    u_acc: float


def draw_hmc(gen: torch.Generator, ctx: QMCContext) -> HMCDraws:
    """Draws on the generator's device, moved to the context's device in float64."""
    f64, dev = torch.float64, ctx.device
    u_dt = float(torch.rand((), generator=gen, dtype=f64))
    R = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=f64) / math.sqrt(2.0)
    xi = torch.randn((ctx.elph.n_phonon, ctx.Ltau), generator=gen, dtype=f64)
    u_acc = float(torch.rand((), generator=gen, dtype=f64))
    return HMCDraws(u_dt=u_dt, R=R.to(dev), xi=xi.to(dev), u_acc=u_acc)


class HMCStats(NamedTuple):
    accepted: bool
    delta_H: float
    iters_avg: float
    converged: bool
    H0: float


def metropolis_probability(dS: float, ok: bool, log_weight: float = 0.0) -> float:
    """min(1, exp(-dS + log_weight)), and 0 when a solve failed or dS is not finite."""
    if not ok or not math.isfinite(dS):
        return 0.0
    a = -dS + log_weight
    return 1.0 if a >= 0 else math.exp(a)


_DIFFS = (
    lambda h: h[0] - h[1],
    lambda h: h[0] - 2.0 * h[1] + h[2],
    lambda h: h[0] - 3.0 * h[1] + 3.0 * h[2] - h[3],
)


def hmc_update(ctx: QMCContext, state: QMCState, params: HMCParams, draws: HMCDraws) -> tuple[QMCState, HMCStats]:
    """One leapfrog EFA-PFF-HMC trajectory."""
    if params.integrator != "leapfrog":
        raise NotImplementedError("only the leapfrog integrator is ported (ROADMAP Queue 1, item 17)")
    elph, efa = ctx.elph, ctx.efa
    Nt = params.Nt
    dt = params.timestep() * (1.0 + (2.0 * draws.u_dt - 1.0) * params.jitter)

    x0 = state.x
    fdm0 = make_fdm(ctx, x0)
    precond = state.precond
    if precond is not None:  # once per trajectory, at its start
        precond = refresh_preconditioner(precond, fdm0)

    Phi, Sf0 = sample_pseudofermion_fields(draws.R, elph, fdm0, x0)
    Sb0 = bosonic_action(elph, x0)
    pw, K0 = efa.sample_momentum_omega(draws.xi)
    H0 = Sf0 + Sb0 + K0

    n_hist = max(2, min(params.warm_order, 4))
    fdt = _DTYPES[ctx.force_dtype]
    hist = [torch.zeros((2, elph.Ltau, ctx.n_sites), dtype=fdt, device=x0.device) for _ in range(n_hist)]
    force_tab_dt = None if fdt == torch.float64 else ctx.force_dtype
    use_f32_step = force_tab_dt is not None
    iters_sum = 0
    ok = True

    def force_kick(x, pw, n_prev):
        """Solve the force at x (warm start extrapolated through the previous
        n_prev solutions) and kick p_omega by dt."""
        nonlocal hist, iters_sum, ok
        fdm = make_fdm(ctx, x, dtype=force_tab_dt)
        psi_warm = hist[0]
        for k in range(n_hist - 1):
            if n_prev >= k + 2:
                psi_warm = psi_warm + _DIFFS[k](hist)
        res = fermionic_action_and_force(
            Phi, elph, fdm, x, ctx.plan, precond=precond, tol=ctx.tol_force, maxiter=ctx.maxiter,
            mixed=ctx.mixed_precision, solve_dtype=ctx.force_dtype, warm_start=psi_warm,
        )
        hist = [res.psi_raw.to(fdt)] + hist[:-1]
        force = add_anharmonic_force(res.force, elph, x)
        ok = ok and bool(res.stats.converged) and bool(torch.isfinite(force).all())
        iters_sum += int(res.stats.iters)
        kick = efa.kick_omega_f32 if use_f32_step else efa.kick_omega
        return kick(pw, force, dt)

    def drift(xw, pw, rot):
        xw, pw = efa.rotate_tabulated(xw, pw, rot)
        x = efa.to_tau_f32(*xw) if use_f32_step else efa.to_tau(*xw)
        return x, xw, pw

    # D(dt/2) [K(dt) D(dt)]^{Nt-1} K(dt) D(dt/2)
    rot_half = efa.rotation(dt / 2.0)
    rot_full = efa.rotation(dt)
    x, xw, pw = drift(efa.to_omega(x0), pw, rot_half)
    for t in range(Nt - 1):
        pw = force_kick(x, pw, t)
        x, xw, pw = drift(xw, pw, rot_full)
    pw = force_kick(x, pw, Nt - 1)
    x, xw, pw = drift(xw, pw, rot_half)
    n_solves = Nt + 1
    if use_f32_step:
        x = efa.to_tau(*xw)

    fdm1 = make_fdm(ctx, x)
    res1 = fermionic_action(
        Phi, elph, fdm1, x, precond=precond, tol=ctx.tol, maxiter=ctx.maxiter,
        mixed=ctx.mixed_precision, warm_start=hist[0].to(torch.float64),
    )
    ok = ok and bool(res1.stats.converged) and bool(torch.isfinite(res1.Sf))
    H1 = res1.Sf + bosonic_action(elph, x) + efa.kinetic_energy_omega(pw)
    dH = float(H1 - H0)
    iters_sum += int(res1.stats.iters)

    accepted = draws.u_acc < metropolis_probability(dH, ok)
    stats = HMCStats(accepted=accepted, delta_H=dH, iters_avg=iters_sum / n_solves, converged=ok,
                     H0=float(H0))
    return QMCState(x=x if accepted else x0, precond=precond), stats
