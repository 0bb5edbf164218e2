"""EFA-PFF-HMC update of the phonon fields (port of the JAX package's updates/hmc.py).

Leapfrog with the harmonic part integrated exactly in omega space, fresh
pseudofermions at trajectory start, warm-started f32 force solves (quadratic
extrapolation at warm_order=3) and one f64 endpoint action solve. Omelyan
waits (ROADMAP Queue 1, item 17). Random draws come in as `HMCDraws`;
`draw_hmc` makes them from a torch.Generator.

`hmc_update` runs one chain, or W chains with a shared preconditioner, each
with its own draws; with `fused_step_force` (set by the walker sweep at
W >= 2) every force solve of all W walkers goes through one launch of kernel
K3 per leapfrog step. The per-step convergence flags and iteration counts
stay on the device and are read once per trajectory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.bosonic import add_anharmonic_force, bosonic_action
from ..ops.cg import CGStats
from ..ops.kpm import KPMPreconditioner
from ..ops.preconditioner import refresh_preconditioner
from ..ops.pff import ForceResult, fermionic_action, fermionic_action_and_force, sample_pseudofermion_fields
from ..ops.spectral_precond import SpectralPreconditioner
from .context import QMCContext, QMCState, make_fdm

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class HMCParams:
    Nt: int = 24
    dt: float = 0.0  # 0 -> pi / (2 Nt)
    jitter: float = 0.05
    integrator: str = "leapfrog"
    warm_order: int = 3
    # refresh the carried preconditioner at trajectory start (the walker sweep
    # turns it off when it refreshes one shared preconditioner per sweep)
    refresh_precond_at_start: bool = True
    # the trajectory force solves through kernel K3 (solve + force planes; the
    # walker sweep sets it at W >= 2 with the shared preconditioner)
    fused_step_force: bool = False
    # the trajectory forces through the K2 solve and kernel K4 (the port's
    # counterpart of the JAX package's SMOQY_FUSED_FORCE=1)
    fused_force: bool = False

    def timestep(self) -> float:
        return self.dt if self.dt > 0 else math.pi / (2 * self.Nt)


@dataclasses.dataclass
class HMCDraws:
    """The trajectory's random numbers: timestep jitter u_dt ~ U(0,1),
    pseudofermion noise R (2, Ltau, N) ~ N(0, 1/2), momentum noise xi
    (n_phonon, Ltau) ~ N(0, 1), acceptance u_acc ~ U(0,1), and the Lanczos
    start vector v_pre0 (N,) ~ N(0, 1), (2N,) for complex hoppings, of the
    trajectory-start refresh of a KPM preconditioner (the JAX package's
    k_pre0; None for other chains)."""

    u_dt: float
    R: torch.Tensor
    xi: torch.Tensor
    u_acc: float
    v_pre0: Optional[torch.Tensor] = None


def draw_hmc(gen: torch.Generator, ctx: QMCContext, precond=None) -> HMCDraws:
    """Draws on the generator's device, moved to the context's device in
    float64. v_pre0 is drawn, last, only when the chain carries a KPM
    preconditioner, so the other chains keep their random streams."""
    f64, dev = torch.float64, ctx.device
    u_dt = float(torch.rand((), generator=gen, dtype=f64))
    R = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=f64) / math.sqrt(2.0)
    xi = torch.randn((ctx.elph.n_phonon, ctx.Ltau), generator=gen, dtype=f64)
    u_acc = float(torch.rand((), generator=gen, dtype=f64))
    v_pre0 = None
    if isinstance(precond, KPMPreconditioner):
        v_pre0 = torch.randn((ctx.lanczos_dim,), generator=gen, dtype=f64).to(dev)
    return HMCDraws(u_dt=u_dt, R=R.to(dev), xi=xi.to(dev), u_acc=u_acc, v_pre0=v_pre0)


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


def _leapfrog(ctx: QMCContext, params: HMCParams, x0: torch.Tensor, pw, dt, force):
    """D(dt/2) [K(dt) D(dt)]^{Nt-1} K(dt) D(dt/2) from the field x0 with omega-
    space momenta pw. `force(x, psi_warm)` returns the fermionic ForceResult at
    x, warm-started from the extrapolated solution history. x0 may carry a
    leading walker axis (dt is then a (W, 1, 1) tensor and the flags are per
    walker). Returns (x, pw, the last solve's psi_raw, iterations summed, ok),
    the last two device tensors, unread."""
    elph, efa = ctx.elph, ctx.efa
    fdt = _DTYPES[ctx.force_dtype]
    use_f32_step = fdt != torch.float64
    lead = tuple(x0.shape[:-2])
    n_hist = max(2, min(params.warm_order, 4))
    hist = [torch.zeros(lead + (2, elph.Ltau, ctx.n_sites), dtype=fdt, device=x0.device) for _ in range(n_hist)]
    iters_sum = torch.zeros(lead, dtype=torch.int64, device=x0.device)
    ok = torch.ones(lead, dtype=torch.bool, device=x0.device)

    def kick(x, pw, n_prev):
        nonlocal hist, iters_sum, ok
        res = force(x, _warm_start(hist, n_prev))
        hist = [res.psi_raw.to(fdt)] + hist[:-1]
        f = add_anharmonic_force(res.force, elph, x)
        ok = ok & res.stats.converged.to(ok.device) & torch.isfinite(f).all(dim=-1).all(dim=-1)
        iters_sum = iters_sum + res.stats.iters.to(iters_sum.device)
        return (efa.kick_omega_f32 if use_f32_step else efa.kick_omega)(pw, f, dt)

    def drift(xw, pw, rot):
        xw, pw = efa.rotate_tabulated(xw, pw, rot)
        return (efa.to_tau_f32(*xw) if use_f32_step else efa.to_tau(*xw)), xw, pw

    rot_half = efa.rotation(dt / 2.0)
    rot_full = efa.rotation(dt)
    x, xw, pw = drift(efa.to_omega(x0), pw, rot_half)
    for t in range(params.Nt - 1):
        pw = kick(x, pw, t)
        x, xw, pw = drift(xw, pw, rot_full)
    pw = kick(x, pw, params.Nt - 1)
    x, xw, pw = drift(xw, pw, rot_half)
    if use_f32_step:
        x = efa.to_tau(*xw)
    return x, pw, hist[0], iters_sum, ok


def _warm_start(hist, n_prev: int) -> torch.Tensor:
    """Chronological extrapolation through the previous n_prev solutions
    (newest first): the backward differences whose solutions exist."""
    psi_warm = hist[0]
    for k in range(len(hist) - 1):
        if n_prev >= k + 2:
            psi_warm = psi_warm + _DIFFS[k](hist)
    return psi_warm


def k3_trajectory_applies(ctx: QMCContext, precond) -> bool:
    """Whether kernel K3 can run the trajectory force solves: f32 forces, the
    symmetric factorization, real hoppings and the spectral preconditioner."""
    return (ctx.force_dtype == "float32" and ctx.symmetric and not ctx.complex_hops
            and isinstance(precond, SpectralPreconditioner))


def _stack_forces(results: Sequence[ForceResult]) -> ForceResult:
    st = [r.stats for r in results]
    stats = CGStats(iters=torch.stack([s.iters for s in st]), eps=torch.stack([s.eps for s in st]),
                    converged=torch.stack([s.converged for s in st]))
    return ForceResult(Sf=torch.stack([r.Sf for r in results]), force=torch.stack([r.force for r in results]),
                       psi_raw=torch.stack([r.psi_raw for r in results]), stats=stats)


def hmc_update(ctx: QMCContext, state: QMCState, params: HMCParams, draws):
    """One leapfrog EFA-PFF-HMC trajectory.

    state.x is one chain's field (n_phonon, Ltau) with one HMCDraws, or the
    fields of W walkers (W, n_phonon, Ltau) with a sequence of W draws; the
    walkers share the preconditioner state.precond, which the walker sweep
    refreshes (refresh_precond_at_start must then be off). With
    params.fused_step_force, and where K3 applies, every force solve runs
    through kernel K3, the W walkers' in one launch per leapfrog step;
    otherwise each walker's force runs on its own (the K2 solve, then the
    plain chain or, with params.fused_force, kernel K4). The f64 pieces
    (pseudofermion sampling, endpoint action, Metropolis decision) run walker
    by walker. Returns (state, HMCStats), the stats a list over walkers for a
    batch."""
    if params.integrator != "leapfrog":
        raise NotImplementedError("only the leapfrog integrator is ported (ROADMAP Queue 1, item 17)")
    batched = state.x.dim() == 3
    if batched and params.refresh_precond_at_start:
        raise ValueError("a walker batch shares one preconditioner, refreshed by the walker sweep: "
                         "set refresh_precond_at_start=False")
    elph, efa = ctx.elph, ctx.efa
    x0 = state.x
    xs0 = x0 if batched else x0[None]
    ds = list(draws) if batched else [draws]
    dts = [params.timestep() * (1.0 + (2.0 * d.u_dt - 1.0) * params.jitter) for d in ds]
    dt = torch.tensor(dts, dtype=torch.float64, device=x0.device)[:, None, None] if batched else dts[0]

    fdm0 = [make_fdm(ctx, xw) for xw in xs0]
    precond = state.precond
    if precond is not None and params.refresh_precond_at_start:  # once per trajectory, at its start
        precond = refresh_preconditioner(precond, fdm0[0], ds[0].v_pre0)

    Phis, H0, pws = [], [], []
    for xw, fw, d in zip(xs0, fdm0, ds):
        phi, Sf0 = sample_pseudofermion_fields(d.R, elph, fw, xw)
        pw_w, K0 = efa.sample_momentum_omega(d.xi)
        Phis.append(phi)
        pws.append(pw_w)
        H0.append(Sf0 + bosonic_action(elph, xw) + K0)
    Phi = torch.stack(Phis) if batched else Phis[0]
    pw = tuple(torch.stack(p) for p in zip(*pws)) if batched else pws[0]
    force_tab_dt = None if ctx.force_dtype == "float64" else ctx.force_dtype
    use_k3 = params.fused_step_force and k3_trajectory_applies(ctx, precond)

    def force_of(phi, x, psi_warm):
        return fermionic_action_and_force(
            phi, elph, make_fdm(ctx, x, dtype=force_tab_dt), x, ctx.plan, precond=precond, tol=ctx.tol_force,
            maxiter=ctx.maxiter, mixed=ctx.mixed_precision, solve_dtype=ctx.force_dtype, warm_start=psi_warm,
            fused_step=use_k3, fused_force=params.fused_force,
        )

    def force(x, psi_warm):
        if use_k3 or not batched:
            return force_of(Phi, x, psi_warm)
        return _stack_forces([force_of(Phi[w], x[w], psi_warm[w]) for w in range(len(ds))])

    x, pw, psi_last, iters_sum, ok = _leapfrog(ctx, params, x0, pw, dt, force)
    xs, psis = (x, psi_last) if batched else (x[None], psi_last[None])
    pws1 = pw if batched else tuple(p[None] for p in pw)
    ok_host, iters_host = ok.reshape(-1).tolist(), iters_sum.reshape(-1).tolist()
    x_out, stats = [], []
    for w, d in enumerate(ds):
        res1 = fermionic_action(
            Phis[w], elph, make_fdm(ctx, xs[w]), xs[w], precond=precond, tol=ctx.tol, maxiter=ctx.maxiter,
            mixed=ctx.mixed_precision, warm_start=psis[w].to(torch.float64),
        )
        ok_w = ok_host[w] and bool(res1.stats.converged) and bool(torch.isfinite(res1.Sf))
        H1 = res1.Sf + bosonic_action(elph, xs[w]) + efa.kinetic_energy_omega(tuple(p[w] for p in pws1))
        dH = float(H1 - H0[w])
        iters = iters_host[w] + int(res1.stats.iters)
        accepted = d.u_acc < metropolis_probability(dH, ok_w)
        x_out.append(xs[w] if accepted else xs0[w])
        stats.append(HMCStats(accepted=accepted, delta_H=dH, iters_avg=iters / (params.Nt + 1), converged=ok_w,
                              H0=float(H0[w])))
    if not batched:
        return QMCState(x=x_out[0], precond=precond), stats[0]
    return QMCState(x=torch.stack(x_out), precond=precond), stats
