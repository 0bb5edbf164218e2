"""EFA-PFF-HMC update of the phonon fields (port of the JAX package's updates/hmc.py).

The harmonic part integrated exactly in omega space, fresh pseudofermions at
trajectory start, warm-started f32 force solves and one f64 endpoint action
solve. Two integrators: leapfrog (quadratic extrapolation of the warm starts
at warm_order=3; Nt + 1 solves) and Omelyan's second-order minimum-norm
scheme (two kicks a step, linear warm starts with the alternating spacing
ratios; 2 Nt + 1 solves). Random draws come in as `HMCDraws`; `draw_hmc`
makes them from a torch.Generator.

`hmc_update` runs one chain, or W chains with a shared preconditioner, each
with its own draws (and, when the context carries one a walker, its own mu);
with `fused_step_force` (set by the walker sweep at W >= 2) every force
solve of all W walkers goes through one launch of kernel K3 per kick (no
SSH couplings); otherwise `force_route` takes the K2 solve and kernel K4
(its SSH form with SSH couplings) where the input allows it on the card,
walker by walker in a batch, and the eager derivative chain elsewhere. The
per-step convergence flags and iteration counts stay on the device and are
read once per trajectory. Options: `recenter`, a callable on one walker's
tau-space field applied after every drift (the drift then transforms in
f64), and `HMCParams.refresh_precond_every_step`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from .. import tracing
from ..ops import force as k4
from ..ops.bosonic import add_anharmonic_force, add_dispersive_force, bosonic_action
from ..ops.cg import CGStats
from ..ops.kpm import KPMPreconditioner
from ..ops.preconditioner import refresh_preconditioner
from ..ops.pff import ForceResult, fermionic_action, fermionic_action_and_force, sample_pseudofermion_fields
from ..ops.spectral_precond import SpectralPreconditioner
from .context import QMCContext, QMCState, make_fdm, walker_context

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class HMCParams:
    Nt: int = 24
    dt: float = 0.0  # 0 -> pi / (2 Nt)
    jitter: float = 0.05
    integrator: str = "leapfrog"  # or 'omelyan'
    warm_order: int = 3  # leapfrog's warm-start order; Omelyan's is linear
    # refresh the carried preconditioner at trajectory start (the walker sweep
    # turns it off when it refreshes one shared preconditioner per sweep)
    refresh_precond_at_start: bool = True
    # refresh it again at every kick (kick A only under Omelyan) and at the
    # endpoint, from the tables the solve uses
    refresh_precond_every_step: bool = False
    # the trajectory force solves through kernel K3 (solve + force planes; the
    # walker sweep sets it at W >= 2 with the shared preconditioner)
    fused_step_force: bool = False
    # None: the trajectory force route is decided by the input
    # (`force_route`); True / False force K4 (its plain version on the CPU)
    # or the plain chain where the planes apply, for tests
    fused_force: Optional[bool] = None

    def timestep(self) -> float:
        return self.dt if self.dt > 0 else math.pi / (2 * self.Nt)


@dataclasses.dataclass
class HMCDraws:
    """The trajectory's random numbers: timestep jitter u_dt ~ U(0,1),
    pseudofermion noise R (2, Ltau, N) ~ N(0, 1/2), momentum noise xi
    (n_phonon, Ltau) ~ N(0, 1), acceptance u_acc ~ U(0,1), and the Lanczos
    start vector v_pre0 (N,) ~ N(0, 1), (2N,) for complex hoppings, of the
    trajectory-start refresh of a KPM preconditioner (the JAX package's
    k_pre0; None for other chains), and with refresh_precond_every_step the
    Nt + 1 start vectors v_steps of the kicks' and the endpoint's refreshes."""

    u_dt: float
    R: torch.Tensor
    xi: torch.Tensor
    u_acc: float
    v_pre0: Optional[torch.Tensor] = None
    v_steps: Optional[List[torch.Tensor]] = None


def draw_hmc(gen: torch.Generator, ctx: QMCContext, precond=None, params: Optional[HMCParams] = None) -> HMCDraws:
    """Draws on the generator's device, moved to the context's device in
    float64. The KPM start vectors come last and only when the chain carries
    a KPM preconditioner (v_steps only with params.refresh_precond_every_step),
    so the other chains keep their random streams."""
    f64, dev = torch.float64, ctx.device
    u_dt = float(torch.rand((), generator=gen, dtype=f64))
    R = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=f64) / math.sqrt(2.0)
    xi = torch.randn((ctx.elph.n_phonon, ctx.Ltau), generator=gen, dtype=f64)
    u_acc = float(torch.rand((), generator=gen, dtype=f64))
    v_pre0 = v_steps = None
    if isinstance(precond, KPMPreconditioner):
        v_pre0 = torch.randn((ctx.lanczos_dim,), generator=gen, dtype=f64).to(dev)
        if params is not None and params.refresh_precond_every_step:
            v_steps = [torch.randn((ctx.lanczos_dim,), generator=gen, dtype=f64).to(dev)
                       for _ in range(params.Nt + 1)]
    return HMCDraws(u_dt=u_dt, R=R.to(dev), xi=xi.to(dev), u_acc=u_acc, v_pre0=v_pre0, v_steps=v_steps)


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


# Omelyan's minimum-norm lambda (Omelyan, Mryglod, Folk 2003)
OMELYAN_LAMBDA = 0.1931833275037836


def _integrate(ctx: QMCContext, params: HMCParams, x0: torch.Tensor, pw, dt, force, recenter=None):
    """The trajectory from the field x0 with omega-space momenta pw.
    `force(x, psi_warm, refresh)` returns the fermionic ForceResult at x,
    warm-started from psi_warm, after refreshing the preconditioner when
    refresh is set. x0 may carry a leading walker axis (dt is then a
    (W, 1, 1) tensor and the flags are per walker). Returns (x, pw, the last
    solve's psi_raw, iterations summed, ok, solves), iterations and ok device
    tensors, unread.

    Leapfrog: D(dt/2) [K(dt) D(dt)]^{Nt-1} K(dt) D(dt/2). Omelyan:
    [D(l dt) K(dt/2) D((1-2l) dt) K(dt/2) D(l dt)]^Nt with neighbouring
    D(l dt) D(l dt) merged into D(2 l dt)."""
    elph, efa = ctx.elph, ctx.efa
    fdt = _DTYPES[ctx.force_dtype]
    # the per-step transforms feed only the force; with a recenter the
    # recentered x re-enters the exact carry, so they stay f64
    use_f32_step = fdt != torch.float64 and recenter is None
    lead = tuple(x0.shape[:-2])
    omelyan = params.integrator == "omelyan"
    n_hist = 2 if omelyan else max(2, min(params.warm_order, 4))
    hist = [torch.zeros(lead + (2, elph.Ltau, ctx.n_sites), dtype=fdt, device=x0.device) for _ in range(n_hist)]
    iters_sum = torch.zeros(lead, dtype=torch.int64, device=x0.device)
    ok = torch.ones(lead, dtype=torch.bool, device=x0.device)
    every_step = params.refresh_precond_every_step

    def kick(x, pw, psi_warm, dt_kick, refresh):
        nonlocal hist, iters_sum, ok
        res = force(x, psi_warm, refresh)
        hist = [res.psi_raw.to(fdt)] + hist[:-1]
        f = add_dispersive_force(add_anharmonic_force(res.force, elph, x), elph, x)
        ok = ok & res.stats.converged.to(ok.device) & torch.isfinite(f).all(dim=-1).all(dim=-1)
        iters_sum = iters_sum + res.stats.iters.to(iters_sum.device)
        return (efa.kick_omega_f32 if use_f32_step else efa.kick_omega)(pw, f, dt_kick)

    def drift(xw, pw, rot):
        xw, pw = efa.rotate_tabulated(xw, pw, rot)
        if use_f32_step:
            return efa.to_tau_f32(*xw), xw, pw
        x = efa.to_tau(*xw)
        if recenter is not None:
            x = torch.stack([recenter(xk) for xk in x]) if lead else recenter(x)
            xw = efa.to_omega(x)
        return x, xw, pw

    if omelyan:
        lam = OMELYAN_LAMBDA
        rot_lam, rot_2lam = efa.rotation(lam * dt), efa.rotation(2.0 * lam * dt)
        rot_mid = efa.rotation((1.0 - 2.0 * lam) * dt)
        # the warm starts extrapolate linearly over the alternating spacings:
        # before kick A the field drifted 2 l dt since kick B, before kick B
        # (1 - 2 l) dt; from the third solve on
        c_a, c_b = 2.0 * lam / (1.0 - 2.0 * lam), (1.0 - 2.0 * lam) / (2.0 * lam)
        x, xw, pw = drift(efa.to_omega(x0), pw, rot_lam)
        for t in range(params.Nt):
            pw = kick(x, pw, _linear_warm_start(hist, c_a if t >= 1 else 0.0), dt / 2.0, every_step)
            x, xw, pw = drift(xw, pw, rot_mid)
            # kick B never refreshes: one refresh a step, as leapfrog's
            pw = kick(x, pw, _linear_warm_start(hist, c_b if t >= 1 else 0.0), dt / 2.0, False)
            x, xw, pw = drift(xw, pw, rot_2lam if t < params.Nt - 1 else rot_lam)
        n_solves = 2 * params.Nt + 1
    elif params.integrator == "leapfrog":
        rot_half, rot_full = efa.rotation(dt / 2.0), efa.rotation(dt)
        x, xw, pw = drift(efa.to_omega(x0), pw, rot_half)
        for t in range(params.Nt):
            pw = kick(x, pw, _warm_start(hist, t), dt, every_step)
            x, xw, pw = drift(xw, pw, rot_full if t < params.Nt - 1 else rot_half)
        n_solves = params.Nt + 1
    else:
        raise ValueError(f"HMCParams.integrator must be 'leapfrog' or 'omelyan', got {params.integrator!r}")
    if use_f32_step:
        x = efa.to_tau(*xw)
    return x, pw, hist[0], iters_sum, ok, n_solves


def _warm_start(hist, n_prev: int) -> torch.Tensor:
    """Chronological extrapolation through the previous n_prev solutions
    (newest first): the backward differences whose solutions exist."""
    psi_warm = hist[0]
    for k in range(len(hist) - 1):
        if n_prev >= k + 2:
            psi_warm = psi_warm + _DIFFS[k](hist)
    return psi_warm


def _linear_warm_start(hist, c: float) -> torch.Tensor:
    """psi + c (psi - psi_prev), c the ratio of the coming spacing to the last."""
    return hist[0] + c * (hist[0] - hist[1]) if c else hist[0]


def planes_apply(ctx: QMCContext) -> bool:
    """Whether the force planes of kernel K4 (and its SSH form's hop plane)
    are the trajectory force: f32 forces, the symmetric factorization and
    real hoppings (ops/pff.py's gate)."""
    return ctx.force_dtype == "float32" and ctx.symmetric and not ctx.complex_hops


def k3_trajectory_applies(ctx: QMCContext, precond) -> bool:
    """Whether kernel K3 can run the trajectory force solves: where the
    planes apply, without SSH couplings (K3's epilogue has no SSH form), with
    the spectral preconditioner."""
    return planes_apply(ctx) and ctx.elph.n_ssh == 0 and isinstance(precond, SpectralPreconditioner)


def force_route(ctx: QMCContext, precond, params: HMCParams, device: torch.device) -> str:
    """The route of a trajectory's force evaluations on `device`: 'k3' where
    params.fused_step_force asks for K3 and it applies; else 'k4' (the K2
    solve, then K4's planes, and its SSH form's hop plane with SSH
    couplings) where the planes apply and params.fused_force
    is True, or is None on a CUDA device whose K4 takes the lattice
    (`ops.force.fits`); else 'plain' (the solve, then the eager derivative
    chain). On the CPU, with fused_force None, the plain chain: the planes
    save no launch there."""
    if params.fused_step_force and k3_trajectory_applies(ctx, precond):
        return "k3"
    if not planes_apply(ctx) or params.fused_force is False:
        return "plain"
    if params.fused_force or (device.type == "cuda" and k4.fits(ctx.n_sites)):
        return "k4"
    return "plain"


def _stack_forces(results: Sequence[ForceResult]) -> ForceResult:
    st = [r.stats for r in results]
    stats = CGStats(iters=torch.stack([s.iters for s in st]), eps=torch.stack([s.eps for s in st]),
                    converged=torch.stack([s.converged for s in st]))
    return ForceResult(Sf=torch.stack([r.Sf for r in results]), force=torch.stack([r.force for r in results]),
                       psi_raw=torch.stack([r.psi_raw for r in results]), stats=stats)


def hmc_update(ctx: QMCContext, state: QMCState, params: HMCParams, draws,
               recenter: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """One EFA-PFF-HMC trajectory.

    state.x is one chain's field (n_phonon, Ltau) with one HMCDraws, or the
    fields of W walkers (W, n_phonon, Ltau) with a sequence of W draws; the
    walkers share the preconditioner state.precond, which the walker sweep
    refreshes (refresh_precond_at_start and refresh_precond_every_step must
    then be off), and each walker's fermion matrix carries its own mu when
    ctx.tbp.mu has one a walker. With params.fused_step_force, and where K3
    applies, every force solve runs through kernel K3, the W walkers' in one
    launch per kick; otherwise each walker's force runs on its own (the K2
    solve, then kernel K4 or the plain chain: `force_route`). The
    f64 pieces (pseudofermion sampling, endpoint action, Metropolis decision)
    run walker by walker. `recenter` maps one walker's tau-space field to a
    field and runs after every drift. Returns (state, HMCStats), the stats a
    list over walkers for a batch."""
    batched = state.x.dim() == 3
    if batched and (params.refresh_precond_at_start or params.refresh_precond_every_step):
        raise ValueError("a walker batch shares one preconditioner, refreshed by the walker sweep: "
                         "set refresh_precond_at_start and refresh_precond_every_step to False")
    elph, efa = ctx.elph, ctx.efa
    x0 = state.x
    xs0 = x0 if batched else x0[None]
    ds = list(draws) if batched else [draws]
    ctxs = [walker_context(ctx, w) for w in range(len(ds))] if batched else [ctx]
    dts = [params.timestep() * (1.0 + (2.0 * d.u_dt - 1.0) * params.jitter) for d in ds]
    dt = torch.tensor(dts, dtype=torch.float64, device=x0.device)[:, None, None] if batched else dts[0]

    fdm0 = [make_fdm(c, xw) for c, xw in zip(ctxs, xs0)]
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
    route = force_route(ctx, precond, params, x0.device)
    use_k3 = route == "k3"
    # the per-step refreshes' KPM start vectors, in order (kicks, endpoint)
    v_steps = iter(ds[0].v_steps or ())

    def force_of(phi, c, x, psi_warm, fdm):
        return fermionic_action_and_force(
            phi, elph, fdm, x, ctx.plan, precond=precond, tol=ctx.tol_force,
            maxiter=ctx.maxiter, mixed=ctx.mixed_precision, solve_dtype=ctx.force_dtype, warm_start=psi_warm,
            route=route,
        )

    def force(x, psi_warm, refresh):
        nonlocal precond
        tracing.FORCE_ROUTES[route] += len(ds)
        with tracing.span("force", route=route, walkers=len(ds)):
            if use_k3 or not batched:
                fdm = make_fdm(ctx, x, dtype=force_tab_dt)
                if refresh and precond is not None:
                    precond = refresh_preconditioner(precond, fdm, next(v_steps, None))
                return force_of(Phi, ctx, x, psi_warm, fdm)
            return _stack_forces([force_of(Phi[w], c, x[w], psi_warm[w], make_fdm(c, x[w], dtype=force_tab_dt))
                                  for w, c in enumerate(ctxs)])

    x, pw, psi_last, iters_sum, ok, n_solves = _integrate(ctx, params, x0, pw, dt, force, recenter)
    xs, psis = (x, psi_last) if batched else (x[None], psi_last[None])
    pws1 = pw if batched else tuple(p[None] for p in pw)
    ok_host, iters_host = ok.reshape(-1).tolist(), iters_sum.reshape(-1).tolist()
    x_out, stats = [], []
    for w, (c, d) in enumerate(zip(ctxs, ds)):
        fdm1 = make_fdm(c, xs[w])
        if precond is not None and params.refresh_precond_every_step:
            precond = refresh_preconditioner(precond, fdm1, next(v_steps, None))
        res1 = fermionic_action(
            Phis[w], elph, fdm1, xs[w], precond=precond, tol=ctx.tol, maxiter=ctx.maxiter,
            mixed=ctx.mixed_precision, warm_start=psis[w].to(torch.float64),
        )
        ok_w = ok_host[w] and bool(res1.stats.converged) and bool(torch.isfinite(res1.Sf))
        H1 = res1.Sf + bosonic_action(elph, xs[w]) + efa.kinetic_energy_omega(tuple(p[w] for p in pws1))
        dH = float(H1 - H0[w])
        iters = iters_host[w] + int(res1.stats.iters)
        accepted = d.u_acc < metropolis_probability(dH, ok_w)
        x_out.append(xs[w] if accepted else xs0[w])
        stats.append(HMCStats(accepted=accepted, delta_H=dH, iters_avg=iters / n_solves, converged=ok_w,
                              H0=float(H0[w])))
    if not batched:
        return QMCState(x=x_out[0], precond=precond), stats[0]
    return QMCState(x=torch.stack(x_out), precond=precond), stats
