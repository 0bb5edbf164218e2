"""The update sweep (port of the sweep loops of
smoqyelphqmc_tpu/driver.py:run_simulation, without measurements or I/O).

`run_updates` expands the model from `cfg.seed` exactly as run_simulation does,
then runs `n_sweeps` sweeps of reflection + swap + leapfrog HMC. At
`cfg.n_walkers` = 1 every random number comes from one `torch.Generator`
seeded with `cfg.seed`; at W >= 2 (the multi-walker driver, driver.py:774-865)
each walker has its own generator, seeded from `cfg.seed` and its index, and
the sweeps follow `parallel.walkers.walker_sweep` with the shared
preconditioner refresh and its fallback controller. It returns
run_simulation's acceptance / iteration metadata (walker-averaged), the KPM
preconditioner's diagnostics when the chain carries one, and the per-update
flags a caller needs to check the run.

A KPM preconditioner ('kpm', or 'auto' above 4000 sites) runs at W = 1: its
initial Lanczos start vector is the first draw of the chain's generator
(length 2N for complex hoppings). Complex hoppings run at W = 1.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .ops.kpm import KPMPreconditioner
from .ops.preconditioner import resolve_kind
from .parallel.walkers import PrecondFallbackController, draw_walker, init_walker_states, walker_sweep
from .updates.context import initialize_qmc
from .updates.global_updates import draw_reflection, draw_swap, reflection_update, swap_update
from .updates.hmc import HMCParams, draw_hmc, hmc_update


@dataclasses.dataclass
class SimulationConfig:
    """The fields of the JAX package's SimulationConfig that the update sweep reads."""

    beta: float
    dtau: float = 0.05
    Nt: int = 24
    hmc_dt: float = 0.0  # 0 -> pi / (2 Nt)
    hmc_jitter: float = 0.05
    eta: float = 0.0
    tol: float = 1e-10
    maxiter: int = 10_000
    seed: int = 1
    symmetric: bool = True
    use_preconditioner: bool = True
    preconditioner: Optional[str] = None  # 'auto' | 'spectral' | 'kpm' | 'none'
    mixed_precision: bool = True
    force_dtype: str = "float32"
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


def walker_seed(seed: int, w: int) -> int:
    """The seed of walker w's generator."""
    return int(np.random.SeedSequence([seed, w]).generate_state(1)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fold_kpm_diagnostics(metadata: Dict, precond) -> None:
    """Record a KPM preconditioner's self-diagnostics in the metadata
    (smoqyelphqmc_tpu/driver.py:fold_kpm_diagnostics): whether it is active
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


def run_updates(tight_binding_model, electron_phonon_model, cfg: SimulationConfig, n_sweeps: int,
                device="cuda") -> Dict:
    """Run `n_sweeps` update sweeps on `device` (the card unless the caller
    asks for the CPU); returns the metadata dict
    (acceptance rates and CG iterations per solve, averaged over sweeps, as
    run_simulation reports them) with per-sweep lists and timings."""
    device = torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    tbp = TightBindingParameters.from_model(tight_binding_model, rng, device=device)
    elph = ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, electron_phonon_model, tbp, rng,
                                               device=device)
    return run_sweeps(tbp, elph, cfg, n_sweeps)


def run_sweeps(tbp: TightBindingParameters, elph: ElectronPhononParameters, cfg: SimulationConfig,
               n_sweeps: int) -> Dict:
    """`run_updates` from expanded parameters, on the device of `elph` (for a
    caller with tables of its own, such as relabelled sites). Each sweep runs
    inside a profiler range named "sweep"."""
    device = elph.device
    kind = resolve_kind(cfg.preconditioner or "auto", tbp.n_sites) if cfg.use_preconditioner else None
    if kind == "kpm" and cfg.n_walkers > 1:
        raise NotImplementedError("the walker path with a KPM preconditioner is not ported yet "
                                  "(ROADMAP Queue 1, item 20)")
    if tbp.t0_im is not None and cfg.n_walkers > 1:
        raise NotImplementedError("the walker path with complex hoppings is not ported yet "
                                  "(ROADMAP Queue 1, item 21)")
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
    t_init = time.perf_counter() - t0
    params = HMCParams(Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, fused_force=cfg.fused_force)
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
            state, r = reflection_update(ctx, state, draw_reflection(gen, ctx))
            state, s = swap_update(ctx, state, draw_swap(gen, ctx))
            state, h = hmc_update(ctx, state, params, draw_hmc(gen, ctx, state.precond))
            _sync(device)
        sweep_s.append(time.perf_counter() - t0)
        for k, st in zip(keys, (r, s, h)):
            acc[k] += float(st.accepted)
            converged.append(bool(st.converged))
        iters["reflection"] += r.iters
        iters["swap"] += s.iters
        iters["hmc"] += h.iters_avg
        delta_H.append(h.delta_H)
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
