"""The single-walker update sweep (port of the sweep loop of
smoqyelphqmc_tpu/driver.py:run_simulation, without measurements or I/O).

`run_updates` expands the model from `cfg.seed` exactly as run_simulation does,
then runs `n_sweeps` sweeps of reflection + swap + leapfrog HMC, drawing every
random number from one `torch.Generator` seeded with `cfg.seed`. It returns
run_simulation's acceptance / iteration metadata plus the per-update flags a
caller needs to check the run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
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
    preconditioner: Optional[str] = None  # 'auto' | 'spectral' | 'none'
    mixed_precision: bool = True
    force_dtype: str = "float32"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_updates(tight_binding_model, electron_phonon_model, cfg: SimulationConfig, n_sweeps: int,
                device="cpu") -> Dict:
    """Run `n_sweeps` update sweeps on `device`; returns the metadata dict
    (acceptance rates and CG iterations per solve, averaged over sweeps, as
    run_simulation reports them) with per-sweep lists and timings."""
    device = torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    tbp = TightBindingParameters.from_model(tight_binding_model, rng, device=device)
    elph = ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, electron_phonon_model, tbp, rng,
                                               device=device)
    t0 = time.perf_counter()
    ctx, state = initialize_qmc(
        tbp, elph, symmetric=cfg.symmetric, tol=cfg.tol, maxiter=cfg.maxiter, eta=cfg.eta,
        use_preconditioner=cfg.use_preconditioner, preconditioner=cfg.preconditioner,
        mixed_precision=cfg.mixed_precision, force_dtype=cfg.force_dtype,
    )
    _sync(device)
    t_init = time.perf_counter() - t0
    params = HMCParams(Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter)
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)

    keys = ("reflection", "swap", "hmc")
    acc = {k: 0.0 for k in keys}
    iters = {k: 0.0 for k in keys}
    converged = []
    delta_H = []
    sweep_s = []
    for _ in range(n_sweeps):
        t0 = time.perf_counter()
        state, r = reflection_update(ctx, state, draw_reflection(gen, ctx))
        state, s = swap_update(ctx, state, draw_swap(gen, ctx))
        state, h = hmc_update(ctx, state, params, draw_hmc(gen, ctx))
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
    meta: Dict = {
        "n_sweeps": n_sweeps,
        "Nt": cfg.Nt,
        "tol": cfg.tol,
        "seed": cfg.seed,
        "Ltau": elph.Ltau,
        "n_sites": tbp.n_sites,
        "device": str(device),
        "t_init_s": t_init,
        "sweep_s": sweep_s,
        "hmc_delta_H": delta_H,
        "all_converged": all(converged),
        "x_final": state.x,
    }
    for k in keys:
        meta[f"{k}_acceptance_rate"] = acc[k] / n
        meta[f"{k}_iters"] = iters[k] / n
    return meta
