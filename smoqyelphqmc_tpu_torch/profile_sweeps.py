"""Device-time profile of the update sweeps.

    python -m smoqyelphqmc_tpu_torch.profile_sweeps [--walkers 8] [--sweeps 3] [--warmup 2]
    python -m smoqyelphqmc_tpu_torch.profile_sweeps --walkers 1 --L 48 --alpha 1.5 --preconditioner auto \
        --sweeps 2 --warmup 1 --compare-preconditioners
    python -m smoqyelphqmc_tpu_torch.profile_sweeps --walkers 1 --model complex_chain --preconditioner kpm \
        --sweeps 2 --warmup 1

Runs the headline model (Holstein honeycomb L=12, beta=12, dtau=0.05,
alpha=0.6, Omega=1, mu=0, Nt=24, tol 1e-10, mixed precision, f32 forces,
spectral preconditioner, seed 1; `--L`, `--beta`, `--alpha`,
`--preconditioner` and `--asymmetric` change it), or with `--model
complex_chain` the complex chain t e^{0.7 i} of `--L` sites (1152 by
default; mu=0.1, alpha=0.5, the rest as above): first
`--warmup` sweeps without the profiler (they also pay the kernels' build and
first-use costs), then a second `run_updates` call whose `--sweeps` sweeps run
under torch.profiler. It prints both calls' seconds per sweep, the device time
per sweep of each kernel with its share of the profiled sweeps' wall time,
the same summed by kernel family (the port's kernels, cuFFT, the rest), and
the device's idle share. All shares are read from the trace: the window
is the union of the driver's `sweep` spans (`tracing`; initialization
excluded), laid on the trace's clock, the busy time the union of the
device's activity inside that window. The profiler slows the host, so the
profiled sweeps run slower and idle more than unprofiled ones.

For the complex chain it then times one call of the plain complex M^dag M
in f32 and in f64 at the initial field (CUDA events, the mean of 20 after
one warm-up; eager launches included, as in a sweep) and multiplies by the
calls per sweep that `ops.fermion_det.CPLX_MTM` counted in the unprofiled
sweeps: that operator's share of an unprofiled sweep (the median of the
unprofiled sweeps after the first).

`--compare-preconditioners` then times, at the model's initial field, the
refresh (build) of the spectral and the KPM preconditioner and one f32 solve
(tol 1e-5, from zero, two channels) with each: host clock around
synchronised calls, the mean of three after one warm-up.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _clip(intervals, windows):
    return [(max(s, ws), min(e, we)) for s, e in intervals for ws, we in windows if s < we and e > ws]


# kernel families of the trace, by kernel-name substring; the first match wins
FAMILIES = (("K3 pcg_force", "pcg_force_kernel"), ("K2 pcg", "pcg_kernel"), ("K4 force", "force_kernel"),
            ("K1 mtm", "mtm_kernel"), ("K7 kpm_mf_asym", "kpm_mf_asym_kernel"),
            ("K8 kpm_mf_cplx", "kpm_mf_cplx_kernel"), ("K6 kpm_mf", "kpm_mf_kernel"), ("cuFFT", "fft"))


def family(name: str) -> str:
    for fam, key in FAMILIES:
        if key in name:
            return fam
    return "other"


def initial_fdm(tbm, em, cfg, device):
    """The model's fermion matrix (f64) at its initial field, expanded from cfg.seed."""
    import numpy as np

    from .models.electron_phonon import ElectronPhononParameters
    from .models.tight_binding import TightBindingParameters
    from .updates.context import initialize_qmc, make_fdm

    rng = np.random.default_rng(cfg.seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, em, tbp, rng, device=device)
    ctx, state = initialize_qmc(tbp, elph, symmetric=cfg.symmetric, use_preconditioner=False)
    return make_fdm(ctx, state.x)


def preconditioner_times(tbm, em, cfg, device, reps: int = 3) -> dict:
    """Refresh and one f32 solve with the spectral and the KPM preconditioner
    at the model's initial field (see the module docstring)."""
    import time

    import torch

    from .ops.fermion_det import solve_MtM
    from .ops.preconditioner import build_preconditioner

    fdm = initial_fdm(tbm, em, cfg, device)
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    v0 = torch.randn(2 * fdm.n_sites if fdm.complex_hops else fdm.n_sites, generator=gen, dtype=torch.float64)
    b = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn):
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        return out, (time.perf_counter() - t0) / reps * 1e3

    out = {}
    for kind in ("spectral", "kpm"):
        pre, refresh_ms = timed(lambda: build_preconditioner(kind, fdm, v0))
        (x, st), solve_ms = timed(lambda: solve_MtM(fdm, b, precond=pre, tol=1e-5, maxiter=5000))
        out[kind] = dict(refresh_ms=refresh_ms, solve_ms=solve_ms, iters=int(st.iters),
                         converged=bool(st.converged))
        print(f"{kind}: refresh {refresh_ms:.3f} ms; f32 solve (2 channels, tol 1e-5) {solve_ms:.3f} ms, "
              f"{int(st.iters)} iterations, converged {bool(st.converged)}")
    return out


def complex_mtm_share(tbm, em, cfg, device, calls_per_sweep: dict, sweep_s: float, reps: int = 20) -> dict:
    """ms per call of the plain complex M^dag M in f32 and f64 at the initial
    field, and its share of an unprofiled sweep of sweep_s seconds."""
    import torch

    fdm = initial_fdm(tbm, em, cfg, device)
    v = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    out, total_ms = {}, 0.0
    for dtype in (torch.float32, torch.float64):
        f, vd = fdm.astype(dtype), v.to(device, dtype)
        f.mul_MtM(vd)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f.mul_MtM(vd)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / reps
        total_ms += ms * calls_per_sweep[dtype]
        out[str(dtype)] = dict(ms_per_call=ms, calls_per_sweep=calls_per_sweep[dtype])
    out["share_of_unprofiled_sweep"] = total_ms / (sweep_s * 1e3)
    print(f"plain complex M^dag M: {out}")
    return out


def main(argv=None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import tracing
    from .driver import SimulationConfig, run_updates
    from .models.library import complex_chain_model, holstein_honeycomb_model
    from .ops.fermion_det import CPLX_MTM

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walkers", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--model", default="honeycomb", choices=("honeycomb", "complex_chain"))
    ap.add_argument("--L", type=int, default=None, help="12 (honeycomb) or 1152 (complex chain) by default")
    ap.add_argument("--beta", type=float, default=12.0)
    ap.add_argument("--alpha", type=float, default=None, help="0.6 (honeycomb) or 0.5 (complex chain) by default")
    ap.add_argument("--preconditioner", default="spectral", choices=("spectral", "kpm", "auto"))
    ap.add_argument("--asymmetric", action="store_true", help="the asymmetric factorization (K7 on the KPM path)")
    ap.add_argument("--compare-preconditioners", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12, help="kernels listed")
    args = ap.parse_args(argv)

    cplx = args.model == "complex_chain"
    args.L = args.L or (1152 if cplx else 12)
    args.alpha = args.alpha if args.alpha is not None else (0.5 if cplx else 0.6)
    if cplx:
        _, tbm, em = complex_chain_model(args.L, 1.0, 0.7, 0.1, 1.0, args.alpha)
    else:
        _, tbm, em = holstein_honeycomb_model(args.L, 1.0, args.alpha, 0.0)
    cfg = SimulationConfig(beta=args.beta, dtau=0.05, Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                           force_dtype="float32", preconditioner=args.preconditioner, n_walkers=args.walkers,
                           symmetric=not args.asymmetric)
    for c in CPLX_MTM.values():
        c.reset()
    warm = run_updates(tbm, em, cfg, args.warmup, device=args.device)
    cplx_calls = {dt: c.plain_calls / max(args.warmup, 1) for dt, c in CPLX_MTM.items()}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device.startswith("cuda") else [])
    tracing.clear()
    with profile(activities=activities) as prof:
        md = run_updates(tbm, em, cfg, args.sweeps, device=args.device)
    events = prof.events()
    # the events' times are microseconds from the trace's start; the spans' Unix-epoch nanoseconds
    t0_ns = prof.profiler.kineto_results.trace_start_ns()
    windows = [((s.start_ns - t0_ns) / 1e3, (s.end_ns - t0_ns) / 1e3) for s in tracing.spans() if s.name == "sweep"]
    window_us = _union_us(windows)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = _union_us(_clip([(e.time_range.start, e.time_range.end) for e in device], windows))
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in device:
        for s, t in _clip([(e.time_range.start, e.time_range.end)], windows):
            per_kernel[e.name][0] += t - s
            per_kernel[e.name][1] += 1
    n = max(len(windows), 1)
    print(f"{args.model} W={args.walkers} L={args.L} beta={args.beta} alpha={args.alpha} {args.preconditioner} "
          f"{'asymmetric' if args.asymmetric else 'symmetric'}: "
          f"unprofiled s/sweep {warm['sweep_s']}; "
          f"profiled s/sweep {md['sweep_s']}; iters/solve hmc {md['hmc_iters']:.3f} "
          f"refl {md['reflection_iters']:.3f} swap {md['swap_iters']:.3f}; kpm_active {md.get('kpm_active')}")
    print(f"trace: {len(windows)} sweep ranges, window {window_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1.0 - busy_us / window_us if window_us else float('nan'):.4f}")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:args.top]:
        print(f"  {us / n / 1e3:10.3f} ms/sweep {count / n:9.1f} launches/sweep {us / window_us:7.2%}  {name[:100]}")
    rest = sum(us for _, (us, _) in rows[args.top:])
    print(f"  {rest / n / 1e3:10.3f} ms/sweep (the other {max(len(rows) - args.top, 0)} kernels)")
    families = defaultdict(lambda: [0.0, 0])
    for name, (us, count) in rows:
        families[family(name)][0] += us
        families[family(name)][1] += count
    print("by family:")
    for fam, (us, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / n / 1e3:10.3f} ms/sweep {count / n:9.1f} launches/sweep {us / window_us:7.2%}  {fam}")
    summary = dict(walkers=args.walkers, sweeps=len(windows), window_ms=window_us / 1e3, busy_ms=busy_us / 1e3,
                   idle_share=(1.0 - busy_us / window_us) if window_us else None,
                   unprofiled_sweep_s=warm["sweep_s"], profiled_sweep_s=md["sweep_s"],
                   kernels_ms_per_sweep={k: v[0] / n / 1e3 for k, v in rows[:args.top]},
                   families_ms_per_sweep={k: v[0] / n / 1e3 for k, v in families.items()})
    if cplx and args.device.startswith("cuda"):
        # the first unprofiled sweep also pays the kernels' build and first use
        steady = sorted(warm["sweep_s"][1:] or warm["sweep_s"])
        summary["complex_mtm"] = complex_mtm_share(tbm, em, cfg, torch.device(args.device), cplx_calls,
                                                   float(steady[len(steady) // 2]))
    if args.compare_preconditioners:
        summary["preconditioners"] = preconditioner_times(tbm, em, cfg, torch.device(args.device))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
