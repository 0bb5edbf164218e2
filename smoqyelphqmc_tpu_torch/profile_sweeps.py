"""Device-time profile of the update sweeps.

    python -m smoqyelphqmc_tpu_torch.profile_sweeps [--walkers 8] [--sweeps 3] [--warmup 2]

Runs the headline model (Holstein honeycomb L=12, beta=12, dtau=0.05,
alpha=0.6, Omega=1, mu=0, Nt=24, tol 1e-10, mixed precision, f32 forces,
spectral preconditioner, seed 1; `--L` and `--beta` shrink it): first
`--warmup` sweeps without the profiler (they also pay the kernels' build and
first-use costs), then a second `run_updates` call whose `--sweeps` sweeps run
under torch.profiler. It prints both calls' seconds per sweep, the device time
per sweep of each kernel with its share of the profiled sweeps' wall time,
and the device's idle share. All shares are read from the trace: the window
is the union of the driver's "sweep" ranges (initialization excluded), the
busy time the union of the device's activity inside that window. The
profiler slows the host, so the profiled sweeps run slower and idle more
than unprofiled ones.
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


def main(argv=None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .driver import SimulationConfig, run_updates
    from .models.library import holstein_honeycomb_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walkers", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--L", type=int, default=12)
    ap.add_argument("--beta", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12, help="kernels listed")
    args = ap.parse_args(argv)

    _, tbm, em = holstein_honeycomb_model(args.L, 1.0, 0.6, 0.0)
    cfg = SimulationConfig(beta=args.beta, dtau=0.05, Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                           force_dtype="float32", preconditioner="spectral", n_walkers=args.walkers)
    warm = run_updates(tbm, em, cfg, args.warmup, device=args.device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device.startswith("cuda") else [])
    with profile(activities=activities) as prof:
        md = run_updates(tbm, em, cfg, args.sweeps, device=args.device)
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "sweep" and e.device_type == DeviceType.CPU]
    window_us = _union_us(windows)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "sweep"]
    busy_us = _union_us(_clip([(e.time_range.start, e.time_range.end) for e in device], windows))
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in device:
        for s, t in _clip([(e.time_range.start, e.time_range.end)], windows):
            per_kernel[e.name][0] += t - s
            per_kernel[e.name][1] += 1
    n = max(len(windows), 1)
    print(f"W={args.walkers} L={args.L} beta={args.beta}: unprofiled s/sweep {warm['sweep_s']}; "
          f"profiled s/sweep {md['sweep_s']}; iters/solve hmc {md['hmc_iters']:.3f} "
          f"refl {md['reflection_iters']:.3f} swap {md['swap_iters']:.3f}")
    print(f"trace: {len(windows)} sweep ranges, window {window_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1.0 - busy_us / window_us if window_us else float('nan'):.4f}")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:args.top]:
        print(f"  {us / n / 1e3:10.3f} ms/sweep {count / n:9.1f} launches/sweep {us / window_us:7.2%}  {name[:100]}")
    rest = sum(us for _, (us, _) in rows[args.top:])
    print(f"  {rest / n / 1e3:10.3f} ms/sweep (the other {max(len(rows) - args.top, 0)} kernels)")
    summary = dict(walkers=args.walkers, sweeps=len(windows), window_ms=window_us / 1e3, busy_ms=busy_us / 1e3,
                   idle_share=(1.0 - busy_us / window_us) if window_us else None,
                   unprofiled_sweep_s=warm["sweep_s"], profiled_sweep_s=md["sweep_s"],
                   kernels_ms_per_sweep={k: v[0] / n / 1e3 for k, v in rows[:args.top]})
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
