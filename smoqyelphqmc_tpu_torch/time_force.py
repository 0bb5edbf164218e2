"""Time K4 (the Holstein force planes, ops/force.py) on one GPU.

    python smoqyelphqmc_tpu_torch/time_force.py [--reps 200] [--walkers 1 8]
        [--package-root DIR] [--label NAME] [--tau-rows T ...] [--sweeps n]
        [--ssh]

Builds the headline model (Holstein honeycomb L=12, beta=12, dtau=0.05,
alpha=0.6: N=288, Ltau=240; the W=1 trajectory's shape) from a seed in
float32, at W walkers: W=1 at the initial field (the W=1 trajectory's
operands, psi_raw (2, 240, 288)), W>1 at fields jittered from it (seed 13;
psi_raw (W, 2, 240, 288), exp_nV and Lambda one plane per walker). For each W
and want_p2 on and off it prints one JSON line (`k4`): ms per launch, the
device's time (`ms`: CUDA events around replays of a CUDA graph of `--reps`
launches) and the eager caller's (`eager_ms`), the bound (the larger of the
bytes K4 must move over 3.35 TB/s and its operations over the f32 peak, as
chip_smoke.py:phase_k4 counts them), the largest difference from the plain
version (`force_planes_plain`; tolerance rtol 1e-4, atol 1e-5 max|P|),
whether two launches gave the same bits, and where the package has them the
launch's form (`launch`) and the timed instantiation's per-phase breakdown
(`k4_phases`: us of each phase group and phase on CTA 0 and on the last CTA
to finish, the mean of 10 timed launches). A package without a timed
instantiation gives its split only as want_p2 on against off (the P2 part).
`--tau-rows T ...` times the launch again with its tau blocks forced to each
T (`k4_tau_rows`), where the package takes it. `--sweeps n` runs n sweeps
of the W=1 path (`run_updates` with the headline's SimulationConfig of
chip_smoke.py, its trajectory forces through K2 + K4) and prints s/sweep, CG
iterations per solve, acceptance, Delta H and K4's launches (`sweeps`).

`--ssh` times the SSH trajectory force after its solve at the optical-SSH
cell's shape (honeycomb L=12, beta=4, dtau=0.05, alpha=0.5: psi_raw (2, 80,
288), hop tables on every tau row; the field jittered from the initial one,
seed 15), one walker: the launch of K4's SSH form alone (`ms`, a CUDA graph
of launches, and the Holstein form's on the same operands in the memory
form), and route 'k4' after the solve (K4's tables, the launch, the
contraction of `derivatives.ssh_force_from_hops`) against route 'plain'
after it (mul_M, the two color walks of `add_M_derivative_force`, mul_Mt and
the Lambda term): wall ms a call with the device synchronised after
`--reps` calls, the device kernels a call (torch.profiler), and the largest
difference of the two forces over the largest force (`ssh_k4`).

`--package-root DIR` imports smoqyelphqmc_tpu_torch from DIR (an unpacked
earlier commit), so that two versions are timed by one script on one card,
one after the other; run it as a file, not with -m, for that. The first line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0)
HBM_BYTES_S = 3.35e12
PEAK_F32 = 67e12


def force_bound(W, Ltau, N, n_colors):
    """(ms, by): psi_raw (2 planes), Lambda and expV in, P1 and P2 out, the
    tables once; per channel and site one B, B^T, CB^T and CB^{-1} and ~10
    products and sums (chip_smoke.py:epilogue_ops)."""
    nbytes = 6 * W * Ltau * N * 4 + n_colors * N * 12
    ops = W * 2 * Ltau * N * (2 * (2 * 3 * n_colors + 1) + 6 * n_colors + 10)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--walkers", type=int, nargs="*", default=[1, 8])
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    ap.add_argument("--tau-rows", type=int, nargs="*", default=[],
                    help="also time each launch with its tau blocks forced to these row counts")
    ap.add_argument("--sweeps", type=int, default=0, help="also run this many W=1 sweeps")
    ap.add_argument("--ssh", action="store_true", help="also time the SSH force route after its solve")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_force: no CUDA device; kernel times come only from a GPU")

    from smoqyelphqmc_tpu_torch import _build
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import force
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def say(**kw):
        print(json.dumps(dict(label=args.label, card=smi, **kw)), flush=True)

    info = _build.build()
    _build.load_library()
    say(kind="build", seconds=info["seconds"], built=info["built"])
    entry = ""
    log = info["log"] or Path(info["path"]).with_suffix(".log").read_text()
    for ln in log.splitlines():  # K4's registers and spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "force_kernel" in entry and ("registers" in ln or "spill" in ln):
            print(f"ptxas {entry[-48:]}: {ln.strip()}", flush=True)

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps, replays=3):
        """Device ms per launch: `reps` launches captured in one CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * replays)

    dev = torch.device("cuda")
    h = HEADLINE
    geo, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
    elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=dev)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    timed = hasattr(force, "phase_times")
    takes_rows = "tau_rows" in inspect.signature(force.force_planes_cuda).parameters
    for W in args.walkers:
        gen = torch.Generator(device="cpu").manual_seed(13)
        if W == 1:
            xs = elph.x
        else:
            xs = elph.x[None] + 0.1 * torch.randn((W,) + tuple(elph.x.shape), generator=gen,
                                                  dtype=torch.float64).to(dev)
        fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph, xs), structure, symmetric=True)
        if W > 1:
            fdm = dataclasses.replace(fdm, exp_nV=fdm.exp_nV[:, None])
        fdm32 = fdm.astype(torch.float32)
        Lam = build_lambda(elph, xs, tbp.n_sites).to(torch.float32)
        lead = (W,) if W > 1 else ()
        psi = torch.randn(lead + (2, fdm32.Ltau, fdm32.n_sites), generator=torch.Generator().manual_seed(14),
                          dtype=torch.float32).to(dev)
        bound_ms, bound_by = force_bound(W, fdm32.Ltau, fdm32.n_sites, fdm32.cb.n_colors)
        for want_p2 in (True, False):
            got = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
            again = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
            ref = force.force_planes_plain(fdm32, Lam, psi, want_p2)
            torch.cuda.synchronize()
            err, ok = 0.0, True
            for g, r in zip(got, ref):
                d = (g - r).abs()
                err = max(err, float(d.max()))
                ok = ok and bool((d <= 1e-5 * float(r.abs().max()) + 1e-4 * r.abs()).all())
            run = lambda: force.force_planes_cuda(fdm32, Lam, psi, want_p2)  # noqa: E731
            row = dict(kind="k4", walkers=W, want_p2=want_p2, psi=list(psi.shape), n_colors=fdm32.cb.n_colors,
                       ms=graph_ms(run, args.reps), eager_ms=cuda_ms(run, args.reps), bound_ms=bound_ms,
                       bound_by=bound_by, max_abs_err=err, max_P=max(float(r.abs().max()) for r in ref), ok=ok,
                       bit_identical=all(bool(torch.equal(a, b)) for a, b in zip(got, again)))
            if hasattr(force, "launch_shape"):
                row["launch"] = force.launch_shape(fdm32, W)
            if timed:
                stamps = torch.zeros(force.stamp_slots(), dtype=torch.int64, device=dev)
                runs = []
                for _ in range(10):
                    stamps.zero_()
                    tout = force.force_planes_cuda(fdm32, Lam, psi, want_p2, stamps=stamps)
                    torch.cuda.synchronize()
                    runs.append(force.phase_times(stamps, force.phase_names(fdm32.cb.n_colors, want_p2)))
                row["timed_bit_identical"] = all(bool(torch.equal(a, b)) for a, b in zip(got, tout))
                row["timed_ms"] = sum(r["kernel"] for r in runs) / len(runs) / 1e3
            say(**row)
            if timed:
                mean = {"kernel_us": row["timed_ms"] * 1e3,
                        "last_start_us": sum(r["last_start"] for r in runs) / len(runs)}
                for who in ("cta0", "last"):
                    mean[who] = {
                        "us": sum(r[who]["us"] for r in runs) / len(runs),
                        "groups": {k: sum(r[who]["groups"][k] for r in runs) / len(runs)
                                   for k in runs[0][who]["groups"]},
                        "phases": {k: round(sum(r[who]["phases"][k] for r in runs) / len(runs), 3)
                                   for k in runs[0][who]["phases"]},
                    }
                say(kind="k4_phases", walkers=W, want_p2=want_p2, **mean)
            for T in args.tau_rows if takes_rows else []:
                xt = force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T)
                torch.cuda.synchronize()
                say(kind="k4_tau_rows", walkers=W, want_p2=want_p2, tau_block=T,
                    ms=graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, want_p2, tau_rows=T), args.reps),
                    max_abs_err=max(float((a - b).abs().max()) for a, b in zip(xt, ref)),
                    launch=force.launch_shape(fdm32, W, tau_rows=T))

    if args.ssh:
        time_ssh(say, graph_ms, args.reps)

    if args.sweeps:
        from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

        cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                               force_dtype="float32")
        launches = force.FORCE.launches
        md = run_updates(tbm, em, cfg, args.sweeps, device="cuda")
        say(kind="sweeps", path="w1", sweep_s=[float(t) for t in md["sweep_s"]], hmc_iters=md["hmc_iters"],
            reflection_iters=md["reflection_iters"], swap_iters=md["swap_iters"],
            acceptance=dict(reflection=md["reflection_acceptance_rate"], swap=md["swap_acceptance_rate"],
                            hmc=md["hmc_acceptance_rate"]),
            k4_launches=force.FORCE.launches - launches, all_converged=md["all_converged"],
            delta_H=[float(d) for d in md["hmc_delta_H"]])


def kernels_of(fn) -> int:
    """Device kernels one call of fn launches (torch.profiler's trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() != DeviceType.CPU and not ev.name().startswith(("Memcpy", "Memset")))


def time_ssh(say, graph_ms, reps: int) -> None:
    """The `--ssh` lines (module docstring)."""
    import time

    import numpy as np
    import torch

    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.library import ossh_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import force
    from smoqyelphqmc_tpu_torch.ops.derivatives import (add_M_derivative_force, holstein_force_from_planes,
                                                         ssh_force_from_hops)
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import (add_lambda_derivative_force, build_lambda, ldiv_lambda,
                                                         mul_lambda)
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm

    dev = torch.device("cuda")
    geo, tbm, em = ossh_honeycomb_model(12, 1.0, 0.5, 0.0)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
    elph = ElectronPhononParameters.from_model(4.0, 0.05, em, tbp, rng, device=dev)
    ctx, state = initialize_qmc(tbp, elph, force_dtype="float32", use_preconditioner=False)
    gen = torch.Generator().manual_seed(15)
    x = state.x + 0.3 * torch.randn(state.x.shape, generator=gen, dtype=torch.float64).to(dev)
    e32, x32 = ctx.elph.to_dtype(torch.float32), x.to(torch.float32)
    Lam = build_lambda(e32, x32, ctx.n_sites)
    psi_raw = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=torch.float32).to(dev)
    want_p2 = bool(np.any(e32.hol_ph_sym))
    fdm32 = make_fdm(ctx, x, dtype="float32")

    def k4_route():  # a kick's fermion matrix is new: its K4 tables are made again
        fdm32.__dict__.pop("_force_pairs", None)
        P1, P2, H = force.force_planes(fdm32, Lam, psi_raw, want_p2, hops=True)
        return ssh_force_from_hops(holstein_force_from_planes(P1, P2, e32, x32, Lam, ctx.plan), H, e32, x32, ctx.plan)

    def plain_route():
        psi = ldiv_lambda(Lam, psi_raw)
        lam_psi = mul_lambda(Lam, psi)
        A = fdm32.mul_M(lam_psi)
        f = torch.zeros((e32.n_phonon, e32.Ltau), dtype=torch.float32, device=dev)
        f = add_M_derivative_force(f, -2.0, A, lam_psi, fdm32, e32, x32, ctx.plan)
        return add_lambda_derivative_force(f, -2.0, fdm32.mul_Mt(A), psi, Lam, e32, x32)

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    f_k4, f_plain = k4_route(), plain_route()
    torch.cuda.synchronize()
    rel = float((f_k4 - f_plain).abs().max()) / float(f_plain.abs().max())
    launch = lambda: force.force_planes_cuda(fdm32, Lam, psi_raw, want_p2, hops=True)  # noqa: E731
    row = dict(kind="ssh_k4", psi=list(psi_raw.shape), n_colors=fdm32.cb.n_colors, want_p2=want_p2,
               launch=force.launch_shape(fdm32, 1, hops=True), ssh_form_ms=graph_ms(launch, reps),
               holstein_form_ms=graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi_raw, want_p2), reps),
               k4_route_ms=wall_ms(k4_route), plain_route_ms=wall_ms(plain_route),
               k4_route_kernels=kernels_of(k4_route), plain_route_kernels=kernels_of(plain_route),
               force_max_rel_diff=rel)
    say(**row)


if __name__ == "__main__":
    main()
