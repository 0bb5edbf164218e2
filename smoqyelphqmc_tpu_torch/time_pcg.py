"""Time K2 (the whole-solve spectral PCG) and K3 at the headline shapes on one GPU.

    python smoqyelphqmc_tpu_torch/time_pcg.py [--reps 20] [--sweeps 3]
        [--package-root DIR] [--label NAME] [--tau-rows T ...]

Builds the headline fermion matrix (Holstein honeycomb L=12, beta=12,
dtau=0.05, alpha=0.6: N=288, Ltau=240) and its spectral preconditioner from
a seed, holds each kernel against its plain version, and prints one JSON line
per measurement:

- `k2`: ms per cold solve (x0 = 0) and per warm solve (the correction of a
  1e-3 solution, as the mixed-precision solves call it) at (2, 240, 288),
  tol 1e-5, CUDA events over `--reps` launches; iterations, us per
  iteration, the largest difference from the plain solution, and whether two
  launches on the same input gave the same bits;
- `k2_phases`: where the package has the timed instantiation, the mean us
  per iteration of each phase of one cold solve (CTA 0's clock at each phase
  boundary: its own work, then its wait at each grid sync), over `--reps`
  timed solves;
- `k3`: ms per cold and per warm solve (from a tol-1e-3 solution, the
  trajectory's case) of W=8 jittered walker fields (16 systems) with the
  force planes, iterations per walker, us per iteration, whether two
  launches gave the same bits, the grid, and the tau block and shared
  memory where the package has them;
- `k3_phases`: where the package has K3's timed instantiation, cold and
  warm: the mean us per iteration of each loop phase, and the us of each
  phase before the loop (|b|^2, the warm residual, the first
  preconditioner), of the loop and of the force epilogue;
- `--tau-rows T ...`: K3's cold solve again with its tau blocks forced to
  each T (`k3_tau_rows`: ms, iterations, largest difference from the solve
  with the chosen T);
- `--sweeps n`: seconds per sweep of `run_updates` at the headline, W=1 and
  W=8 (n sweeps each), with CG iterations per solve.

`--package-root DIR` imports smoqyelphqmc_tpu_torch from DIR (an unpacked
earlier commit), so that two versions are timed by one script on one card,
one after the other; run it as a file, not with -m, for that. The first line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    ap.add_argument("--tau-rows", type=int, nargs="*", default=[],
                    help="also time K3 cold with its tau blocks forced to these row counts")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_pcg: no CUDA device; kernel times come only from a GPU")

    from smoqyelphqmc_tpu_torch import _build
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import mtm, pcg, pcg_force
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda, ldiv_lambda_T
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def say(**kw):
        print(json.dumps(dict(label=args.label, card=smi, **kw)), flush=True)

    info = _build.build()
    lib = _build.load_library()
    say(kind="build", seconds=info["seconds"], built=info["built"])
    entry = ""
    for ln in info["log"].splitlines():  # K2 / K3's registers and spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "pcg" in entry and ("registers" in ln or "spill" in ln):
            print(f"ptxas {entry[-40:]}: {ln.strip()}", flush=True)

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

    h = HEADLINE
    dev = torch.device("cuda")
    geo, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
    elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=dev)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)

    def fermion_matrix(x=None):
        return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph, x), structure)

    tol, maxiter = 1e-5, 500
    fdm64 = fermion_matrix()
    pre = build_spectral(fdm64)
    fdm32 = fdm64.astype(torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(12)
    b = torch.randn((2, fdm32.Ltau, fdm32.n_sites), generator=gen, dtype=torch.float64).to(dev, torch.float32)

    def unit(rhs):
        n = torch.sqrt(torch.sum(rhs * rhs, dim=(1, 2), keepdim=True))
        return (rhs / n).contiguous(), n

    bu, nb = unit(b)
    x1, _, _ = pcg.pcg_plain(fdm32, pre, bu, 1e-3, maxiter)
    bw, _ = unit(b - mtm.mtm_plain(fdm32, x1 * nb))
    for start, rhs in (("cold", bu), ("warm", bw)):
        xk, ek, ik = pcg.pcg_cuda(fdm32, pre, rhs, tol, maxiter)
        xk2, ek2, _ = pcg.pcg_cuda(fdm32, pre, rhs, tol, maxiter)
        xp, ep, ip = pcg.pcg_plain(fdm32, pre, rhs, tol, maxiter)
        torch.cuda.synchronize()
        same = bool(torch.equal(xk, xk2)) and bool(torch.equal(ek, ek2))
        ms = cuda_ms(lambda: pcg.pcg_cuda(fdm32, pre, rhs, tol, maxiter), args.reps)
        say(kind="k2", start=start, shape=list(rhs.shape), ms=ms, iters=int(ik), plain_iters=int(ip),
            us_per_iteration=1e3 * ms / max(int(ik), 1), max_abs_diff=float((xk - xp).abs().max()),
            max_x=float(xp.abs().max()), converged=bool((ek < tol).all()), bit_identical=same,
            grid=lib.smoqy_pcg_grid(fdm32.n_sites))
    if hasattr(pcg, "phase_times"):
        stamps = torch.zeros(pcg.stamp_slots(maxiter), dtype=torch.int64, device=dev)
        runs = []
        for _ in range(args.reps):
            _, _, it = pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter, stamps=stamps)
            torch.cuda.synchronize()
            runs.append(pcg.phase_times(stamps, int(it)))
        say(kind="k2_phases", iters=int(it), us={k: sum(r[k] for r in runs) / len(runs) for k in runs[0]})

    # K3: W jittered walker fields, one shared preconditioner (chip_smoke.py phase 8)
    W = 8
    gen = torch.Generator(device="cpu").manual_seed(13)
    xs = elph.x[None] + 0.1 * torch.randn((W,) + tuple(elph.x.shape), generator=gen, dtype=torch.float64).to(dev)
    fdmw = fermion_matrix(xs)
    prew = build_spectral(dataclasses.replace(fdmw, exp_nV=fdmw.exp_nV.mean(dim=0)))
    fdmw32 = dataclasses.replace(fdmw, exp_nV=fdmw.exp_nV[:, None]).astype(torch.float32)
    Lam = build_lambda(elph, xs, tbp.n_sites).to(torch.float32)
    Phi = torch.randn((W, 2, fdmw.Ltau, fdmw.n_sites), generator=gen, dtype=torch.float32).to(dev)
    bk3 = ldiv_lambda_T(Lam[:, None], Phi).contiguous()
    zeros = torch.zeros_like(bk3)
    # the warm start of a trajectory solve: a tol-1e-3 solution (chip_smoke.py phase 8)
    x_warm, *_ = pcg_force.pcg_force_plain(fdmw32, prew, bk3, zeros, Lam, 1e-3, maxiter, True)
    for start, x0 in (("cold", zeros), ("warm", x_warm)):
        xk, _, _, sk = pcg_force.solve_force(fdmw32, prew, bk3, Lam, x0=x0, tol=tol, maxiter=maxiter)
        xk2, _, _, sk2 = pcg_force.solve_force(fdmw32, prew, bk3, Lam, x0=x0, tol=tol, maxiter=maxiter)
        xp, _, _, ep, ip = pcg_force.pcg_force_plain(fdmw32, prew, bk3, x0, Lam, tol, maxiter, True)
        torch.cuda.synchronize()
        if start == "cold":
            xk_cold = xk
        same = bool(torch.equal(xk, xk2)) and bool(torch.equal(sk.eps, sk2.eps))
        ms = cuda_ms(lambda: pcg_force.solve_force(fdmw32, prew, bk3, Lam, x0=x0, tol=tol, maxiter=maxiter),
                     max(args.reps // 4, 3))
        iters = sk.iters.tolist()
        if hasattr(pcg_force, "launch_shape"):
            launch = pcg_force.launch_shape(fdmw32, 2 * W)
        else:
            launch = dict(grid=lib.smoqy_pcg_force_grid(fdmw.n_sites))
        say(kind="k3", start=start, walkers=W, shape=list(bk3.shape), ms=ms, iters=iters, plain_iters=ip.tolist(),
            us_per_iteration=1e3 * ms / max(max(iters), 1), max_abs_diff=float((xk - xp).abs().max()),
            max_x=float(xp.abs().max()), converged=bool(sk.converged.all()), bit_identical=same, **launch)
        if hasattr(pcg_force, "phase_times"):
            stamps = torch.zeros(pcg_force.stamp_slots(maxiter), dtype=torch.int64, device=dev)
            runs = []
            for _ in range(args.reps):
                *_, it = pcg_force.pcg_force_cuda(fdmw32, prew, bk3, x0, Lam, tol, maxiter, True, stamps=stamps)
                torch.cuda.synchronize()
                runs.append(pcg_force.phase_times(stamps, int(it.max())))
            loop = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0] if k != "once"}
            once = {k: sum(r["once"][k] for r in runs) / len(runs) for k in runs[0]["once"]}
            say(kind="k3_phases", start=start, iters=int(it.max()), us=loop, once_us=once)

    for T in args.tau_rows:
        xt, *_, it = pcg_force.pcg_force_cuda(fdmw32, prew, bk3, zeros, Lam, tol, maxiter, True, tau_rows=T)
        ms = cuda_ms(lambda: pcg_force.pcg_force_cuda(fdmw32, prew, bk3, zeros, Lam, tol, maxiter, True, tau_rows=T),
                     max(args.reps // 4, 3))
        say(kind="k3_tau_rows", tau_block=T, ms=ms, iters=it.tolist(), max_abs_diff=float((xt - xk_cold).abs().max()))

    for n_walkers in ((1, 8) if args.sweeps > 0 else ()):
        cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                               force_dtype="float32", preconditioner="spectral", n_walkers=n_walkers)
        md = run_updates(tbm, em, cfg, args.sweeps, device="cuda")
        conv = md["all_converged"] if n_walkers == 1 else all(md["walker_converged"])
        say(kind="sweeps", walkers=n_walkers, sweep_s=[float(t) for t in md["sweep_s"]],
            hmc_iters=md["hmc_iters"], reflection_iters=md["reflection_iters"], swap_iters=md["swap_iters"],
            hmc_acceptance=md["hmc_acceptance_rate"], all_converged=conv)


if __name__ == "__main__":
    main()
