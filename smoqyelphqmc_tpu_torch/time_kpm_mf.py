"""Time K6 / K7 (the matrix-free KPM apply) at the large-N path's shape, or K8 on the complex chain, on one GPU.

    python smoqyelphqmc_tpu_torch/time_kpm_mf.py [--L 48] [--grid] [--sweeps 2]
        [--reps 50] [--complex] [--package-root DIR] [--label NAME]

Builds the Holstein honeycomb model (L=48: N=4608, alpha=1.5, beta=12,
Ltau=240), its KPM preconditioner with live Lanczos bounds and two complex
vectors u (2, 240, N) from a seed, holds each kernel against its plain
version, and prints one JSON line per measurement:

- `apply`: ms per apply (CUDA events, 50 launches), the relative error
  against the plain version, live orders, us per order step of the longest
  frequency and, where the package has the cluster form, its launch plan;
- `longest_alone`: the same with every frequency but the longest cut to one
  order, the critical path alone;
- `--grid`: the same over order thresholds and cluster sizes, to choose
  ops/kpm_mf.py's constants (a threshold of 10^6 is the one-CTA form alone);
- `--sweeps n`: seconds per sweep of `run_updates` on that model with
  preconditioner='auto' in both factorizations (n symmetric sweeps, one
  asymmetric more than n // 2), with CG iterations per solve.

`--complex` times K8 instead, on the complex chain of chip_smoke.py:COMPLEX
(t e^{0.7 i}, N=1152, beta=12, Ltau=240, its KPM preconditioner with live
Lanczos bounds), both factorizations, one and two vectors: `apply` as above
with the stages of an order step (the package's design: 2 n_colors - 1 and
n_colors with stage tables, 2 n_colors + 2 and n_colors + 2 barrier-separated
passes before them) and us per stage; `longest_alone`; `--grid` the cluster
sizes 1, 2, 4, 8 and the one-CTA form alone where the package has them;
`--sweeps n`: s/sweep of the complex path with preconditioner='kpm' (n
symmetric sweeps, one asymmetric more than n // 2).

`--package-root DIR` imports smoqyelphqmc_tpu_torch from DIR (an unpacked
earlier commit), so that two versions are timed by one script on one card,
one after the other; run it as a file, not with -m, for that. The first line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=48)
    ap.add_argument("--vectors", type=int, default=2)
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--complex", action="store_true", help="time K8 on the complex chain instead of K6 / K7")
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_kpm_mf: no CUDA device; kernel times come only from a GPU")

    from smoqyelphqmc_tpu_torch import _build
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import kpm_mf
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def say(**kw):
        print(json.dumps(dict(label=args.label, card=smi, **kw)), flush=True)

    info = _build.build()
    _build.load_library()
    say(kind="build", seconds=info["seconds"], built=info["built"])
    entry = ""
    for ln in info["log"].splitlines():  # K6 / K7's registers and spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "MfArgs" in entry and ("registers" in ln or "spill" in ln):
            print(f"ptxas {entry[-45:]}: {ln.strip()}", flush=True)

    beta, dtau = 12.0, 0.05
    geo, tbm, em = holstein_honeycomb_model(args.L, 1.0, 1.5, 0.0)

    def cuda_ms(fn, reps=args.reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    if args.complex:
        time_complex(args, say, cuda_ms)
        return

    for symmetric in (False, True):
        rng = np.random.default_rng(0)
        tbp = TightBindingParameters.from_model(tbm, rng, device="cuda")
        elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, device="cuda")
        structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
        fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)
        v0 = torch.randn(fdm.n_sites, generator=torch.Generator(device="cpu").manual_seed(16), dtype=torch.float64)
        pre = KPMPreconditioner.build(fdm, v0, matrix_free=True)
        ops = pre.mf_operands()
        gen = torch.Generator(device="cpu").manual_seed(17)
        ure, uim = torch.randn((2, args.vectors, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to("cuda")
        plain = kpm_mf.kpm_mf_plain if symmetric else kpm_mf.kpm_mf_asym_plain
        ref = plain(ops, ure, uim)
        scale = max(float(r.abs().max()) for r in ref)
        orders = pre.orders.astype(int)
        name = "K6" if symmetric else "K7"
        passes = 1 if symmetric else 2

        def measure(**kw):
            got = kpm_mf.kpm_mf_cuda(ops, ure, uim, **kw)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale
            ms = cuda_ms(lambda: kpm_mf.kpm_mf_cuda(ops, ure, uim, **kw))
            plan = kpm_mf.cluster_plan(ops, args.vectors, **kw) if hasattr(kpm_mf, "cluster_plan") else {}
            say(kind="apply", kernel=name, N=fdm.n_sites, Ltau=fdm.Ltau, vectors=args.vectors, ms=ms, rel_err=err,
                orders_max=int(orders.max()), orders_sum=int(orders.sum()),
                us_per_order_step=1e3 * ms / max(passes * (int(orders.max()) - 1), 1), plan=plan)

        measure()
        # the longest recurrence alone (every other frequency cut to one
        # order): the kernel's critical path without its neighbours
        longest = np.where(np.arange(len(orders)) == int(orders.argmax()), orders, 1).astype(np.int32)
        alone = dataclasses.replace(ops, orders=torch.as_tensor(longest, device="cuda"), orders_host=longest)
        if hasattr(alone, "launch_plans"):
            alone.launch_plans = {}
        ms = cuda_ms(lambda: kpm_mf.kpm_mf_cuda(alone, ure, uim))
        say(kind="longest_alone", kernel=name, ms=ms, orders_max=int(orders.max()),
            us_per_order_step=1e3 * ms / max(passes * (int(orders.max()) - 1), 1))
        if args.grid and hasattr(kpm_mf, "cluster_plan"):
            for k in (4, 8, 16):
                for thr in (0, 4, 16):
                    measure(order_threshold=thr, cluster_size=k)
            measure(order_threshold=10**6)
        say(kind="plain", kernel=name, ms=cuda_ms(lambda: plain(ops, ure, uim), 2))

    for symmetric, n in ((True, args.sweeps), (False, (args.sweeps + 1) // 2 + 1 if args.sweeps else 0)):
        if n <= 0:
            continue
        cfg = SimulationConfig(beta=beta, dtau=dtau, Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                               force_dtype="float32", preconditioner="auto", symmetric=symmetric)
        md = run_updates(tbm, em, cfg, n, device="cuda")
        say(kind="sweeps", symmetric=symmetric, n_sites=md["n_sites"], sweep_s=[float(t) for t in md["sweep_s"]],
            hmc_iters=md["hmc_iters"], reflection_iters=md["reflection_iters"], swap_iters=md["swap_iters"],
            kpm_active=md.get("kpm_active"), all_converged=md["all_converged"], delta_H=[float(d) for d in md["hmc_delta_H"]])


# the complex chain of chip_smoke.py:COMPLEX
COMPLEX = dict(L=1152, beta=12.0, dtau=0.05, phase=0.7, alpha=0.5, Omega=1.0, mu=0.1)


def time_complex(args, say, cuda_ms) -> None:
    """K8 on the complex chain: apply and longest-alone times in both
    factorizations at one and two vectors, the grid of forms, the sweeps."""
    import inspect

    import numpy as np
    import torch

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import kpm_mf
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner

    h = COMPLEX
    geo, tbm, em = complex_chain_model(h["L"], 1.0, h["phase"], h["mu"], h["Omega"], h["alpha"])
    staged = hasattr(kpm_mf, "build_stage_tables_pair")  # the stage-table design
    takes_launch = "order_threshold" in inspect.signature(kpm_mf.kpm_mf_cplx_cuda).parameters
    for symmetric in (True, False):
        rng = np.random.default_rng(0)
        tbp = TightBindingParameters.from_model(tbm, rng, device="cuda")
        elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device="cuda")
        structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
        fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)
        v0 = torch.randn(2 * fdm.n_sites, generator=torch.Generator(device="cpu").manual_seed(18),
                         dtype=torch.float64)
        pre = KPMPreconditioner.build(fdm, v0)
        ops = pre.mf_operands()
        nc = fdm.cb.n_colors
        orders = pre.orders.astype(int)
        passes = 1 if symmetric else 2
        steps = passes * (int(orders.max()) - 1)
        if staged:
            stages = 2 * nc - 1 if symmetric else nc
        else:  # the colors twice (once), the diagonal and the recurrence step, each a pass
            stages = 2 * nc + 2 if symmetric else nc + 2
        kind = "symmetric" if symmetric else "asymmetric"
        gen = torch.Generator(device="cpu").manual_seed(19)
        for n_vec in (1, 2):
            ure, uim = torch.randn((2, n_vec, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to("cuda")
            ref = kpm_mf.kpm_mf_cplx_plain(ops, ure, uim)
            scale = max(float(r.abs().max()) for r in ref)

            def measure(what, o=ops, **kw):
                got = kpm_mf.kpm_mf_cplx_cuda(o, ure, uim, **kw)
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale if o is ops else None
                ms = cuda_ms(lambda: kpm_mf.kpm_mf_cplx_cuda(o, ure, uim, **kw))
                plan = kpm_mf.cluster_plan(o, n_vec, **kw) if takes_launch else {}
                us_step = 1e3 * ms / max(steps, 1)
                say(kind=what, kernel="K8", factorization=kind, N=fdm.n_sites, Ltau=fdm.Ltau, vectors=n_vec, ms=ms,
                    rel_err=err, orders_max=int(orders.max()), orders_sum=int(orders.sum()), stages=stages,
                    us_per_order_step=us_step, us_per_stage=us_step / stages, plan=plan, launch=kw)

            measure("apply")
            # the longest recurrence alone (every other frequency cut to one
            # order): the kernel's critical path without its neighbours
            longest = np.where(np.arange(len(orders)) == int(orders.argmax()), orders, 1).astype(np.int32)
            alone = dataclasses.replace(ops, orders=torch.as_tensor(longest, device="cuda"), orders_host=longest)
            if hasattr(alone, "launch_plans"):
                alone.launch_plans = {}
            measure("longest_alone", alone)
            if args.grid and takes_launch:
                for k in (1, 2, 4, 8):
                    measure("apply", order_threshold=0, cluster_size=k)
                measure("apply", order_threshold=10**6)
            if n_vec == 1:
                say(kind="plain", kernel="K8", factorization=kind, vectors=n_vec,
                    ms=cuda_ms(lambda: kpm_mf.kpm_mf_cplx_plain(ops, ure, uim), 2))

    for symmetric, n in ((True, args.sweeps), (False, (args.sweeps + 1) // 2 + 1 if args.sweeps else 0)):
        if n <= 0:
            continue
        cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                               force_dtype="float32", preconditioner="kpm", symmetric=symmetric)
        launches = kpm_mf.KPM_MF_CPLX.launches
        md = run_updates(tbm, em, cfg, n, device="cuda")
        say(kind="sweeps", model="complex_chain", symmetric=symmetric, n_sites=md["n_sites"],
            sweep_s=[float(t) for t in md["sweep_s"]], hmc_iters=md["hmc_iters"],
            reflection_iters=md["reflection_iters"], swap_iters=md["swap_iters"],
            acceptance=dict(reflection=md["reflection_acceptance_rate"], swap=md["swap_acceptance_rate"],
                            hmc=md["hmc_acceptance_rate"]),
            k8_launches=kpm_mf.KPM_MF_CPLX.launches - launches, kpm_active=md.get("kpm_active"),
            all_converged=md["all_converged"], delta_H=[float(d) for d in md["hmc_delta_H"]])


if __name__ == "__main__":
    main()
