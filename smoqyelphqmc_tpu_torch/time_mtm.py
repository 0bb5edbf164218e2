"""Time K1 (the M^T M matvec; K5 is K1 on a permuted lattice) on one GPU.

    python smoqyelphqmc_tpu_torch/time_mtm.py [--reps 200] [--package-root DIR]
        [--label NAME] [--tau-rows T ...] [--shapes headline large permuted]

Builds the fermion matrices of three shapes from a seed, at the model's
initial field (the expansion seed 0), in both factorizations:

- `headline`: Holstein honeycomb L=12, beta=12, dtau=0.05, alpha=0.6
  (N=288, Ltau=240), v (2, 240, 288);
- `large`: the large-N path's model, L=48, alpha=1.5 (N=4608), v (2, 240,
  4608) (chip_smoke.py:large_model_kpm's tables);
- `permuted`: the headline honeycomb with its site labels permuted (seed 15;
  more than 8 lane-shift classes a color, K5's function).

For each shape, factorization and dtype (f32, f64) it prints one JSON line
(`k1`): ms per launch, the device's time (`ms`: CUDA events around replays
of a CUDA graph of `--reps` launches, so that the host's launch cost, which
exceeds the kernel at the headline, is left out) and the eager caller's
(`eager_ms`: CUDA events over `--reps` launches from Python after a warm-up),
the bound (the larger of the bytes K1 must move over 3.35 TB/s and its
operations over the type's peak, as chip_smoke.py:mtm_bound counts them),
the largest difference from the plain version relative to its largest value
(tolerance 2e-6 in f32, 1e-12 in f64), whether two launches gave the same
bits, and where the package has the timed instantiation, whether it gave
the same bits too and its per-phase breakdown (`k1_phases`: us of each phase
group and of each phase on CTA 0 and on the last CTA to finish, the mean
over 10 timed launches) and the launch's form (`launch_shape`, where the
package has it). `--tau-rows T ...` times the launch again with its tau
blocks forced to each T (`k1_tau_rows`), `--memory-form` in the form that
reads the pair tables from device memory in every stage (`k1_memory_form`).

`--package-root DIR` imports smoqyelphqmc_tpu_torch from DIR (an unpacked
earlier commit), so that two versions are timed by one script on one card,
one after the other; run it as a file, not with -m, for that. The first line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {
    "headline": dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0),
    "large": dict(L=48, beta=12.0, dtau=0.05, alpha=1.5, Omega=1.0, mu=0.0),
    "permuted": dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0, perm_seed=15),
}
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def mtm_bound(fdm, n_sys, es):
    """(ms, by): v in and out once, expV and the hopping data read once (each
    hop's cosh and sinh, one row or Ltau rows, and its two int32 sites); two
    symmetric B applications and four multiply-adds a site of each row."""
    Ltau, N, n_colors = fdm.Ltau, fdm.n_sites, fdm.cb.n_colors
    ops = n_sys * Ltau * N * (2 * (2 * 3 * n_colors + 1) + 4)
    rows = 1 if fdm.static_hops else Ltau
    nbytes = es * (2 * n_sys * Ltau * N + Ltau * N) + fdm.structure.n_hops * (2 * es * rows + 2 * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[es]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--tau-rows", type=int, nargs="*", default=[],
                    help="also time each launch with its tau blocks forced to these row counts")
    ap.add_argument("--memory-form", action="store_true",
                    help="also time each launch in the memory form (tables read from device memory a stage)")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_mtm: no CUDA device; kernel times come only from a GPU")

    from smoqyelphqmc_tpu_torch import _build
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import mtm
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix

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
    for ln in log.splitlines():  # K1's registers and spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "mtm" in entry and ("registers" in ln or "spill" in ln):
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
    timed = hasattr(mtm, "phase_times")
    for shape in args.shapes:
        h = SHAPES[shape]
        geo, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
        rng = np.random.default_rng(0)
        tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
        elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=dev)
        nt = tbp.neighbor_table
        if "perm_seed" in h:
            perm = np.random.default_rng(h["perm_seed"]).permutation(tbp.n_sites)
            nt = perm[np.asarray(nt)].astype(np.int32)
        structure = build_checkerboard_structure(nt, tbp.n_sites)
        fpi = build_path_integral(tbp, elph)
        for symmetric in (True, False):
            fdm64 = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=symmetric)
            for dtype, tol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
                fdm = fdm64.astype(dtype)
                gen = torch.Generator(device="cpu").manual_seed(11)
                v = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float64).to(dev, dtype)
                got = mtm.mtm_cuda(fdm, v)
                again = mtm.mtm_cuda(fdm, v)
                ref = mtm.mtm_plain(fdm, v)
                torch.cuda.synchronize()
                rel = float((got - ref).abs().max() / ref.abs().max())
                eager_ms = cuda_ms(lambda: mtm.mtm_cuda(fdm, v), args.reps)
                ms = graph_ms(lambda: mtm.mtm_cuda(fdm, v), args.reps)
                bound_ms, bound_by = mtm_bound(fdm, v.shape[0], v.element_size())
                row = dict(kind="k1", shape=shape, symmetric=symmetric, dtype=str(dtype).split(".")[-1],
                           v=list(v.shape), n_colors=fdm.cb.n_colors, ms=ms, eager_ms=eager_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_rel_err=rel, tol=tol, ok=rel <= tol, bit_identical=bool(torch.equal(got, again)))
                if hasattr(mtm, "launch_shape"):
                    row["launch"] = mtm.launch_shape(fdm, v.shape[0])
                if timed:
                    stamps = torch.zeros(mtm.stamp_slots(), dtype=torch.int64, device=dev)
                    runs = []
                    for _ in range(10):
                        stamps.zero_()
                        tout = mtm.mtm_cuda(fdm, v, stamps=stamps)
                        torch.cuda.synchronize()
                        runs.append(mtm.phase_times(stamps, mtm.phase_names_for(fdm, v.shape[0])))
                    row["timed_bit_identical"] = bool(torch.equal(got, tout))
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
                    say(kind="k1_phases", shape=shape, symmetric=symmetric, dtype=row["dtype"], **mean)
                if args.memory_form:
                    xm = mtm.mtm_cuda(fdm, v, memory_form=True)
                    torch.cuda.synchronize()
                    mms = graph_ms(lambda: mtm.mtm_cuda(fdm, v, memory_form=True), args.reps)
                    say(kind="k1_memory_form", shape=shape, symmetric=symmetric, dtype=row["dtype"], ms=mms,
                        max_rel_err=float((xm - ref).abs().max() / ref.abs().max()),
                        launch=mtm.launch_shape(fdm, v.shape[0], memory_form=True))
                for T in args.tau_rows:
                    if mtm.smem_bytes(fdm.n_sites, T, v.element_size()) > mtm.SMEM_MAX:
                        continue  # the block does not fit a CTA
                    xt = mtm.mtm_cuda(fdm, v, tau_rows=T)
                    torch.cuda.synchronize()
                    tms = graph_ms(lambda: mtm.mtm_cuda(fdm, v, tau_rows=T), args.reps)
                    say(kind="k1_tau_rows", shape=shape, symmetric=symmetric, dtype=row["dtype"], tau_block=T,
                        ms=tms, max_rel_err=float((xt - ref).abs().max() / ref.abs().max()),
                        launch=mtm.launch_shape(fdm, v.shape[0], tau_rows=T))


if __name__ == "__main__":
    main()
