"""Production-scale physics check through the port: the CDW correlation
ratio against beta (the twin of scripts/physics_sweep.py).

    python -m smoqyelphqmc_tpu_torch.physics_sweep [--Ls 6,9] [--betas 2,4,6,8,10]
        [--therm 300] [--meas 600] [--bins 8] [--walkers 8] [--out /tmp/physics_sweep]
        [--device cuda] [--resume] [--checkpoint-minutes 10] [--runtime-limit-minutes M]

On the half-filled honeycomb Holstein model (Omega = t, alpha = 1.5) the
Q = Gamma staggered-CDW correlation ratio

    R_cdw(L, beta) = 1 - <S(Q + dq)>_dq / S(Q)

grows with beta and, across system sizes, the order of the L's reverses near
the finite-T CDW transition. Each (L, beta) point runs the walker driver
(`driver.simulate`, W walkers, the shared preconditioner and its fallback
controller, the estimator refreshes and measurement passes) with the
script's model, configuration, seed (1000 + 7 L + int(10 beta)) and data
folder; R_cdw and its jackknife error come from all W N_bins bins
(`io.correlation_ratio.composite_ratio_from_bins`). No h5py is needed: every
bin `simulate` yields is pickled to the data folder's bins/ as
bin-<k>_pID-<p>.pkl as it comes (the same bytes when a resumed run yields it
again).

A point checkpoints every --checkpoint-minutes and stops at
--runtime-limit-minutes (the only SimulationConfig fields that differ from
the script's; a resumed run repeats an uninterrupted one's sweeps bit for
bit). With --resume a cut point continues from its checkpoint and the bins it
wrote, and a finished point (its row.json) is skipped; without it each
point's folder is cleared first, as the script clears it. A point at a time,
or several processes each on its own points:

    python -m smoqyelphqmc_tpu_torch.physics_sweep --Ls 9 --betas 10 --resume --out DIR

Output: one JSON row a finished point (the script's keys, then the unrounded
ratio and error, the acceptances, iterations per solve, all_converged,
precond_fallback_sweeps, seconds a thermalization and a measured sweep and
the point's segments); at the end the markdown table, results.json and
rcdw_vs_beta.csv (the script's header) of every finished point asked for.
On the card the first line is its name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np


def _ints(s: str):
    return [int(v) for v in s.split(",")]


def _floats(s: str):
    return [float(v) for v in s.split(",")]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--Ls", type=_ints, default=[6, 9])
    ap.add_argument("--betas", type=_floats, default=[2.0, 4.0, 6.0, 8.0, 10.0])
    ap.add_argument("--therm", type=int, default=300)
    ap.add_argument("--meas", type=int, default=600)
    ap.add_argument("--bins", type=int, default=8)
    ap.add_argument("--walkers", type=int, default=8)
    ap.add_argument("--out", default="/tmp/physics_sweep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-minutes", type=float, default=10.0)
    ap.add_argument("--runtime-limit-minutes", type=float, default=np.inf)
    return ap.parse_args(argv)


def point_folder(out_dir: str, L: int, beta: float) -> str:
    return os.path.join(out_dir, f"L{L}_b{beta:g}")


def point_setup(L: int, beta: float, args: argparse.Namespace):
    """(sim_info, tight-binding model, electron-phonon model, measurement
    set, config) of one point: scripts/physics_sweep.py's, but for the
    checkpoint interval and the runtime limit."""
    from .driver import SimulationConfig
    from .io.simulation_info import SimulationInfo
    from .models.library import holstein_honeycomb_model, holstein_honeycomb_spec

    geo, tbm, em = holstein_honeycomb_model(L, 1.0, 1.5, 0.0)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(filepath=point_folder(args.out, L, beta), datafolder_prefix=f"hh_L{L}_b{beta:g}", sID=1)
    cfg = SimulationConfig(
        beta=beta, dtau=0.05, N_therm=args.therm, N_measurements=args.meas,
        N_bins=args.bins, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000,
        seed=1000 + 7 * L + int(10 * beta), n_walkers=args.walkers,
        checkpoint_freq_hours=args.checkpoint_minutes / 60.0,
        runtime_limit_hours=args.runtime_limit_minutes / 60.0,
    )
    return sim_info, tbm, em, spec, cfg


def cdw_neighbors(L: int):
    """The six honeycomb neighbours of Q = 0 that R_cdw compares it with."""
    return [(1, 0), (0, 1), (1, 1), (L - 1, 0), (0, L - 1), (L - 1, L - 1)]


def bin_path(sim_info, pID: int, b: int) -> str:
    return os.path.join(sim_info.bins_folder, f"bin-{b}_pID-{pID}.pkl")


def write_bin(sim_info, pID: int, b: int, tree) -> None:
    path = bin_path(sim_info, pID, b)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(tree, f, protocol=4)
    os.replace(path + ".tmp", path)


def read_cdw_bins(sim_info, n_walkers: int, n_bins: int) -> dict:
    """{(pID, bin): {"composite": {"cdw": (re, im)}}} from the bin files."""
    bins = {}
    for p in range(n_walkers):
        for b in range(n_bins):
            with open(bin_path(sim_info, p, b), "rb") as f:
                bins[(p, b)] = {"composite": {"cdw": pickle.load(f)["composite"]["cdw"]}}
    return bins


def run_point(L: int, beta: float, args: argparse.Namespace):
    """Run (or continue) one point; its row when it finished, else None."""
    from .driver import simulate
    from .io.checkpoint import delete_checkpoints
    from .io.correlation_ratio import composite_ratio_from_bins

    folder = point_folder(args.out, L, beta)
    row_path = os.path.join(folder, "row.json")
    if args.resume and os.path.exists(row_path):
        with open(row_path) as f:
            return json.load(f)
    if not args.resume:
        shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder, exist_ok=True)
    sim_info, tbm, em, spec, cfg = point_setup(L, beta, args)
    W = cfg.n_walkers
    t0 = time.perf_counter()
    run = simulate(sim_info, tbm, em, spec, cfg, resume=args.resume, device=args.device)
    while True:
        try:
            item = next(run)
        except StopIteration as done:
            md, finished = done.value
            break
        pID, b = (0, item[0]) if len(item) == 2 else item[:2]
        write_bin(sim_info, pID, b, item[-1])
    wall = time.perf_counter() - t0
    with open(os.path.join(folder, "segments.jsonl"), "a") as f:
        f.write(json.dumps({"wall_s": wall, "finished": finished}) + "\n")
    if not finished:
        return None
    delete_checkpoints(sim_info.datafolder)
    with open(os.path.join(folder, "segments.jsonl")) as f:
        segments = [json.loads(line)["wall_s"] for line in f]
    bins = read_cdw_bins(sim_info, W, cfg.N_bins)
    R, dR = composite_ratio_from_bins(bins, "cdw", spec, (0, 0), cdw_neighbors(L))
    row = {
        "L": L, "beta": beta, "Rcdw": round(float(R.real), 4),
        "Rcdw_err": round(float(dR), 4), "wall_s": round(sum(segments), 1),
        "walkers": W, "therm": cfg.N_therm, "meas": cfg.N_measurements,
        "bins_total": cfg.N_bins * W,
        "Rcdw_unrounded": float(R.real), "Rcdw_imag": float(R.imag), "Rcdw_err_unrounded": float(dR),
        "seed": cfg.seed,
        **{f"{k}_acceptance_rate": md[f"{k}_acceptance_rate"] for k in ("hmc", "reflection", "swap")},
        **{f"{k}_iters": md[f"{k}_iters"] for k in ("hmc", "reflection", "swap", "measurement")},
        "all_converged": md["all_converged"],
        "precond_fallback_sweeps": md.get("precond_fallback_sweeps", 0),
        "s_per_therm_sweep": md["t_therm_s"] / md["n_therm_timed"] if md.get("n_therm_timed") else None,
        "s_per_measured_sweep": md["t_measure_s"] / md["n_measure_timed"] if md.get("n_measure_timed") else None,
        "segments_s": segments,
    }
    with open(row_path + ".tmp", "w") as f:
        json.dump(row, f)
    os.replace(row_path + ".tmp", row_path)
    return row


def write_outputs(rows, out_dir: str) -> None:
    """The script's markdown table, results.json and rcdw_vs_beta.csv."""
    print("\n| L | beta | R_cdw | err |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['L']} | {r['beta']:g} | {r['Rcdw']:.3f} | {r['Rcdw_err']:.3f} |")
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(rows, f, indent=1)
    csv_path = os.path.join(out_dir, "rcdw_vs_beta.csv")
    with open(csv_path, "w") as f:
        f.write("L,beta,Rcdw,Rcdw_err,walkers,therm,meas,bins_total\n")
        for r in rows:
            f.write(
                f"{r['L']},{r['beta']},{r['Rcdw']},{r['Rcdw_err']},"
                f"{r['walkers']},{r['therm']},{r['meas']},{r['bins_total']}\n"
            )
    print(f"\nCSV: {csv_path}")


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu to run on the host", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    rows, unfinished = [], []
    for L in args.Ls:
        for beta in args.betas:
            row = run_point(L, beta, args)
            if row is None:
                unfinished.append((L, beta))
                print(json.dumps({"L": L, "beta": beta, "finished": False}), flush=True)
            else:
                rows.append(row)
                print(json.dumps(row), flush=True)
    write_outputs(rows, args.out)
    if unfinished:
        print(f"unfinished (rerun with --resume): {unfinished}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
