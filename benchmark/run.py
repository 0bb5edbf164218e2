"""Run one benchmark cell and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the port
(`smoqyelphqmc_tpu_torch`). With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (each read by
`metrics/<name>.py` from the traced sweeps and simulate's metadata), the
device's busy and traced seconds and a breakdown. Every run ends with the
comparison with the plain reference (`check.py`); the numbers compared and
their limits are the last lines on standard error and the last key of the
result line. Exits 2, printing no result, without a card (or with fewer
cards than the cell asks for), and 3 when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T0 = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smoqyelphqmc_tpu")


def say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def read_layer_metric(name: str, run) -> "float | None":
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        say(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    torch.set_num_threads(1)  # one host thread: the host is shared, and a thread pool's waits there read as noise
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        say(f"needs {entry['chips']} CUDA device(s): available {torch.cuda.is_available()}, "
            f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2

    from benchmark.harness import Cell, LayerRun, p90, run_cell, walker_sweeps_per_s

    cell = Cell.load(args.workload)
    if (cell.spec["config"], cell.spec["traffic"]) != (entry["config"], entry["traffic"]):
        say(f"workloads/{args.workload}.json and BENCHMARK.json disagree on the configuration or traffic")
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    win = res.window
    n = len(win.durations)
    say(f"window {win.seconds:.4f} s, {n} measured sweeps of {cell.n_walkers} walker(s); "
        f"set-up {win.t_open - T0:.4f} s; all_converged {win.metadata['all_converged']}")

    metrics = {}
    if not args.trace:
        values = {
            "walker_sweeps_per_s": lambda: walker_sweeps_per_s(win, cell.n_walkers),
            "sweep_s_p90": lambda: p90(win.durations),
            "setup_s": lambda: win.t_open - T0,
        }
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = {"value": values[m["name"]](), "unit": m["unit"]}
        say(f"sweep seconds: {n} samples (p90 over them)")
    else:
        run = LayerRun(win, cell)
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                v = read_layer_metric(m["name"], run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if "k1_roofline_share" in metrics:
            say(f"k1_roofline_share {metrics['k1_roofline_share']['value']} % against the H100 SXM data sheet's "
                f"peaks; card, power limit: {power_limit()}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(entry["chips"]),
              "memory_peak_bytes": win.memory_peak}
    if args.trace and win.trace is not None:
        device.update(busy_s=win.trace.busy_us / 1e6, window_s=win.trace.window_us / 1e6)
        say(f"trace: {win.trace.n_sweeps} profiled sweep(s), {len(win.trace.kernels)} kernels, "
            f"read in {win.trace.read_s:.1f} s")

    bad = forbidden_modules()
    if bad:
        say(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 3
    attempted = n * cell.n_walkers
    result = {"correct": res.correct, "attempted": attempted,
              "failed": 0 if win.metadata["all_converged"] else attempted, "metrics": metrics, "device": device}
    if args.trace and win.trace is not None:
        result["breakdown"] = {"device_ops": win.trace.top_ops(10), "idle_gaps": win.trace.idle_gaps(10)}
    result["compared"] = {k: {"value": v, "limit": res.limits[k]} for k, v in res.compared.items()}
    marks = res.extra["marks"]
    say("seconds after the window closed: " + ", ".join(f"{k} {v - marks['window_closed']:.1f}" for k, v in marks.items()))
    say(f"Delta H of the checked sweep (reference): {res.extra.get('dH')}")
    for k, v in res.compared.items():
        ok = math.isfinite(v) and v <= res.limits[k]
        say(f"compared {k} {v!r} limit {res.limits[k]!r}{'' if ok else ' FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
