"""Readings the limits of `correct` are set from: the program's numbers and
the control's, on several seeds, in one process.

    python benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--device cuda]

For each seed: set-up and a short window of the cell, then the resumed
sweep compared with the plain reference (the program's numbers), and from
the same state and draws the reference at precision "control" (one step
below the configuration's: it has to fail) and at "config" (the
configuration's own precisions: the spread a sound program may show), each
judged as the program is. One JSON line a seed. The benchmark's own runs do
not run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    """The program's numbers and the control's and the configuration
    precision's at `seed`, after a window of `seconds`."""
    from benchmark.harness import run_cell

    res = run_cell(cell, seed, seconds, False, device, control=True)
    marks = res.extra["marks"]
    return {"seed": seed, "program": res.compared, "dH": res.extra["dH"], "control": res.extra["control"],
            "config": res.extra["config"], "reference_s": marks["checked"] - marks["resumed"],
            "control_s": marks["controlled"] - marks["checked"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import Cell

    cell = Cell.load(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
