"""Delta H of one HMC trajectory against its number of steps.

    python -m smoqyelphqmc_tpu_torch.dh_scan [--L 12] [--beta 12] [--Nt 24 48 96] [--device cuda]

From the initial state of the optical-SSH honeycomb (examples/ossh_honeycomb.py:
Omega=1, alpha=0.5, mu=0, dtau=0.05; expanded from seed 1 as `run_updates`
expands it; the package defaults: mixed precision, f32 forces, 'auto'
preconditioner) and one set of draws, runs one leapfrog trajectory for
each Nt (dt = pi / (2 Nt)) and prints one JSON line each: Delta H,
iterations per solve and seconds. With consistent forces Delta H falls as
dt^2 (a factor ~4 a doubling of Nt); where it stays near 1 or above at the
configured Nt, the chain's HMC acceptance is near 0 and its timestep, not
the kernels, needs attention. On the card the first line is its name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=12)
    ap.add_argument("--beta", type=float, default=12.0)
    ap.add_argument("--Nt", type=int, nargs="+", default=[24, 48, 96])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from .models import library
    from .models.electron_phonon import ElectronPhononParameters
    from .models.tight_binding import TightBindingParameters
    from .updates.context import initialize_qmc
    from .updates.hmc import HMCParams, draw_hmc, hmc_update

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    seed = 1
    geo, tbm, em = library.ossh_honeycomb_model(args.L, 1.0, 0.5, 0.0)
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
    elph = ElectronPhononParameters.from_model(args.beta, 0.05, em, tbp, rng, device=dev)
    ctx, state = initialize_qmc(tbp, elph, mixed_precision=True, force_dtype="float32")
    for Nt in args.Nt:
        draws = draw_hmc(torch.Generator(device="cpu").manual_seed(seed), ctx, state.precond)
        t0 = time.perf_counter()
        _, st = hmc_update(ctx, state, HMCParams(Nt=Nt), draws)
        seconds = time.perf_counter() - t0
        print(json.dumps({"L": args.L, "beta": args.beta, "Nt": Nt,
                          "delta_H": st.delta_H, "iters_per_solve": st.iters_avg, "converged": st.converged,
                          "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
