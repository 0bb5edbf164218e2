"""How far a chain moves when one kernel's float32 rounding changes, on one GPU.

    python smoqyelphqmc_tpu_torch/sweep_sensitivity.py [--sweeps 2]
        [--package-root DIR] [--label NAME]

Runs two paths twice each from the same seed: once as they are, and once
with one kernel's outputs nudged by one unit in the last place (float32,
each element up or down by a seeded coin), the size of the difference a
change of the kernel's operation order makes:

- the W=1 path (the headline model, its trajectory forces through K2 +
  K4: K4's planes P1, P2 nudged);
- the complex path (the complex chain of chip_smoke.py, N=1152, with
  preconditioner='kpm', both factorizations: K8's outputs nudged).

Each run prints one JSON line (`sweeps`): the path, whether nudged, s/sweep,
CG iterations per solve, acceptance and every Delta H. Comparing a
version's two runs shows the chain's sensitivity to rounding alone; a
change whose kernel agrees with the plain version to rounding but moves
Delta H no more than that has not changed the physics.

`--package-root DIR` imports smoqyelphqmc_tpu_torch from DIR (an unpacked
earlier commit); run it as a file, not with -m, for that. The first line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0)
COMPLEX = dict(L=1152, beta=12.0, dtau=0.05, phase=0.7, alpha=0.5, Omega=1.0, mu=0.1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("sweep_sensitivity: no CUDA device; the kernels run only on a GPU")

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model, holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.ops import force, kpm_mf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")

    def nudge(t):
        """t with each element moved one float32 ulp up or down (a seeded coin)."""
        up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
        inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
        return torch.where(up, torch.nextafter(t, inf), torch.nextafter(t, -inf))

    def nudged(fn):
        return lambda *a, **kw: tuple(nudge(t) for t in fn(*a, **kw))

    paths = []
    geo, tbm, em = holstein_honeycomb_model(HEADLINE["L"], HEADLINE["Omega"], HEADLINE["alpha"], HEADLINE["mu"])
    cfg = SimulationConfig(beta=HEADLINE["beta"], dtau=HEADLINE["dtau"], Nt=24, tol=1e-10, seed=1,
                           mixed_precision=True, force_dtype="float32")
    paths.append(("w1", tbm, em, cfg, force, "force_planes_cuda"))
    c = COMPLEX
    _, ctbm, cem = complex_chain_model(c["L"], 1.0, c["phase"], c["mu"], c["Omega"], c["alpha"])
    for symmetric in (True, False):
        ccfg = SimulationConfig(beta=c["beta"], dtau=c["dtau"], Nt=24, tol=1e-10, seed=1, mixed_precision=True,
                                force_dtype="float32", preconditioner="kpm", symmetric=symmetric)
        paths.append(("complex_kpm_" + ("symmetric" if symmetric else "asymmetric"), ctbm, cem, ccfg, kpm_mf,
                      "kpm_mf_cplx_cuda"))
    for name, tbm_, em_, cfg_, module, attr in paths:
        original = getattr(module, attr)
        for nudge_on in (False, True):
            gen.manual_seed(7)
            setattr(module, attr, nudged(original) if nudge_on else original)
            try:
                md = run_updates(tbm_, em_, cfg_, args.sweeps, device="cuda")
            finally:
                setattr(module, attr, original)
            print(json.dumps(dict(
                label=args.label, card=smi, kind="sweeps", path=name, nudged=nudge_on, kernel=attr,
                sweep_s=[float(t) for t in md["sweep_s"]], hmc_iters=md["hmc_iters"],
                reflection_iters=md["reflection_iters"], swap_iters=md["swap_iters"],
                acceptance=dict(reflection=md["reflection_acceptance_rate"], swap=md["swap_acceptance_rate"],
                                hmc=md["hmc_acceptance_rate"]),
                all_converged=md["all_converged"], delta_H=[float(d) for d in md["hmc_delta_H"]])), flush=True)


if __name__ == "__main__":
    main()
