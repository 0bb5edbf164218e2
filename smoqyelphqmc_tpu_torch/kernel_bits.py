"""Fingerprints of the kernels' outputs on seeded inputs, on one GPU.

    python smoqyelphqmc_tpu_torch/kernel_bits.py [--package-root DIR] [--label NAME]

Runs K1 (headline and L=48 shapes, both factorizations, f32 and f64), K2
(a cold solve at the headline), K4 (the W=1 trajectory's shape, want_p2 on) and
K6 / K7 / K8 (the large-N and complex-chain KPM applies) once each on
inputs made from seeds, and prints one JSON line per output: its shape and
the SHA-256 of its bytes. Two versions of the package give the same
fingerprint exactly when the kernel returned the same bits; run an
unpacked earlier commit with `--package-root DIR` (as a file, not with -m)
in the same call to see which kernels a change left bit for bit. The first
line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0)
LARGE = dict(HEADLINE, L=48, alpha=1.5)
COMPLEX = dict(L=1152, beta=12.0, dtau=0.05, phase=0.7, alpha=0.5, Omega=1.0, mu=0.1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_bits: no CUDA device; the kernels run only on a GPU")

    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model, holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops import force, kpm_mf, mtm, pcg
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    def say(kernel, case, *outs):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in outs:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        print(json.dumps(dict(label=args.label, kernel=kernel, case=case, shapes=[list(t.shape) for t in outs],
                              sha256=h.hexdigest()[:24])), flush=True)

    def model(h, complex_chain=False, symmetric=True):
        if complex_chain:
            _, tbm, em = complex_chain_model(h["L"], 1.0, h["phase"], h["mu"], h["Omega"], h["alpha"])
        else:
            _, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
        rng = np.random.default_rng(0)
        tbp = TightBindingParameters.from_model(tbm, rng, device=dev)
        elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=dev)
        structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
        fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)
        return tbp, elph, fdm

    def randn(shape, seed, dtype=torch.float32):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64).to(dev, dtype)

    for name, h in (("headline", HEADLINE), ("L48", LARGE)):
        for symmetric in (True, False):
            _, _, fdm64 = model(h, symmetric=symmetric)
            for dtype in (torch.float32, torch.float64):
                fdm = fdm64.astype(dtype)
                say("K1", f"{name} {'sym' if symmetric else 'asym'} {str(dtype)[-7:]}",
                    mtm.mtm_cuda(fdm, randn((2, fdm.Ltau, fdm.n_sites), 11, dtype)))
    tbp, elph, fdm64 = model(HEADLINE)
    fdm32 = fdm64.astype(torch.float32)
    pre = build_spectral(fdm64)
    b = randn((2, fdm32.Ltau, fdm32.n_sites), 12)
    b = b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)
    x, *_ = pcg.pcg_cuda(fdm32, pre, b, 1e-5, 500)
    say("K2", "headline cold", x)
    Lam = build_lambda(elph, elph.x, tbp.n_sites).to(torch.float32)
    say("K4", "headline want_p2", *force.force_planes_cuda(fdm32, Lam, randn((2, fdm32.Ltau, fdm32.n_sites), 14),
                                                            True))
    for symmetric in (True, False):
        _, _, fdm = model(LARGE, symmetric=symmetric)
        pre = KPMPreconditioner.build(fdm, torch.randn(fdm.n_sites, generator=torch.Generator().manual_seed(16),
                                                       dtype=torch.float64))
        u = randn((2, 2, fdm.Ltau, fdm.n_sites), 17)
        say("K6" if symmetric else "K7", "L48", *kpm_mf.kpm_mf_cuda(pre.mf_operands(), u[0], u[1]))
        _, _, fdm = model(COMPLEX, complex_chain=True, symmetric=symmetric)
        pre = KPMPreconditioner.build(fdm, torch.randn(2 * fdm.n_sites, generator=torch.Generator().manual_seed(18),
                                                       dtype=torch.float64))
        u = randn((2, fdm.Ltau, fdm.n_sites), 19)
        say("K8", "complex chain " + ("sym" if symmetric else "asym"),
            *kpm_mf.kpm_mf_cplx_cuda(pre.mf_operands(), u[0], u[1]))


if __name__ == "__main__":
    main()
