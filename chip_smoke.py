"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from smoqyelphqmc_tpu_torch/csrc;
  3. K1 (M^T M, f32 and f64) against its plain PyTorch version on the headline
     model's tables at (2, 240, 288);
  4. K2 (whole-solve spectral PCG) against its plain version, cold and warm;
  5. the main path: `run_updates` on the headline model (Holstein honeycomb
     L=12, beta=12, dtau=0.05) for a few sweeps; every solve must converge,
     every Delta H be finite, K1 and K2 must have launched and the plain
     versions must not have run;
  6. the same sweeps on a small model on the GPU and on the CPU (plain
     versions): the chains must agree.
Then one JSON line of kernel results, and as the last line
{"ok": true, "device": {...}}. Any failure exits nonzero without that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0, Nt=24, tol=1e-10)
N_SWEEPS = 3
MAIN_DEVICE = "cuda"


def fail(msg: str, code: int = 1) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def headline_fdm(device):
    import numpy as np

    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix

    h = HEADLINE
    geo, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    elph = ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=device)
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=True)


def phase_k1(fdm64, results):
    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm

    gen = torch.Generator(device="cpu").manual_seed(11)
    for dtype, tol, name in ((torch.float32, 2e-6, "mtm_f32"), (torch.float64, 1e-12, "mtm_f64")):
        fdm = fdm64.astype(dtype)
        v = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float64).to(fdm.device, dtype)
        got = mtm.mtm_cuda(fdm, v)
        ref = mtm.mtm_plain(fdm, v)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = cuda_ms(lambda: mtm.mtm_cuda(fdm, v), 50)
        plain_ms = cuda_ms(lambda: mtm.mtm_plain(fdm, v), 20)
        say(f"K1 {name}: shape {tuple(v.shape)} max_rel_err {rel:.3e} (tol {tol:g}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not rel <= tol:
            fail(f"K1 {name} disagrees with its plain version: {rel:.3e} > {tol:g}")
        results[name] = dict(name=name, route="cuda", source="smoqyelphqmc_tpu_torch/csrc/mtm.cu",
                             replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:121",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2(fdm64, results):
    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm, pcg
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    tol, maxiter = 1e-5, 500
    pre = build_spectral(fdm64)
    fdm32 = fdm64.astype(torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(12)
    b = torch.randn((2, fdm32.Ltau, fdm32.n_sites), generator=gen, dtype=torch.float64)
    b = b.to(fdm32.device, torch.float32)

    def unit(rhs):
        n = torch.sqrt(torch.sum(rhs * rhs, dim=(1, 2), keepdim=True))
        return (rhs / n).contiguous(), n

    rows = []
    bu, nb = unit(b)
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, bu, tol, maxiter)
    rows.append(("cold", xk * nb, ek, ik, xp * nb, ep, ip))
    x0 = xp * nb
    # warm start: the correction against b - A x0, scaled by |b| (FusedPCG.__call__)
    bw = ((b - mtm.mtm_plain(fdm32, x0)) / nb).contiguous()
    xkw, ekw, ikw = pcg.pcg_cuda(fdm32, pre, bw, tol, maxiter)
    xpw, epw, ipw = pcg.pcg_plain(fdm32, pre, bw, tol, maxiter)
    rows.append(("warm", x0 + xkw * nb, ekw, ikw, x0 + xpw * nb, epw, ipw))
    torch.cuda.synchronize()
    max_err = 0.0
    for tag, xk_, ek_, ik_, xp_, ep_, ip_ in rows:
        conv_k = bool(torch.isfinite(xk_).all()) and bool((ek_ < tol).all())
        conv_p = bool(torch.isfinite(xp_).all()) and bool((ep_ < tol).all())
        # true residuals |b - A x| / |b| in the plain f32 operator: the CG's
        # recursive residual drifts from it in f32, equally in both versions
        res_k, res_p = (float((torch.linalg.vector_norm(b - mtm.mtm_plain(fdm32, xx), dim=(1, 2))
                               / torch.linalg.vector_norm(b, dim=(1, 2))).max()) for xx in (xk_, xp_))
        diff = (xk_ - xp_).abs()
        err = float(diff.max())
        # tolerances of tests/test_pallas.py:96; the atol there is for solutions
        # of unit scale, so here it scales with max |x|
        scale = float(xp_.abs().max())
        bound_ok = bool((diff <= 2e-5 * scale + 2e-4 * xp_.abs()).all())
        max_err = max(max_err, err)
        say(f"K2 {tag}: converged kernel {conv_k} plain {conv_p}; iters kernel {int(ik_)} "
            f"plain {int(ip_)}; true residual kernel {res_k:.3e} plain {res_p:.3e}; max|x| {scale:.4g}; "
            f"max |x_kernel - x_plain| {err:.3e} (rtol 2e-4, atol 2e-5 max|x|: {bound_ok})")
        if not (conv_k and conv_p):
            fail(f"K2 {tag} solve did not converge (kernel {conv_k}, plain {conv_p})")
        if not bound_ok:
            fail(f"K2 {tag} solve: kernel and plain solutions differ beyond the tolerance")
        if not res_k <= max(2 * tol, 2 * res_p):
            fail(f"K2 {tag} solve: true residual {res_k:.3e} of the kernel's solution exceeds the plain one's")
    ms = cuda_ms(lambda: pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter), 5)
    plain_ms = cuda_ms(lambda: pcg.pcg_plain(fdm32, pre, bu, tol, maxiter), 2)
    lib_grid = pcg._build.load_library().smoqy_pcg_grid(fdm32.n_sites)
    say(f"K2 cold solve time: kernel {ms:.3f} ms plain {plain_ms:.3f} ms (grid {lib_grid} CTAs)")
    results["pcg"] = dict(name="pcg", route="cuda", source="smoqyelphqmc_tpu_torch/csrc/pcg.cu",
                          replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:495",
                          max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def phase_main(results, card):
    import math

    import torch

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.ops.mtm import MTM
    from smoqyelphqmc_tpu_torch.ops.pcg import PCG

    h = HEADLINE
    geo, tbm, em = holstein_honeycomb_model(h["L"], h["Omega"], h["alpha"], h["mu"])
    cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=h["Nt"], tol=h["tol"], seed=1,
                           mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    counters = {"mtm_f32": MTM[torch.float32], "mtm_f64": MTM[torch.float64], "pcg": PCG}
    for c in counters.values():
        c.reset()
    md = run_updates(tbm, em, cfg, N_SWEEPS, device=MAIN_DEVICE)
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    for k, (launches, _) in counts.items():
        results[k]["launches"] = launches
    sweep_s = md["sweep_s"]
    say(f"main path on {card}: {N_SWEEPS} sweeps L={h['L']} beta={h['beta']} Ltau={md['Ltau']} "
        f"N={md['n_sites']}; acceptance refl {md['reflection_acceptance_rate']:.3f} "
        f"swap {md['swap_acceptance_rate']:.3f} hmc {md['hmc_acceptance_rate']:.3f}; iters/solve "
        f"refl {md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; "
        f"s/sweep {[round(s, 4) for s in sweep_s]} (init {md['t_init_s']:.3f} s); "
        f"dH {[round(d, 5) for d in md['hmc_delta_H']]}; launches/plain calls {counts}")
    if not md["all_converged"]:
        fail("a solve of the main path did not converge")
    if not all(math.isfinite(d) for d in md["hmc_delta_H"]):
        fail("a Delta H of the main path is not finite")
    for k, (launches, plain) in counts.items():
        if launches <= 0:
            fail(f"kernel {k} never launched on the main path")
        if plain != 0:
            fail(f"the plain version of {k} ran {plain} times on the main path")
    x = md["x_final"]
    if tuple(x.shape) != (2 * h["L"] ** 2, md["Ltau"]) or not bool(x.isfinite().all()):
        fail(f"final field has shape {tuple(x.shape)} or non-finite values")


def phase_small_reference():
    """The same chain on a small model on the GPU (kernels) and the CPU (plain
    versions): the accept decisions must match and the fields agree to 1e-4
    relative (the f32 force solves stop at 1e-5 relative in both, with sums in
    another order, so forces may differ at that level)."""
    import torch

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model

    geo, tbm, em = holstein_honeycomb_model(3, 1.0, 0.6, 0.0)
    cfg = SimulationConfig(beta=2.0, dtau=0.1, Nt=12, seed=5, preconditioner="spectral")
    gpu = run_updates(tbm, em, cfg, 3, device="cuda")
    cpu = run_updates(tbm, em, cfg, 3, device="cpu")
    xg, xc = gpu["x_final"].cpu(), cpu["x_final"]
    err = float((xg - xc).abs().max() / xc.abs().max())
    same = all(gpu[f"{k}_acceptance_rate"] == cpu[f"{k}_acceptance_rate"] for k in ("reflection", "swap", "hmc"))
    say(f"small-model reference (L=3, beta=2): GPU vs CPU field max rel err {err:.3e}; "
        f"same acceptance {same}; dH gpu {[round(d, 6) for d in gpu['hmc_delta_H']]} "
        f"cpu {[round(d, 6) for d in cpu['hmc_delta_H']]}")
    if not (same and err <= 1e-4 and gpu["all_converged"] and cpu["all_converged"]):
        fail("the GPU chain disagrees with the CPU reference on the small model")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU", 2)
    root = Path(__file__).resolve().parent
    if not (root / "smoqyelphqmc_tpu_torch" / "csrc").is_dir():
        fail("smoqyelphqmc_tpu_torch/ not found beside chip_smoke.py: run it from a checkout", 3)
    sys.path.insert(0, str(root))
    os.chdir(root)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not smi_line:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi_line)
    card = f"{torch.cuda.get_device_name(0)} ({smi_line.split(',')[-1].strip()} limit)"
    say(f"device: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    from smoqyelphqmc_tpu_torch import _build

    t0 = time.perf_counter()
    info = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, built {info['built']}); "
        f"ptxas: {' | '.join(ptxas)}")

    results: dict = {}
    fdm64 = headline_fdm(torch.device("cuda"))
    phase_k1(fdm64, results)
    phase_k2(fdm64, results)
    phase_main(results, card)
    phase_small_reference()
    kernels = []
    for k in ("mtm_f32", "mtm_f64", "pcg"):
        r = results[k]
        kernels.append(dict(name=r["name"], route=r["route"], source=r["source"], replaces=r["replaces"],
                            launches=r.get("launches", 0), max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
