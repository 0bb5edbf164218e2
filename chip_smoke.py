"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from smoqyelphqmc_tpu_torch/csrc;
  3. K1 (M^T M, f32 and f64) against its plain PyTorch version on the headline
     model's tables at (2, 240, 288), its time the device's (a CUDA graph of
     launches) beside the eager caller's; then the same at the large-N
     path's shape (2, 240, 4608), symmetric and asymmetric, f32 and f64, each
     on its own line with its bound;
  4. K2 (whole-solve spectral PCG) against its plain version, cold and warm,
     with its time, us and grid syncs per iteration; then K2 at the Green's
     estimator refresh's shape, 2 Nrv = 20 unit-norm systems M^T R of
     (10, 2, 240, 288) random-phase vectors at tol 2e-5, with its time per
     launch, iterations and us per iteration beside the 2-system solve's;
  5. the update path: `run_updates` on the headline model (Holstein honeycomb
     L=12, beta=12, dtau=0.05) for a few sweeps; every solve must converge,
     every Delta H be finite, K1, K2 and K4 (the trajectory's force planes)
     must have launched and the plain versions must not have run;
  5a. the measured main path: run_simulation's loop (`driver.simulate`) on
     the headline model with the tutorial measurement set (N_therm=2,
     N_measurements=4, N_bins=2, Nrv=10, f32 measurements) into a fresh
     folder, the bins in memory (the card's machine has no h5py; the HDF5
     output is held on the CPU by tests/test_torch_simulation.py and
     test_torch_io.py); the model summary must be written, every bin value
     be finite except the six NaN globals, every solve converge, K1, K2 and
     K4 launch and no plain version run; the line gives acceptance, iterations
     per solve, s per measured sweep, the estimator refresh's share, the
     density and the launches;
  6. the same sweeps on a small model on the GPU and on the CPU (plain
     versions): the chains must agree; then the measured run on that model
     (honeycomb L=3, beta=2) on both: every sweep's accept flags equal, the
     bins to 1e-4 of each observable's largest magnitude, and the GPU run
     interrupted after every sweep until its first bin, then resumed, must
     write the uninterrupted run's bins bit for bit;
  7. K5: K1 on an irregular lattice (the headline honeycomb with its site
     labels permuted, more than 8 lane-shift classes per color, where the
     JAX package takes `_mtm_kernel_mm`) against its plain version, then one
     sweep on that lattice (`driver.run_sweeps`);
  8. K3 (whole-solve PCG + force epilogue) on W = 8 walkers at the headline
     size against its plain version, cold and warm, with the time of each,
     us and grid syncs per iteration, its tau block and grid;
  9. K4 (the force planes alone) on one channel pair against its plain
     version, want_p2 on and off, its device time beside the eager call's
     and a line with its launch (T, grid, form) and per-phase breakdown;
 10. the walker path: `run_updates` at the headline with W = 8 walkers; every
     walker must converge, every Delta H be finite, K3 must have launched and
     no plain version may have run;
 10a. the measured walker path: `simulate` at the headline with W = 8
     walkers and the tutorial measurement set (N_therm=2, N_measurements=4,
     N_bins=2, Nrv=10), the bins in memory, one bin stream a walker; the
     line gives s per measured W = 8 sweep, walker-measured-sweeps/s, the
     estimator refreshes' and measurement passes' shares, iterations,
     precond_fallback_sweeps, each walker's density per bin; K1 f64, K2 and
     K3 must launch and no plain version run;
 10b. the same with the sampler options (radial updates, Omelyan with Nt=8,
     target_acceptance=0.7, target_density=0.9): each walker's mu after every
     tuner update, dt after every thermalization sweep, the acceptances;
 10c. the measured run at W = 2 with those options on honeycomb L=3, beta=2
     on the GPU and on the CPU: every sweep's accept flags equal, the bins
     to 1e-4 of each observable's largest magnitude, and the GPU run
     interrupted after every sweep until its first bins, then resumed, must
     repeat its bins, final mu and dt bit for bit;
 11. K4 against its plain version at the other shapes the paths here run
     it at: the benchmark cells' (2, 80, 288), the Holstein tutorials'
     (2, 80, 18), the permuted lattice of 7 and the large model's
     (2, 240, 4608) in K4's memory form; each line gives the error, the
     device's time and the launch; then K4's SSH form (`force_ssh`: P1, P2
     and the hop plane H of both color walks) at the optical-SSH cell's
     (2, 80, 288) with hop tables on every tau row, want_p2 off and on,
     each plane within 1e-5 of its plain plane's largest value, with its
     time, bound and phases;
 12. the small model at W = 2 on the GPU and on the CPU: the chains must
     agree;
 13. K6 (matrix-free KPM apply, symmetric) against its plain version on the
     large model's tables (Holstein honeycomb L=48, N=4608, alpha=1.5,
     beta=12, Ltau=240) with live Lanczos bounds, u (2 vectors, re and im
     planes of (2, 240, 4608)); with a line on how it launched (stages per
     order step, us per order step of the longest frequency, cluster size,
     order threshold, frequencies in the cluster form);
 14. K7 (the asymmetric two-pass apply) the same on the asymmetric tables;
 15. the large-N path: `run_updates` on the large model with
     preconditioner='auto', which resolves to the matrix-free KPM
     preconditioner; KPM must stay active, every solve converge, every
     Delta H be finite, and K1 f32, K1 f64 and K6 launch with no plain
     version run (the line gives K1's launches per sweep);
 16. the same path with the asymmetric factorization (K7);
 17. a KPM chain (preconditioner='kpm', N=1152 > 1024, so matrix-free) on the
     GPU and on the CPU: the chains must agree;
 18. K8 (the complex-hopping matrix-free KPM apply, channel-mixing stage
     tables) against its plain version, symmetric and asymmetric, on the
     complex chain's tables (t e^{0.7 i}, N=1152, beta=12, Ltau=240) with
     live Lanczos bounds, one and two channel pairs of (240, 1152) planes;
     with a line on how it launched (stages per order step, us per order
     step and per stage of the longest frequency, the cluster plan);
 19. the complex path: `run_updates` on that chain with preconditioner='kpm'
     (matrix-free above 1024 sites), 2 symmetric sweeps and 1 asymmetric;
     KPM must stay active, every solve converge, every Delta H be finite, K8
     launch and none of K1-K4, K6, K7 (the complex M^dag M is plain PyTorch
     by design, as in the JAX package);
 20. the same chain with preconditioner='auto' (the doubled-basis spectral
     preconditioner), 1 sweep in each factorization;
 21. K2 in its asymmetric form against its plain version on the headline
     tables, then 1 asymmetric headline sweep with 'auto' (the half-angle
     spectral build; K1 and K2 launch);
 22. the complex KPM chain (N=1152, beta=1, dtau=0.1) on the GPU and on the
     CPU: the chains must agree;
 23. SSH tables (the optical-SSH honeycomb L=12, beta=12, alpha=0.5 at its
     initial field, whose C / S rows differ across tau): K1 f32 and f64
     (also with T = 2 and a ragged T = 7) and K2 cold and warm against their
     plain versions, with times and bounds (`mtm_tau_f32`, `pcg_tau`), and K2
     at the estimator refresh's 20 systems on these tables; then
     the table forms' own cost on the headline Holstein values, one row
     against Ltau replicated rows (K1 register / memory form, K2 at equal
     iterations);
 24. the measured SSH path: `simulate` on that model with the SSH examples'
     configuration (radial updates, Nt=24, the package defaults) and
     `basic_spec`, N_therm=2, N_measurements=4, N_bins=2, Nrv=10, at W=1;
     every solve converged and Delta H finite, K1, K2 and K4's SSH form
     launched and K3, the KPM kernels and every plain version not; the line
     gives s per
     measured sweep, the shares, iterations, acceptances (HMC, reflection,
     swap, radial), Delta H and ssh_energy per bin;
 25. the same at W=8 (walker by walker trajectories, the shared refresh from
     the walker mean of every factor), with walker-measured-sweeps/s and
     precond_fallback_sweeps;
 26. GPU against CPU on small SSH models: the optical-SSH honeycomb L=3,
     beta=2 measured at W=1 and W=2, each interrupted and resumed bit for
     bit; the bond-SSH square L=4 with a dispersion coupling and the
     complex-SSH chain (0.4 + 0.25i on real hoppings, 'auto'), update paths
     at W=1;
 27. the large-N walker path: `run_updates` on the large model ('auto' ->
     matrix-free KPM) at W=8, 1 sweep, the shared refresh from the walker
     mean (its Lanczos start vector from a stream of its own) and each
     walker's trajectory on its own; every walker's KPM must stay active,
     every solve converge and every Delta H be finite; K1 f32, K1 f64 and
     K6 launch and no plain version runs; the line gives s/sweep,
     walker-sweeps/s, the shared refresh's seconds and KPM diagnostics,
     iterations, acceptances and the diagnostics folded over the walkers;
 28. the same in the asymmetric factorization at W=2 (K7);
 29. the complex walker path: the complex chain (N=1152) at W=8 with 'kpm',
     1 sweep: K8 launches and none of K1-K4, K6, K7; then at W=2 with 'auto'
     (the doubled-basis spectral preconditioner, no kernel), 1 sweep;
 30. GPU against CPU at W=2: the KPM chain of 17 (N=1152) with the shared
     refresh and with shared_precond=False, the complex KPM chain of 22 and
     the complex-SSH chain of 26: accept flags equal, the fields to 1e-4;
 31. the measured KPM walker path: `simulate` at W=2 on the L=24 'kpm'
     chain (N_therm=1, N_measurements=2, N_bins=1, Nrv=10) on the GPU and
     the CPU: bins finite, accept flags equal, the bins to 1e-4 of each
     observable's largest magnitude; the GPU run interrupted after every
     sweep and resumed must repeat its bins bit for bit;
 32. sweep batching at full width: the measured walker path of 10a (W=8)
     with sweeps_per_dispatch=2 against the same run at k=1: accept flags
     equal, bins within 1e-5 of each observable's largest magnitude; the
     line gives the fields' relative difference, whether the runs agree
     bit for bit and both runs' s per measured sweep;
 33. a walker fleet of 2 processes of this script (`--fleet-worker`) on
     the one card, 4 walkers each (K3 at (4, 2, 240, 288), K2 and K1 f64),
     gloo for the gathers, at 32's configuration, against 32's k=1 run:
     accept flags equal, fields within 1e-6 relative, bins within 1e-5;
     each rank's launches and s per measured sweep; a failed rank fails the
     phase;
 34. kill and resume of a 2-process fleet at sweeps_per_dispatch=2 on the
     honeycomb L=3, beta=2 (W=4): runtime limit 0 leaves one checkpoint a
     process, the relaunched fleet must repeat the uninterrupted fleet's
     bins bit for bit (in memory: the card's machine has no h5py).
 35. the example twins (smoqyelphqmc_tpu_torch.examples): each twin's
     model, measurement set and configuration at its script's defaults
     (`setup`), N_therm=2, N_measurements=4, N_bins=2, through `simulate`
     with the bins in memory: holstein_honeycomb (R_cdw from the bins),
     _checkpoint, _density_tuning (final_mu) and _multiwalker (W=8: K3, K2,
     K1 f64) at L=3, beta=4, the flux chain (complex, N=8: no kernel) and
     the five SSH examples (K1, K2, K4's SSH form); every solve converged, the bins
     finite, the kernels launched and no plain version run; one line a
     twin with W, N, Ltau, s per measured sweep, acceptance, iterations and
     launches. Before them, the kernels at the twins' shapes against their
     plain versions (35a: K3 at the multiwalker tutorial's (8, 2, 80, 18),
     K1 and K2 on the bond-SSH chain's tau tables) and seven twins' models
     and configurations GPU against CPU through run_updates, 3 sweeps (35b:
     the Holstein tutorial at W=1 and W=8 and the five SSH examples;
     acceptance equal, fields within 1e-4 relative).
 36. the CDW study's twin (smoqyelphqmc_tpu_torch.physics_sweep, the port
     of scripts/physics_sweep.py: the Holstein honeycomb at alpha 1.5, W=8):
     36a, the kernels at the study's extreme shapes against their plain
     versions, with their times and tau blocks: K3 at L=6, beta=2 (8, 2, 40,
     72) and L=9, beta=10 (8, 2, 200, 162), cold and warm; K1 f32 and f64 at
     (2, 200, 162); K2 at 2 systems and at the refresh's 20 (20, 200, 162);
     36b, the twin's command line at L=9, beta=10 and L=6, beta=2 (N_therm=2,
     N_measurements=4, N_bins=2, each point's seed and W=8): K1 f64, K2 and
     K3 launch and no plain version runs, every solve converged, the bins
     finite, R_cdw and its error finite; one line a point; 36c, the L=6,
     beta=2 point's model and configuration through run_updates, 3 sweeps,
     GPU against CPU: acceptance equal, fields within 1e-4 relative.
Each path (5, 5a, 7, 10, 10a, 10b, 15, 16, 19, 20, 21, 24, 25, 27, 28,
29, 32, each rank's in 33, each twin's GPU run in 35 and 35b, and 36b-36c) is driven with every kernel count set to 0
just before it and read just after; the launches of K1, K2 and K4 in the kernels line are the
measured main path's (5a), K3's the measured walker path's (10a), those of the
tau-table entries the measured SSH path's (24), K6's those of 15 and 27,
K7's of 16 and 28, K8's of 19 and 29. Then one JSON line of kernel results,
each with its bound: the larger of the bytes it must move over 3.35 TB/s
and the operations it must do over the card's peak for their type (f32
67 TFLOP/s, f64 34 TFLOP/s, bf16 989 TFLOP/s dense; H100 SXM data sheet),
counted from this run's shapes, iteration counts and live orders (the
hopping tables as the values of each hop, one row or Ltau rows, and its
two int32 sites). As the
last line {"ok": true, "device": {...}}. Any failure exits nonzero without
that line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# A model is a dict: "model" names a function of this script or of
# models.library that takes (L, Omega, alpha, mu), "spec" its measurement set
HEADLINE = dict(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, mu=0.0, Nt=24, tol=1e-10, name="honeycomb",
                model="holstein_honeycomb_model", spec="holstein_honeycomb_spec")
# the optical-SSH honeycomb (examples/ossh_honeycomb.py:13-30) at the
# headline's (Ltau, N): 288 phonon modes, 432 SSH couplings
SSH = dict(HEADLINE, alpha=0.5, name="optical-SSH honeycomb", model="ossh_honeycomb_model", spec="basic_spec")
# the JAX package's whole-driver large-N record (scripts/e2e_scaling.py:62,68-71)
LARGE = dict(HEADLINE, L=48, alpha=1.5)
# the benchmark cells' model (benchmark/configs/holstein_honeycomb_l12_b4.json:
# the tutorial's couplings and temperature at L=12; N=288, Ltau=80)
CELL = dict(HEADLINE, beta=4.0, alpha=1.5, name="benchmark cells' honeycomb")
# the optical-SSH cell's model (benchmark/configs/ossh_honeycomb_l12_b4.json:
# the example's couplings at L=12, beta=4; N=288, Ltau=80)
SSH_CELL = dict(SSH, beta=4.0, name="optical-SSH cell")
# the complex chain of the JAX package's K8 record (scripts/kpm_cplx_ab.py:8,49,69;
# tests/test_complex_hoppings.py:32): t e^{0.7 i}, N = 1152 > 1024 sites
COMPLEX = dict(L=1152, beta=12.0, dtau=0.05, phase=0.7, alpha=0.5, Omega=1.0, mu=0.1, Nt=24, tol=1e-10,
               name="complex chain", model="complex_chain")
N_SWEEPS = 3
N_WALKERS = 8
N_WALKER_SWEEPS = 2
N_LARGE_SWEEPS = 2
# the measured runs (run_simulation): thermalization and measured sweeps,
# bins, random vectors of the Green's estimator
MEASURED = dict(N_therm=2, N_measurements=4, N_bins=2, Nrv=10)
MAIN_DEVICE = "cuda"

# H100 SXM (NVIDIA data sheet): HBM bytes/s and dense peaks (FLOP/s) by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}


def fail(msg: str, code: int = 1) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(line: str) -> None:
    print(line, flush=True)


def ptxas_summary(log: str) -> list:
    """One entry per kernel from nvcc's `-Xptxas -v` log: the mangled entry
    name less its anonymous-namespace prefix (kernel name and template
    arguments first), its registers and its spill stores / loads."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name, spill = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", mangled)[:40], ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spill}")
    return out


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


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time of fn over reps launches captured in one CUDA graph
    (CUDA events around its replays): the kernel's own time where the host's
    launch cost would exceed it, as it does for K1 at the headline."""
    import torch

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


def bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of nbytes over the HBM rate and the
    operations {type: count} over their peaks."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def b_flops(n_colors: int, symmetric: bool) -> int:
    """Operations per site of one propagator application B: each color is
    C u + S u[partner] (3), the diagonal one multiply; the symmetric B sweeps
    the colors twice."""
    return (2 if symmetric else 1) * 3 * n_colors + 1


def table_bytes(fdm, es: int) -> int:
    """The hopping data a checkerboard product needs: each hop's cosh and
    sinh (and the sinh of its imaginary part for complex hoppings) in es
    bytes, one row, or Ltau rows for tau-dependent hoppings (SSH), and the
    neighbour table's two int32 sites a hop. The kernels' per-site tables
    hold each hop's values once for each of its sites; that layout is not
    counted."""
    rows = 1 if fdm.static_hops else fdm.Ltau
    n_vals = 2 if fdm.cb.S_im is None else 3
    return fdm.structure.n_hops * (n_vals * es * rows + 2 * 4)


def mtm_bound(fdm, n_sys, es):
    """K1 (and K5): v in, out once, expV and the hopping data; two B
    applications and four multiply-adds per site of each row."""
    Ltau, N = fdm.Ltau, fdm.n_sites
    ops = n_sys * Ltau * N * (2 * b_flops(fdm.cb.n_colors, True) + 4)
    nbytes = es * (2 * n_sys * Ltau * N + Ltau * N) + table_bytes(fdm, es)
    return bound(nbytes, {"f32" if es == 4 else "f64": ops})


def pcg_iteration_ops(Ltau, N, n_colors, symmetric=True):
    """One CG iteration of one (Ltau, N) system in K2 / K3: M^T M and ten
    vector operations per element in f32; the half-spectrum preconditioner's
    four products in bf16 (DFT rows, Q, Q^T, inverse DFT) and its filter."""
    Lh = Ltau // 2 if Ltau % 2 == 0 else Ltau
    f32 = Ltau * N * (2 * b_flops(n_colors, symmetric) + 4 + 10) + 2 * Lh * N
    bf16 = 2 * (2 * Lh) * Ltau * N * 2 + 2 * (2 * Lh) * N * N * 2
    return f32, bf16


def precond_bytes(Ltau, N):
    Lh = Ltau // 2 if Ltau % 2 == 0 else Ltau
    return 2 * N * N + 2 * (2 * Lh) * Ltau + 4 * Lh * N


def epilogue_ops(Ltau, N, n_colors):
    """The force epilogue per channel pair: per channel and site one B, B^T
    (for M^T A), CB^T and CB^{-1} (3 n_colors each) and ~10 products and sums."""
    return 2 * Ltau * N * (2 * b_flops(n_colors, True) + 6 * n_colors + 10)


def model_of(h, L=None):
    """(geometry, tbm, em) of model h at L (h's own L by default)."""
    from smoqyelphqmc_tpu_torch.models import library

    make_model = globals().get(h["model"]) or getattr(library, h["model"])
    return make_model(h["L"] if L is None else L, h["Omega"], h["alpha"], h["mu"])


def spec_of(h, geo, tbm):
    """Model h's measurement set: the Holstein tutorial's, or the SSH
    examples' `basic_spec` on the model's bonds."""
    from smoqyelphqmc_tpu_torch.models import library

    if h["spec"] == "basic_spec":
        return library.basic_spec(geo, bond_ids=list(tbm.bond_ids))
    return getattr(library, h["spec"])(geo)


def headline_model(device, h=HEADLINE):
    """Model h's expanded parameters (seed 0): (tbp, elph)."""
    import numpy as np

    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters

    geo, tbm, em = model_of(h)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    return tbp, ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=device)


def headline_fdm(device, neighbor_table=None, x=None, h=HEADLINE, symmetric=True):
    """A model's fermion matrix (f64, the headline model by default) at field
    x (default: the initial field; (W, n_phonon, Ltau) gives a walker batch),
    optionally on a relabelled hopping graph."""
    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix

    tbp, elph = headline_model(device, h)
    nt = tbp.neighbor_table if neighbor_table is None else neighbor_table
    structure = build_checkerboard_structure(nt, tbp.n_sites)
    return FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph, x), structure, symmetric=symmetric)


def phase_k1(fdm64, results, tag="K1", names=("mtm_f32", "mtm_f64"),
             replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:121"):
    """K1 against its plain version on fdm64's tables in f32 and f64, v (2,
    Ltau, N). `ms` is the device's time per launch (a CUDA graph of 50
    launches); the line also gives the eager caller's (CUDA events over 50
    launches from Python), the launch's form and T. With names=None the
    results are printed only (the L=48 shapes)."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm

    gen = torch.Generator(device="cpu").manual_seed(11)
    for dtype, tol, name in ((torch.float32, 2e-6, names and names[0]), (torch.float64, 1e-12, names and names[1])):
        fdm = fdm64.astype(dtype)
        v = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float64).to(fdm.device, dtype)
        got = mtm.mtm_cuda(fdm, v)
        ref = mtm.mtm_plain(fdm, v)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = graph_ms(lambda: mtm.mtm_cuda(fdm, v), 50)
        eager_ms = cuda_ms(lambda: mtm.mtm_cuda(fdm, v), 50)
        plain_ms = cuda_ms(lambda: mtm.mtm_plain(fdm, v), 20)
        bound_ms, bound_by = mtm_bound(fdm, v.shape[0], v.element_size())
        shape = mtm.launch_shape(fdm, v.shape[0])
        say(f"{tag} {name or str(dtype).split('.')[-1]} ({'symmetric' if fdm.symmetric else 'asymmetric'}): shape "
            f"{tuple(v.shape)} max_rel_err {rel:.3e} (tol {tol:g}) kernel {ms:.4f} ms (eager call {eager_ms:.4f}) "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.5f} ms by {bound_by}; T {shape['tau_block']}, "
            f"{shape['threads']} threads, form {shape['form']}, grid {shape['grid']}, {shape['smem']} bytes")
        if not rel <= tol:
            fail(f"{tag} {name or dtype} disagrees with its plain version: {rel:.3e} > {tol:g}")
        if name:
            results[name] = dict(name=name, route="cuda", source="smoqyelphqmc_tpu_torch/csrc/mtm.cu",
                                 replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)


def phase_k1_large():
    """K1 at the large-N path's shape (2, 240, 4608), both factorizations,
    f32 and f64, on the large model's tables (large_model_kpm's fermion
    matrix), each on its own line with its bound."""
    import torch

    for symmetric in (True, False):
        phase_k1(headline_fdm(torch.device("cuda"), h=LARGE, symmetric=symmetric), {}, tag="K1 L=48", names=None)


def phase_k2(fdm64, results, key="pcg"):
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

    tag = ("K2" if fdm32.symmetric else "K2 asymmetric") + ("" if fdm32.static_hops else " SSH tables")
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
    for run, xk_, ek_, ik_, xp_, ep_, ip_ in rows:
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
        say(f"{tag} {run}: converged kernel {conv_k} plain {conv_p}; iters kernel {int(ik_)} "
            f"plain {int(ip_)}; true residual kernel {res_k:.3e} plain {res_p:.3e}; max|x| {scale:.4g}; "
            f"max |x_kernel - x_plain| {err:.3e} (rtol 2e-4, atol 2e-5 max|x|: {bound_ok})")
        if not (conv_k and conv_p):
            fail(f"{tag} {run} solve did not converge (kernel {conv_k}, plain {conv_p})")
        if not bound_ok:
            fail(f"{tag} {run} solve: kernel and plain solutions differ beyond the tolerance")
        if not res_k <= max(2 * tol, 2 * res_p):
            fail(f"{tag} {run} solve: true residual {res_k:.3e} of the kernel's solution exceeds the plain one's")
    ms = cuda_ms(lambda: pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter), 5)
    plain_ms = cuda_ms(lambda: pcg.pcg_plain(fdm32, pre, bu, tol, maxiter), 2)
    lib = pcg._build.load_library()
    lib_grid = lib.smoqy_pcg_grid(fdm32.n_sites)
    # grid-wide syncs per iteration: the waits among the timed instantiation's phases
    syncs = sum(name.startswith("sync") for name in lib.smoqy_pcg_phases().decode().split(","))
    # the timed cold solve: its iterations for each system, b in, x out, the
    # preconditioner's operands and the tables read once
    Ltau, N, nc = fdm32.Ltau, fdm32.n_sites, fdm32.cb.n_colors
    f32_it, bf16_it = pcg_iteration_ops(Ltau, N, nc, fdm32.symmetric)
    n_it = int(rows[0][3]) * bu.shape[0]
    bound_ms, bound_by = bound(4 * (2 * bu.numel() + Ltau * N) + precond_bytes(Ltau, N)
                               + table_bytes(fdm32, 4),
                               {"f32": n_it * f32_it, "bf16": n_it * bf16_it})
    say(f"{tag} cold solve time: kernel {ms:.3f} ms plain {plain_ms:.3f} ms (grid {lib_grid} CTAs); "
        f"{int(rows[0][3])} iterations, {1e3 * ms / max(int(rows[0][3]), 1):.2f} us each, {syncs} grid syncs "
        f"each; bound {bound_ms:.4f} ms by {bound_by}")
    results[key] = dict(name=key, route="cuda", source="smoqyelphqmc_tpu_torch/csrc/pcg.cu",
                          replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:495",
                          max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          iters=int(rows[0][3]))


def phase_k2_estimator(results, h=HEADLINE, two="pcg"):
    """K2 at the estimator refresh's shape: the 2 Nrv = 20 systems M^T R of
    (Nrv, 2, 240, 288) random-phase vectors R, each scaled to unit norm as
    SpectralPCG scales them, at the refresh's tolerance 2e-5, against its
    plain version, on the tables of model h at its initial field (with SSH
    couplings, Ltau rows that differ); its time per launch beside the
    2-system solve's (results[two])."""
    import math

    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm, pcg
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    fdm64 = headline_fdm(torch.device("cuda"), h=h)
    pre = build_spectral(fdm64)
    fdm32 = fdm64.astype(torch.float32)
    tag = "K2 estimator refresh" + ("" if fdm32.static_hops else " SSH tables")
    Nrv, Ltau, N, nc = MEASURED["Nrv"], fdm32.Ltau, fdm32.n_sites, fdm32.cb.n_colors
    gen = torch.Generator(device="cpu").manual_seed(20)
    theta = 2.0 * math.pi * torch.rand((Nrv, Ltau, N), generator=gen, dtype=torch.float64)
    R = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1).to("cuda", torch.float32)
    b = fdm32.mul_Mt(R).reshape(2 * Nrv, Ltau, N)
    bu = (b / torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True)).contiguous()
    tol, maxiter = 2e-5, 10_000
    xk, ek, ik = pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter)
    xp, ep, ip = pcg.pcg_plain(fdm32, pre, bu, tol, maxiter)
    torch.cuda.synchronize()
    conv_k, conv_p = (bool(torch.isfinite(x_).all()) and bool((e_ < tol).all()) for x_, e_ in ((xk, ek), (xp, ep)))
    res_k, res_p = (float((torch.linalg.vector_norm(bu - mtm.mtm_plain(fdm32, xx), dim=(1, 2))).max())
                    for xx in (xk, xp))
    # two solves that stop on the residual tolerance 2e-5 part by what that
    # tolerance leaves free, which at this shape's conditioning is far above
    # the elementwise bound phase_k2 applies at 1e-5 to normal right-hand
    # sides: held per system, relative in the 2-norm, to 25 tol
    rel = float((torch.linalg.vector_norm(xk - xp, dim=(1, 2)) / torch.linalg.vector_norm(xp, dim=(1, 2))).max())
    ok = rel <= 25 * tol
    ms = cuda_ms(lambda: pcg.pcg_cuda(fdm32, pre, bu, tol, maxiter), 5)
    plain_ms = cuda_ms(lambda: pcg.pcg_plain(fdm32, pre, bu, tol, maxiter), 1)
    f32_it, bf16_it = pcg_iteration_ops(Ltau, N, nc)
    n_it = int(ik) * bu.shape[0]
    bound_ms, bound_by = bound(4 * (2 * bu.numel() + Ltau * N) + precond_bytes(Ltau, N) + table_bytes(fdm32, 4),
                               {"f32": n_it * f32_it, "bf16": n_it * bf16_it})
    two = results[two]
    say(f"{tag} ({2 * Nrv}, {Ltau}, {N}) f32, tol {tol:g}: converged kernel {conv_k} plain {conv_p}; "
        f"iters kernel {int(ik)} plain {int(ip)}; true residual kernel {res_k:.3e} plain {res_p:.3e}; per-system "
        f"|x_kernel - x_plain| / |x_plain| max {rel:.3e} (tol {25 * tol:g}: {ok}); kernel "
        f"{ms:.3f} ms per launch, {1e3 * ms / max(int(ik), 1):.2f} us per iteration (2 systems: {two['ms']:.3f} ms, "
        f"{two['iters']} iterations, {1e3 * two['ms'] / max(two['iters'], 1):.2f} us each) plain {plain_ms:.3f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    if not (conv_k and conv_p):
        fail(f"{tag} did not converge (kernel {conv_k}, plain {conv_p})")
    if not ok:
        fail(f"{tag}: kernel and plain solutions differ beyond the tolerance")
    if not res_k <= max(2 * tol, 2 * res_p):
        fail(f"{tag}: true residual {res_k:.3e} exceeds the plain one's")


def all_counters():
    """Every kernel's launch / plain-call counter, by the kernel's JSON name."""
    import torch

    from smoqyelphqmc_tpu_torch.ops.force import FORCE
    from smoqyelphqmc_tpu_torch.ops.kpm_mf import KPM_MF, KPM_MF_ASYM, KPM_MF_CPLX
    from smoqyelphqmc_tpu_torch.ops.mtm import MTM
    from smoqyelphqmc_tpu_torch.ops.pcg import PCG
    from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE

    return {"mtm_f32": MTM[torch.float32], "mtm_f64": MTM[torch.float64], "pcg": PCG,
            "pcg_force": PCG_FORCE, "force": FORCE, "kpm_mf": KPM_MF, "kpm_mf_asym": KPM_MF_ASYM,
            "kpm_mf_cplx": KPM_MF_CPLX}


def drive_path(run, path_kernels, only=False):
    """Run one path with every count set to 0 just before it and read just
    after; fail if a kernel of the path never launched, if a plain version
    ran, or (only=True) if a kernel off the path launched.
    Returns (run's result, {name: (launches, plain calls)})."""
    counters = all_counters()
    for c in counters.values():
        c.reset()
    out = run()
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    for k in path_kernels:
        if counts[k][0] <= 0:
            fail(f"kernel {k} never launched on its path")
    for k, (launches, _) in counts.items():
        if only and k not in path_kernels and launches != 0:
            fail(f"kernel {k} launched {launches} times on a path that must not reach it")
    for k, (_, plain) in counts.items():
        if plain != 0:
            fail(f"the plain version of {k} ran {plain} times on a path")
    return out, counts


def headline_config(h=HEADLINE, **kw):
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig

    opts = dict(beta=h["beta"], dtau=h["dtau"], Nt=h["Nt"], tol=h["tol"], seed=1, mixed_precision=True,
                force_dtype="float32", preconditioner="spectral")
    return SimulationConfig(**{**opts, **kw})


def phase_main(results, card):
    import math

    from smoqyelphqmc_tpu_torch.driver import run_updates

    h = HEADLINE
    geo, tbm, em = model_of(h)
    md, counts = drive_path(lambda: run_updates(tbm, em, headline_config(), N_SWEEPS, device=MAIN_DEVICE),
                            ("mtm_f32", "mtm_f64", "pcg", "force"))
    for k in ("mtm_f32", "mtm_f64", "pcg"):
        results[k]["launches"] = counts[k][0]
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
    x = md["x_final"]
    if tuple(x.shape) != (2 * h["L"] ** 2, md["Ltau"]) or not bool(x.isfinite().all()):
        fail(f"final field has shape {tuple(x.shape)} or non-finite values")


def rounded(v, nd=6):
    if isinstance(v, dict):
        return {k: rounded(u, nd) for k, u in v.items()}
    return [rounded(u, nd) for u in v] if isinstance(v, list) else round(v, nd)


def phase_small_reference(n_walkers=1, L=3, beta=2.0, preconditioner="spectral", h=HEADLINE, **kw):
    """The same chain on model h at L on the GPU (kernels) and the CPU (plain
    versions): the accept decisions must match and the fields agree to 1e-4
    relative (the f32 force solves stop at 1e-5 relative in both, with sums in
    another order, so forces may differ at that level); the GPU takes the
    trajectory forces through K4 where it applies, the CPU the eager chain;
    `kw` sets other config fields (shared_precond)."""
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    geo, tbm, em = model_of(h, L)
    cfg = SimulationConfig(beta=beta, dtau=0.1, Nt=12, seed=5, preconditioner=preconditioner, n_walkers=n_walkers,
                           **kw)
    t0 = time.perf_counter()
    gpu = run_updates(tbm, em, cfg, 3, device="cuda")
    t1 = time.perf_counter()
    cpu = run_updates(tbm, em, cfg, 3, device="cpu")
    t2 = time.perf_counter()
    xg, xc = gpu["x_final"].cpu(), cpu["x_final"]
    err = float((xg - xc).abs().max() / xc.abs().max())
    same = all(gpu[f"{k}_acceptance_rate"] == cpu[f"{k}_acceptance_rate"] for k in ("reflection", "swap", "hmc"))
    kpm = {d: md.get("kpm_active") for d, md in (("gpu", gpu), ("cpu", cpu))}
    model = h["name"] + "".join(f", {k}={v}" for k, v in kw.items())
    say(f"small-model reference ({model} L={L}, N={gpu['n_sites']}, beta={beta}, {preconditioner}, W={n_walkers}): "
        f"GPU vs "
        f"CPU field max rel err {err:.3e}; same acceptance {same}; dH gpu {rounded(gpu['hmc_delta_H'])} "
        f"cpu {rounded(cpu['hmc_delta_H'])}; hmc iters/solve gpu {gpu['hmc_iters']:.2f} cpu {cpu['hmc_iters']:.2f}; "
        f"kpm_active {kpm}; {t1 - t0:.1f} s GPU, {t2 - t1:.1f} s CPU")
    if not (same and err <= 1e-4 and gpu["all_converged"] and cpu["all_converged"]):
        fail(f"the GPU chain disagrees with the CPU reference on the small model ({model} L={L}, "
             f"{preconditioner}, W={n_walkers})")
    if n_walkers > 1:
        dH = [(g, c) for gw, cw in zip(gpu["hmc_delta_H"], cpu["hmc_delta_H"]) for g, c in zip(gw, cw)]
        say(f"  walkers converged gpu {gpu['walker_converged']} cpu {cpu['walker_converged']}; fallback sweeps gpu "
            f"{gpu['precond_fallback_sweeps']} cpu {cpu['precond_fallback_sweeps']}; KPM inactive walkers gpu "
            f"{gpu.get('kpm_inactive_walkers')} cpu {cpu.get('kpm_inactive_walkers')}; dH max abs diff "
            f"{max(abs(g - c) for g, c in dH):.3e}")
    if preconditioner == "kpm" and kpm != {"gpu": True, "cpu": True}:
        fail(f"the KPM preconditioner of the GPU-vs-CPU chain deactivated: {kpm}")


NAN_GLOBALS = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn", "action_fermionic", "action_total"}


def simulate_in_memory(sim_info, tbm, em, spec, cfg, device):
    """Drive `driver.simulate` (run_simulation's loop: sweeps, estimator
    refreshes, measurement passes, bins, checkpoints) to its end with the bins
    kept in memory: the card's machine has no h5py, so run_simulation's HDF5
    writing and post-processing are held on the CPU by the tests. Returns
    ({bin key: bin tree}, metadata, finished); a bin's key is its index at
    W = 1 and (pID, index) for each walker at W >= 2."""
    from smoqyelphqmc_tpu_torch.driver import simulate

    bins = {}
    run = simulate(sim_info, tbm, em, spec, cfg, device=device)
    while True:
        try:
            item = next(run)
        except StopIteration as done:
            return bins, *done.value
        bins[item[0] if len(item) == 2 else item[:2]] = item[-1]


def bin_leaves(bins):
    """{(bin key, category, name): complex values} of in-memory bins."""
    import numpy as np

    return {(k, cat, name): np.asarray(re) + 1j * np.asarray(im)
            for k, tree in bins.items() for cat, d in tree.items() for name, (re, im) in d.items()}


def check_bins(bins, n_bins, tag, n_walkers=1):
    """Fail unless n_bins bins (of each walker) came out and every value is
    finite except the six NaN globals. Returns bin_leaves(bins)."""
    import numpy as np

    leaves = bin_leaves(bins)
    bad = [k for k, v in leaves.items() if not (np.all(np.isnan(v.real)) if k[2] in NAN_GLOBALS
                                                else np.all(np.isfinite(v)))]
    want = list(range(n_bins)) if n_walkers == 1 else [(p, b) for p in range(n_walkers) for b in range(n_bins)]
    if sorted(bins) != want or bad:
        fail(f"{tag}: bins {sorted(bins)} of {want}, values not finite (or a NaN global not NaN): {bad[:5]}")
    return leaves


def bins_rel_diff(leaves, ref_leaves) -> float:
    """The largest difference of two runs' bin leaves, each over its
    observable's largest magnitude in ref_leaves (the NaN globals left out)."""
    import numpy as np

    worst = 0.0
    for k, ref in ref_leaves.items():
        if k[2] not in NAN_GLOBALS:
            worst = max(worst, float(np.max(np.abs(leaves[k] - ref)) / max(float(np.max(np.abs(ref))), 1e-300)))
    return worst


def same_bins(leaves, ref_leaves) -> bool:
    """Whether two runs' bin leaves are equal bit for bit (NaN where NaN)."""
    import numpy as np

    return set(leaves) == set(ref_leaves) and all(np.array_equal(leaves[k], v, equal_nan=True)
                                                  for k, v in ref_leaves.items())


def measured_config(h=HEADLINE, **kw):
    return headline_config(h, measurement_dtype="float32", **{**MEASURED, **kw})


def phase_measured(results, card):
    """The measured main path: run_simulation's loop (`simulate`) on the
    headline model with the tutorial measurement set (Nrv=10, f32
    measurements) into a fresh folder, the bins in memory; K1, K2 and K4
    must launch and no plain version run. Returns the path's counts."""
    import tempfile

    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    h = HEADLINE
    geo, tbm, em = model_of(h)
    spec = spec_of(h, geo, tbm)
    cfg = measured_config()
    with tempfile.TemporaryDirectory() as tmp:
        info = SimulationInfo(filepath=tmp, datafolder_prefix="measured", sID=1)
        t0 = time.perf_counter()
        (bins, md, finished), counts = drive_path(lambda: simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE),
                                                  ("mtm_f32", "mtm_f64", "pcg", "force"))
        wall = time.perf_counter() - t0
        summary = os.path.exists(os.path.join(info.datafolder, "model_summary.toml"))
    check_bins(bins, cfg.N_bins, "the measured main path")
    for k in ("mtm_f32", "mtm_f64", "pcg"):
        results[k]["launches"] = counts[k][0]
    n_meas = md["n_measure_timed"]
    density = [round(float(bins[k]["global"]["density"][0]), 6) for k in sorted(bins)]
    say(f"measured main path on {card}: simulate L={h['L']} beta={h['beta']} N_therm={cfg.N_therm} "
        f"N_measurements={cfg.N_measurements} N_bins={cfg.N_bins} Nrv={cfg.Nrv} f32 measurements; acceptance refl "
        f"{md['reflection_acceptance_rate']:.3f} swap {md['swap_acceptance_rate']:.3f} hmc "
        f"{md['hmc_acceptance_rate']:.3f}; iters/solve refl {md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} "
        f"hmc {md['hmc_iters']:.2f} measurement {md['measurement_iters']:.2f}; s per measured sweep "
        f"{md['t_measure_s'] / n_meas:.4f} (first {md['t_first_measured_sweep_s']:.3f}, {n_meas} sweeps "
        f"{md['t_measure_s']:.3f} s; thermalization {md['t_therm_s']:.3f} s for {md['n_therm_timed']}); estimator "
        f"refresh {md['t_refresh_s']:.4f} s, share {md['t_refresh_s'] / md['t_measure_s']:.4f}; measurement passes "
        f"{md['t_measurements_s']:.4f} s, share {md['t_measurements_s'] / md['t_measure_s']:.4f}; density per bin "
        f"{density}; all converged {md['all_converged']}; wall {wall:.2f} s; launches/plain calls {counts}")
    if not (finished and summary and md["all_converged"]):
        fail(f"the measured main path did not finish, write its model summary or converge ({finished}, {summary}, "
             f"{md['all_converged']})")
    return counts


class SweepSpy:
    """Records the accept flags of every sweep the driver runs, in the order
    the updates ran (`driver.walker_sweep`, at every W: one tuple a walker),
    each sweep's HMC Delta H (a list, one a walker) and the last sweep's
    fields (a CPU copy, (W, n_phonon, Ltau)), by wrapping it while the block
    runs."""

    def __enter__(self):
        from smoqyelphqmc_tpu_torch import driver

        self.flags, self.dH, self.x, self._orig = [], [], None, driver.walker_sweep

        def spy(*args, **kw):
            states, st = self._orig(*args, **kw)
            self.flags.append(tuple(tuple(bool(u.accepted) for u in ups) for ups in st))
            self.dH.append([h.delta_H for h in st.hmc])
            self.x = states.x.cpu().clone()
            return states, st

        driver.walker_sweep = spy
        return self

    def __exit__(self, *exc):
        from smoqyelphqmc_tpu_torch import driver

        driver.walker_sweep = self._orig


def phase_measured_small_reference(L=3, beta=2.0, h=HEADLINE, **kw):
    """The measured run (`simulate`, bins in memory) on a small honeycomb on
    the GPU and on the CPU (plain versions): the accept flags of every sweep
    must be equal and the bins agree to 1e-4 of each observable's largest
    magnitude; then the GPU run interrupted after every sweep until its first
    bins are out (runtime limit 0: one sweep and a checkpoint a call), and
    resumed to the end, must give the uninterrupted run's bins bit for bit.
    `kw` sets config fields (n_walkers and the sampler options); with mu
    tuning and dt targeting the resumed run's final mu and dt must be the
    uninterrupted run's too. h is the model (the Holstein honeycomb with
    the tutorial set by default) and its measurement set."""
    import dataclasses
    import tempfile

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    geo, tbm, em = model_of(h, L)
    spec = spec_of(h, geo, tbm)
    cfg = SimulationConfig(**{**dict(beta=beta, dtau=0.1, Nt=12, seed=5, preconditioner="spectral"), **MEASURED, **kw})
    W = cfg.n_walkers
    with tempfile.TemporaryDirectory() as tmp:
        def info(prefix):
            return SimulationInfo(filepath=tmp, datafolder_prefix=prefix, sID=1)

        t0 = time.perf_counter()
        runs = {}
        for dev in ("cuda", "cpu"):
            with SweepSpy() as spy:
                bins, md, _ = simulate_in_memory(info(dev), tbm, em, spec, cfg, dev)
            runs[dev] = (md, spy.flags, check_bins(bins, cfg.N_bins, f"the small measured run ({dev})", W))
        t1 = time.perf_counter()
        stop = dataclasses.replace(cfg, runtime_limit_hours=0.0)
        resumed, n_runs, finished = {}, 0, False
        while not resumed and n_runs < cfg.N_therm + cfg.N_measurements:
            bins, _, finished = simulate_in_memory(info("interrupted"), tbm, em, spec, stop, "cuda")
            resumed.update(bins)
            n_runs += 1
        bins, rmd, finished = simulate_in_memory(info("interrupted"), tbm, em, spec, cfg, "cuda")
        resumed.update(bins)
        t2 = time.perf_counter()
    (gmd, gflags, gleaves), (cmd, cflags, cleaves) = runs["cuda"], runs["cpu"]
    worst = bins_rel_diff(gleaves, cleaves)
    same_bits = same_bins(bin_leaves(resumed), gleaves)
    controls = [k for k in ("final_mu", "final_mu_per_walker", "hmc_dt_final") if k in gmd]
    same_controls = all(rmd.get(k) == gmd[k] for k in controls)
    opts = {k: v for k, v in kw.items()}
    say(f"measured small reference ({h['name']} L={L}, N={geo.n_sites}, beta={beta}, Nrv={cfg.Nrv}, {opts}): accept "
        f"flags gpu {gflags} cpu {cflags}; bins max rel diff {worst:.3e} (tol 1e-4); measurement iters gpu "
        f"{gmd['measurement_iters']:.2f} cpu {cmd['measurement_iters']:.2f}; "
        + "".join(f"{k} gpu {rounded(gmd[k], 8)} cpu {rounded(cmd[k], 8)}; " for k in controls)
        + f"interrupted {n_runs} times until the first bins, resumed bins bit-identical {same_bits}, "
        f"{', '.join(controls) or 'no controls'} identical {same_controls}; {t1 - t0:.1f} s GPU + CPU, "
        f"{t2 - t1:.1f} s resume")
    if gflags != cflags or not gflags:
        fail("the measured GPU chain's accept flags differ from the CPU reference's")
    if not (worst <= 1e-4 and gmd["all_converged"] and cmd["all_converged"]):
        fail("the measured GPU run's bins disagree with the CPU reference (or a solve did not converge)")
    if not (finished and n_runs > 1 and same_bits and same_controls):
        fail("the resumed GPU run's bins (or its final mu / dt) are not bit-identical to the uninterrupted run's")


def phase_measured_walkers(results, card, tag, **kw):
    """The measured walker path: `simulate` at W = N_WALKERS on the headline
    with the tutorial measurement set (Nrv=10, f32 measurements), the bins in
    memory; K1 f64, K2 and K3 must launch and no plain version run. `kw`
    sets the sampler options; with them the line gives each walker's mu and
    the shared dt after every tuner / timestep update. Returns the path's
    launch counts."""
    import csv
    import math
    import tempfile

    from smoqyelphqmc_tpu_torch import driver
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    h = HEADLINE
    W = N_WALKERS
    geo, tbm, em = model_of(h)
    spec = spec_of(h, geo, tbm)
    cfg = measured_config(n_walkers=W, **kw)
    dts, law = [], driver.dt_law

    def spy_law(*args):
        dts.append(law(*args))
        return dts[-1]

    driver.dt_law = spy_law
    try:
        with tempfile.TemporaryDirectory() as tmp:
            info = SimulationInfo(filepath=tmp, datafolder_prefix="measured_walkers", sID=1)
            t0 = time.perf_counter()
            (bins, md, finished), counts = drive_path(
                lambda: simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE), ("mtm_f64", "pcg", "pcg_force"))
            wall = time.perf_counter() - t0
            mus = []
            for w in range(W):
                path = os.path.join(info.datafolder, f"density_tuning_profile_pID-{w}.csv")
                if os.path.exists(path):
                    with open(path) as f:
                        mus.append([round(float(r["mu"]), 5) for r in csv.DictReader(f, delimiter=" ")])
    finally:
        driver.dt_law = law
    check_bins(bins, cfg.N_bins, f"the measured walker path ({tag})", W)
    n_meas = md["n_measure_timed"]
    per_sweep = md["t_measure_s"] / n_meas
    density = [[round(float(bins[(w, b)]["global"]["density"][0]), 5) for b in range(cfg.N_bins)] for w in range(W)]
    controls = ""
    if kw:
        controls = (f"; mu per walker after each tuner update {mus}; dt after each thermalization sweep "
                    f"{[round(d, 6) for d in dts]} (dt0 {math.pi / (2 * cfg.Nt):.6f}, final {md.get('hmc_dt_final')}); "
                    f"acceptance radial {md['radial_acceptance_rate']:.3f}")
    say(f"measured walker path ({tag}) on {card}: simulate W={W} L={h['L']} beta={h['beta']} N_therm={cfg.N_therm} "
        f"N_measurements={cfg.N_measurements} N_bins={cfg.N_bins} Nrv={cfg.Nrv} Nt={cfg.Nt} {cfg.hmc_integrator}; "
        f"s per measured W={W} sweep {per_sweep:.4f}, walker-measured-sweeps/s {W / per_sweep:.3f} (first "
        f"{md['t_first_measured_sweep_s']:.3f}, {n_meas} sweeps {md['t_measure_s']:.3f} s; thermalization "
        f"{md['t_therm_s']:.3f} s for {md['n_therm_timed']}); estimator refreshes {md['t_refresh_s']:.4f} s, share "
        f"{md['t_refresh_s'] / md['t_measure_s']:.4f}; measurement passes {md['t_measurements_s']:.4f} s, share "
        f"{md['t_measurements_s'] / md['t_measure_s']:.4f}; acceptance refl {md['reflection_acceptance_rate']:.3f} "
        f"swap {md['swap_acceptance_rate']:.3f} hmc {md['hmc_acceptance_rate']:.3f}; iters/solve refl "
        f"{md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f} measurement "
        f"{md['measurement_iters']:.2f}; precond_fallback_sweeps {md['precond_fallback_sweeps']}; density per walker "
        f"and bin {density}; all converged {md['all_converged']}{controls}; wall {wall:.2f} s; launches/plain calls "
        f"{counts}")
    if not (finished and md["all_converged"]):
        fail(f"the measured walker path ({tag}) did not finish or converge ({finished}, {md['all_converged']})")
    if kw.get("target_density") is not None and len(mus) != W:
        fail(f"the measured walker path ({tag}) wrote {len(mus)} density-tuning profiles for {W} walkers")
    return counts


def phase_k3(results, h=HEADLINE):
    """K3 on N_WALKERS jittered fields of model h (per-walker expV and
    Lambda, one shared preconditioner) against its plain version, cold and
    warm; at the headline its times and bound go into results, on another
    model (results None) the check and the launch's shape only."""
    import dataclasses

    import torch

    from smoqyelphqmc_tpu_torch.ops import pcg_force
    from smoqyelphqmc_tpu_torch.ops.derivatives import build_force_plan, holstein_force_from_planes
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda, ldiv_lambda_T
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    tol, maxiter, W = 1e-5, 500, N_WALKERS
    dev = torch.device("cuda")
    tbp, elph = headline_model(dev, h)
    gen = torch.Generator(device="cpu").manual_seed(13)
    xs = elph.x[None] + 0.1 * torch.randn((W,) + tuple(elph.x.shape), generator=gen, dtype=torch.float64).to(dev)
    fdm = headline_fdm(dev, x=xs, h=h)
    pre = build_spectral(dataclasses.replace(fdm, exp_nV=fdm.exp_nV.mean(dim=0)))
    fdm32 = dataclasses.replace(fdm, exp_nV=fdm.exp_nV[:, None]).astype(torch.float32)
    Lam = build_lambda(elph, xs, tbp.n_sites).to(torch.float32)
    Phi = torch.randn((W, 2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to(dev)
    b = ldiv_lambda_T(Lam[:, None], Phi).contiguous()
    plan = build_force_plan(elph, fdm.structure)
    nb = torch.linalg.vector_norm(b, dim=(-2, -1))

    def force(P1, P2):
        return holstein_force_from_planes(P1.double(), P2.double(), elph, xs, Lam.double(), plan)

    def true_res(x):
        return float((torch.linalg.vector_norm(b - fdm32.mul_Mt(fdm32.mul_M(x)), dim=(-2, -1)) / nb).max())

    x_warm, *_ = pcg_force.pcg_force_plain(fdm32, pre, b, torch.zeros_like(b), Lam, 1e-3, maxiter, True)
    launch = pcg_force.launch_shape(fdm32, 2 * W)
    shape = f"{h['name']} {tuple(b.shape)}"
    say(f"K3 on the {shape}: tau blocks of {launch['tau_block']} rows, grid {launch['grid']} CTAs, "
        f"{launch['smem']} bytes of shared memory")
    max_err = 0.0
    iters = {}
    for tag, x0 in (("cold", torch.zeros_like(b)), ("warm", x_warm)):
        xk, P1k, P2k, sk = pcg_force.solve_force(fdm32, pre, b, Lam, x0=x0, tol=tol, maxiter=maxiter)
        xp, P1p, P2p, ep, ip = pcg_force.pcg_force_plain(fdm32, pre, b, x0, Lam, tol, maxiter, True)
        torch.cuda.synchronize()
        conv_k = bool(sk.converged.all())
        conv_p = bool(torch.isfinite(xp).all()) and bool((ep < tol).all())
        diff = (xk - xp).abs()
        err = float(diff.max())
        scale = float(xp.abs().max())
        x_ok = bool((diff <= 2e-5 * scale + 2e-4 * xp.abs()).all())
        Fk, Fp = force(P1k, P2k), force(P1p, P2p)
        f_err = float((Fk - Fp).abs().max())
        f_ok = bool(((Fk - Fp).abs() <= 2e-4 * float(Fp.abs().max()) + 2e-4 * Fp.abs()).all())
        res_k, res_p = true_res(xk), true_res(xp)
        max_err = max(max_err, err)
        iters[tag] = sk.iters.tolist()
        say(f"K3 {tag} {shape}: converged kernel {conv_k} plain {conv_p}; iters/walker kernel "
            f"{sk.iters.tolist()} plain {ip.tolist()}; true residual kernel {res_k:.3e} plain {res_p:.3e}; "
            f"max|x| {scale:.4g} max |x_kernel - x_plain| {err:.3e} (rtol 2e-4, atol 2e-5 max|x|: {x_ok}); "
            f"force max|F| {float(Fp.abs().max()):.4g} max diff {f_err:.3e} (rtol 2e-4, atol 2e-4 max|F|: {f_ok})")
        if not (conv_k and conv_p):
            fail(f"K3 {tag} solve did not converge (kernel {conv_k}, plain {conv_p})")
        if not (x_ok and f_ok):
            fail(f"K3 {tag}: kernel and plain solutions or forces differ beyond the tolerance")
        if not res_k <= max(2 * tol, 2 * res_p):
            fail(f"K3 {tag}: true residual {res_k:.3e} of the kernel's solution exceeds the plain one's")
    if results is None:
        return
    zeros = torch.zeros_like(b)
    ms = cuda_ms(lambda: pcg_force.solve_force(fdm32, pre, b, Lam, x0=zeros, tol=tol, maxiter=maxiter), 3)
    warm_ms = cuda_ms(lambda: pcg_force.solve_force(fdm32, pre, b, Lam, x0=x_warm, tol=tol, maxiter=maxiter), 3)
    plain_ms = cuda_ms(lambda: pcg_force.pcg_force_plain(fdm32, pre, b, zeros, Lam, tol, maxiter, True), 1)
    # grid-wide syncs per iteration: the waits among the timed instantiation's loop phases
    phases = pcg_force._build.load_library().smoqy_pcg_force_phases().decode().split(",")
    syncs = sum(name.startswith("sync") for name in phases)
    # the timed cold solve: each walker's two channels for its iterations,
    # the epilogue per walker; b, x0, Lambda, expV in, x, P1, P2 out
    Ltau, N, nc = fdm.Ltau, fdm.n_sites, fdm.cb.n_colors
    f32_it, bf16_it = pcg_iteration_ops(Ltau, N, nc)
    n_it = 2 * sum(iters["cold"])
    plane = W * Ltau * N * 4
    bound_ms, bound_by = bound(2 * 2 * plane + 2 * plane + 2 * plane + 2 * plane + precond_bytes(Ltau, N)
                               + table_bytes(fdm32, 4),
                               {"f32": n_it * f32_it + W * epilogue_ops(Ltau, N, nc), "bf16": n_it * bf16_it})
    cold_n, warm_n = max(iters["cold"]), max(iters["warm"])
    say(f"K3 cold solve + planes, W={W}: kernel {ms:.3f} ms plain {plain_ms:.3f} ms; {cold_n} iterations, "
        f"{1e3 * ms / max(cold_n, 1):.2f} us each (whole solve); warm {warm_ms:.3f} ms, {warm_n} iterations; "
        f"{syncs} grid syncs an iteration; tau blocks of {launch['tau_block']} rows, grid {launch['grid']} CTAs, "
        f"{launch['smem']} bytes of shared memory; bound {bound_ms:.4f} ms by {bound_by}")
    results["pcg_force"] = dict(name="pcg_force", route="cuda", source="smoqyelphqmc_tpu_torch/csrc/pcg_force.cu",
                                replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:620",
                                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def k4_against_plain(fdm32, Lam, psi):
    """K4 against its plain version on one channel pair, want_p2 on and off:
    (max abs err, the plain planes' max |P|, every element within rtol 1e-4,
    atol 1e-5 max|P|)."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import force

    err, top, ok = 0.0, 0.0, True
    for want_p2 in (True, False):
        got = force.force_planes_cuda(fdm32, Lam, psi, want_p2)
        ref = force.force_planes_plain(fdm32, Lam, psi, want_p2)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            d = (g - r).abs()
            err, top = max(err, float(d.max())), max(top, float(r.abs().max()))
            ok = ok and bool((d <= 1e-5 * float(r.abs().max()) + 1e-4 * r.abs()).all())
    return err, top, ok


def k4_operands(h=HEADLINE, neighbor_table=None):
    """Model h's f32 fermion matrix (optionally on a relabelled hopping
    graph), Lambda at its initial field and a seeded channel pair psi."""
    import torch

    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda

    dev = torch.device("cuda")
    tbp, elph = headline_model(dev, h)
    fdm32 = headline_fdm(dev, neighbor_table=neighbor_table, h=h).astype(torch.float32)
    Lam = build_lambda(elph, elph.x, tbp.n_sites).to(torch.float32)
    psi = torch.randn((2, fdm32.Ltau, fdm32.n_sites), generator=torch.Generator().manual_seed(14),
                      dtype=torch.float32).to(dev)
    return fdm32, Lam, psi


def phase_k4(results):
    """K4 on one channel pair at the headline size (the W = 1 trajectory's
    shape) against its plain version: the device's time (a CUDA graph of
    launches; the eager call's is the host's) and the timed instantiation's
    per-phase breakdown."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import force

    dev = torch.device("cuda")
    fdm32, Lam, psi = k4_operands()
    err, top, ok = k4_against_plain(fdm32, Lam, psi)
    ms = graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, True), 100)
    eager_ms = cuda_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, True), 20)
    plain_ms = cuda_ms(lambda: force.force_planes_plain(fdm32, Lam, psi, True), 5)
    Ltau, N, nc = fdm32.Ltau, fdm32.n_sites, fdm32.cb.n_colors
    # psi (2 planes), Lambda and expV in, P1 and P2 out
    bound_ms, bound_by = bound(6 * Ltau * N * 4 + table_bytes(fdm32, 4), {"f32": epilogue_ops(Ltau, N, nc)})
    shape = force.launch_shape(fdm32, 1)
    stamps = torch.zeros(force.stamp_slots(), dtype=torch.int64, device=dev)
    force.force_planes_cuda(fdm32, Lam, psi, True, stamps=stamps)
    torch.cuda.synchronize()
    us = force.phase_times(stamps, force.phase_names(nc, True))
    groups = {k: round(v, 2) for k, v in us["cta0"]["groups"].items()}
    say(f"K4 launch: tau blocks of {shape['tau_block']} rows, grid {shape['grid']} CTAs of {shape['threads']} "
        f"threads, form K={shape['form']}, {shape['smem']} bytes of shared memory; timed launch "
        f"{us['kernel']:.2f} us, CTA 0 {us['cta0']['us']:.2f} us by phase group {groups}")
    say(f"K4 planes (2, {fdm32.Ltau}, {fdm32.n_sites}): max abs err {err:.3e} at max|P| {top:.4g} (rtol 1e-4, "
        f"atol 1e-5 max|P|, want_p2 on and off: {ok}); kernel {ms:.4f} ms (device; eager call {eager_ms:.4f} ms) "
        f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")
    if not ok:
        fail("K4 disagrees with its plain version")
    results["force"] = dict(name="force", route="cuda", source="smoqyelphqmc_tpu_torch/csrc/force.cu",
                            replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:934", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_k4_shapes():
    """11. K4 against its plain version at the other shapes the paths here
    run it at, one line each with its launch and device time: the benchmark
    cells' (2, 80, 288), the Holstein tutorials' (2, 80, 18), the permuted
    headline lattice of phase 7 and the large model's (2, 240, 4608), which
    takes K4's memory form."""
    import numpy as np
    import torch

    from smoqyelphqmc_tpu_torch.ops import force

    tbp, _ = headline_model(torch.device("cpu"))
    perm = np.random.default_rng(15).permutation(tbp.n_sites)
    permuted = perm[np.asarray(tbp.neighbor_table)].astype(np.int32)
    for h, nt in ((CELL, None), (TUTORIAL, None), (dict(HEADLINE, name="permuted headline"), permuted),
                  (dict(LARGE, name="large"), None)):
        fdm32, Lam, psi = k4_operands(h, nt)
        err, top, ok = k4_against_plain(fdm32, Lam, psi)
        ms = graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, True), 20)
        shape = force.launch_shape(fdm32, 1)
        say(f"K4 planes, {h['name']} (2, {fdm32.Ltau}, {fdm32.n_sites}): max abs err {err:.3e} at max|P| "
            f"{top:.4g} (rtol 1e-4, atol 1e-5 max|P|, want_p2 on and off: {ok}); kernel {ms:.4f} ms (device); "
            f"tau blocks of {shape['tau_block']} rows, grid {shape['grid']}, form K={shape['form']}, staged "
            f"{shape['staged']}, {shape['smem']} bytes of shared memory")
        if not ok:
            fail(f"K4 disagrees with its plain version on the {h['name']} model")


def ssh_epilogue_ops(Ltau, N, n_colors, P):
    """K4's SSH form per channel pair without P2: per channel and site one B,
    both walks' colors on both buffers (4 x 3 n_colors), expV on both and ~10
    products and sums; per pair slot of each color and walk, its product (8)."""
    return 2 * Ltau * N * (b_flops(n_colors, True) + 12 * n_colors + 12) + 2 * Ltau * n_colors * P * 8


def phase_k4_ssh(results):
    """11b. K4's SSH form at the optical-SSH cell's shape (2, 80, 288), its
    hop tables on every tau row (the initial field), against its plain
    version with want_p2 off (the cell's launch) and on: P1, P2 and the hop
    plane H each within 1e-5 of its plain plane's largest value; the
    device's time (a CUDA graph of launches; the eager call's is the
    host's), the plain version's, the bound and the timed instantiation's
    per-phase breakdown."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import force

    dev = torch.device("cuda")
    fdm32, Lam, psi = k4_operands(SSH_CELL)
    C = fdm32.cb.C
    if fdm32.static_hops or not float((C - C[:, :1]).abs().max()) > 0:
        fail("the optical-SSH cell's hopping tables do not differ from one tau row to the next")
    rel, err = {}, 0.0
    for want_p2 in (False, True):
        got = force.force_planes_cuda(fdm32, Lam, psi, want_p2, hops=True)
        ref = force.force_planes_plain(fdm32, Lam, psi, want_p2, hops=True)
        torch.cuda.synchronize()
        for name, g, r in zip(("P1", "P2", "H"), got, ref):
            d, top = float((g - r).abs().max()), float(r.abs().max())
            err = max(err, d)
            rel[f"{name}{'' if want_p2 else ' no-p2'}"] = d / top if top > 0 else d
    ok = all(v <= 1e-5 for v in rel.values())
    ms = graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, False, hops=True), 100)
    hol_ms = graph_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, False), 100)
    eager_ms = cuda_ms(lambda: force.force_planes_cuda(fdm32, Lam, psi, False, hops=True), 20)
    plain_ms = cuda_ms(lambda: force.force_planes_plain(fdm32, Lam, psi, False, hops=True), 5)
    Ltau, N, nc = fdm32.Ltau, fdm32.n_sites, fdm32.cb.n_colors
    shape = force.launch_shape(fdm32, 1, hops=True)
    # psi (2 planes), Lambda and expV in, P1 and P2 out, H out
    bound_ms, bound_by = bound(6 * Ltau * N * 4 + Ltau * nc * shape["P"] * 4 + table_bytes(fdm32, 4),
                               {"f32": ssh_epilogue_ops(Ltau, N, nc, shape["P"])})
    stamps = torch.zeros(force.stamp_slots(), dtype=torch.int64, device=dev)
    force.force_planes_cuda(fdm32, Lam, psi, False, stamps=stamps, hops=True)
    torch.cuda.synchronize()
    us = force.phase_times(stamps, force.phase_names(nc, False, hops=True))
    groups = {k: round(v, 2) for k, v in us["cta0"]["groups"].items()}
    say(f"K4 SSH form launch: tau blocks of {shape['tau_block']} rows, grid {shape['grid']} CTAs of "
        f"{shape['threads']} threads, form K={shape['form']}, staged {shape['staged']}, {shape['smem']} bytes of "
        f"shared memory; timed launch {us['kernel']:.2f} us, CTA 0 {us['cta0']['us']:.2f} us by phase group {groups}")
    rel_s = ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
    say(f"K4 SSH form, {SSH_CELL['name']} (2, {Ltau}, {N}), C, S {tuple(C.shape)}: max |err| / max |plain| "
        f"{rel_s} (tol 1e-5 each: {ok}); kernel {ms:.4f} ms (device; Holstein form on the same operands "
        f"{hol_ms:.4f} ms; eager call {eager_ms:.4f} ms) plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms by "
        f"{bound_by}")
    if not ok:
        fail("K4's SSH form disagrees with its plain version")
    results["force_ssh"] = dict(name="force_ssh", route="cuda", source="smoqyelphqmc_tpu_torch/csrc/force.cu",
                                replaces="smoqyelphqmc_tpu/ops/derivatives.py:259", max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_k5(results, card):
    """K5's function (M^T M on an irregular partner map) through K1: the
    headline honeycomb with its site labels permuted. K1 is held against its
    plain version on those tables, then one W = 1 sweep runs on them: K5's
    launches are K1 f32's in that sweep."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from smoqyelphqmc_tpu_torch.driver import run_sweeps

    dev = torch.device("cuda")
    tbp, elph = headline_model(dev)
    perm = np.random.default_rng(15).permutation(tbp.n_sites)
    nt = perm[np.asarray(tbp.neighbor_table)].astype(np.int32)
    fdm64 = headline_fdm(dev, neighbor_table=nt)
    partner = fdm64.structure.partner
    classes = max(len(np.unique((p - np.arange(tbp.n_sites)) % tbp.n_sites)) for p in partner)
    say(f"K5 lattice: headline honeycomb, site labels permuted; up to {classes} lane-shift classes per "
        f"color (the JAX package takes _mtm_kernel_mm above 8)")
    if classes <= 8:
        fail("the permuted lattice is not irregular")
    phase_k1(fdm64, results, tag="K5", names=("mtm_irregular_f32", "mtm_irregular_f64"),
             replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:165")
    md, counts = drive_path(lambda: run_sweeps(dataclasses.replace(tbp, neighbor_table=nt), elph,
                                               headline_config(), 1),
                            ("mtm_f32", "mtm_f64", "pcg"))
    results["mtm_irregular_f32"]["launches"] = counts["mtm_f32"][0]
    say(f"K5 path on {card}: 1 sweep on the permuted lattice; s/sweep {[round(t, 4) for t in md['sweep_s']]}; "
        f"iters/solve hmc {md['hmc_iters']:.2f}; dH {rounded(md['hmc_delta_H'], 5)}; launches/plain calls {counts}")
    if not md["all_converged"] or not all(math.isfinite(d) for d in md["hmc_delta_H"]):
        fail("the sweep on the permuted lattice did not converge or has a non-finite Delta H")


def phase_walkers(results, card):
    """The walker path: N_WALKERS chains at the headline, shared refresh, every
    trajectory force solve through K3."""
    import math

    from smoqyelphqmc_tpu_torch.driver import run_updates

    h = HEADLINE
    W = N_WALKERS
    geo, tbm, em = model_of(h)
    md, counts = drive_path(
        lambda: run_updates(tbm, em, headline_config(n_walkers=W), N_WALKER_SWEEPS, device=MAIN_DEVICE),
        ("mtm_f64", "pcg", "pcg_force"))
    results["pcg_force"]["launches"] = counts["pcg_force"][0]
    sweep_s = md["sweep_s"]
    say(f"walker path on {card}: W={W}, {N_WALKER_SWEEPS} sweeps L={h['L']} beta={h['beta']}; "
        f"walker-sweeps/s {[round(W / t, 3) for t in sweep_s]}; s/sweep {[round(t, 4) for t in sweep_s]} "
        f"(init {md['t_init_s']:.3f} s); acceptance refl {md['reflection_acceptance_rate']:.3f} "
        f"swap {md['swap_acceptance_rate']:.3f} hmc {md['hmc_acceptance_rate']:.3f}; iters/solve "
        f"refl {md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; "
        f"fallback sweeps {md['precond_fallback_sweeps']}; converged {md['walker_converged']}; "
        f"dH {rounded(md['hmc_delta_H'], 5)}; launches/plain calls {counts}")
    if not all(md["walker_converged"]):
        fail("a walker of the walker path did not converge")
    if not all(math.isfinite(d) for dw in md["hmc_delta_H"] for d in dw):
        fail("a Delta H of the walker path is not finite")
    x = md["x_final"]
    if tuple(x.shape) != (W, 2 * h["L"] ** 2, md["Ltau"]) or not bool(x.isfinite().all()):
        fail(f"walker fields have shape {tuple(x.shape)} or non-finite values")


def large_model_kpm(symmetric):
    """The large model's KPM preconditioner at its initial field, built with
    live Lanczos bounds from a seeded start vector: (fdm, preconditioner)."""
    import torch

    from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner

    fdm = headline_fdm(torch.device("cuda"), h=LARGE, symmetric=symmetric)
    v0 = torch.randn(fdm.n_sites, generator=torch.Generator(device="cpu").manual_seed(16), dtype=torch.float64)
    pre = KPMPreconditioner.build(fdm, v0)
    if not (pre.matrix_free and pre.active):
        fail(f"the large model's KPM preconditioner is not an active matrix-free one (matrix_free "
             f"{pre.matrix_free}, active {pre.active}, bounds {pre.lo:.4f} {pre.hi:.4f})")
    return fdm, pre


def phase_kpm_kernel(results, symmetric):
    """K6 (symmetric) or K7 (asymmetric) against its plain version at the
    large-N path's shape: two vectors of (re, im) planes (2, 240, 4608), the
    coefficient planes (240, C_pad), live orders from the preconditioner."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import kpm_mf

    fdm, pre = large_model_kpm(symmetric)
    ops = pre.mf_operands()
    gen = torch.Generator(device="cpu").manual_seed(17)
    ure, uim = torch.randn((2, 2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to("cuda")
    plain = kpm_mf.kpm_mf_plain if symmetric else kpm_mf.kpm_mf_asym_plain
    got = kpm_mf.kpm_mf_cuda(ops, ure, uim)
    ref = plain(ops, ure, uim)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    tol = 2e-4 if symmetric else 5e-4
    ms = cuda_ms(lambda: kpm_mf.kpm_mf_cuda(ops, ure, uim), 20)
    plain_ms = cuda_ms(lambda: plain(ops, ure, uim), 2)
    # u in and y out once, the coefficient planes, tables, expV/half, orders
    # and the sort; operations per site of every row for every order step:
    # one Bbar (K6) or two (K7, re and im), the recurrence (5 per row) and the
    # coefficient update (2 per row; 8 per vector with K7's i-rotation)
    Ltau, N, nc = fdm.Ltau, fdm.n_sites, fdm.cb.n_colors
    orders = pre.orders.astype(int)
    C_pad = ops.coefs_re.shape[1]
    n_vec = ure.shape[0]
    nbytes = 2 * 2 * ure.numel() * 4 + (1 if symmetric else 2) * Ltau * C_pad * 4 + table_bytes(fdm, 4) \
        + N * 4 + 2 * Ltau * 4
    if symmetric:
        ops_f32 = 2 * n_vec * N * int(sum(1 + (o - 1) * (b_flops(nc, True) + 7) for o in orders))
    else:
        per_pass = int(sum(6 + (o - 1) * (2 * (b_flops(nc, False) + 5) + 8) for o in orders))
        ops_f32 = 2 * n_vec * N * per_pass
    bound_ms, bound_by = bound(nbytes, {"f32": ops_f32})
    name = "kpm_mf" if symmetric else "kpm_mf_asym"
    tag = "K6" if symmetric else "K7"
    # how the kernel launched: the stages of an order step, the time of one
    # order step of the longest frequency (which the kernel's time is), and
    # the plan's cluster part
    plan = kpm_mf.cluster_plan(ops, n_vec)
    steps = (1 if symmetric else 2) * (int(orders.max()) - 1)
    say(f"{tag} launch: {plan['stages']} stages per order step; {1e3 * ms / steps:.3f} us per order step of the "
        f"longest frequency ({ms:.4f} ms / {steps} steps); cluster size {plan['cluster_size']}, order threshold "
        f"{plan['order_threshold']}, {plan['sites_per_thread']} site(s) a thread; {plan['n_cluster']} of {Ltau} "
        f"frequencies took the cluster form")
    if plan["sites_per_thread"] == 0:
        fail(f"{tag}: the cluster form does not fit the large-N path's shape")
    say(f"{tag} u 2 x (2, {Ltau}, {N}), coefficients ({Ltau}, {C_pad}): bounds [{pre.lo:.4f}, {pre.hi:.4f}]; "
        f"live orders max {orders.max()} sum {orders.sum()}; max abs err {err:.3e} at max|y| {scale:.4g} "
        f"(rel {err / scale:.3e}, tol {tol:g}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    if not err <= tol * scale:
        fail(f"{tag} disagrees with its plain version: {err / scale:.3e} > {tol:g}")
    results[name] = dict(name=name, route="cuda", source="smoqyelphqmc_tpu_torch/csrc/kpm_mf.cu",
                         replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:" + ("1186" if symmetric else "1243"),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_large_path(results, card, symmetric, n_sweeps):
    """The large-N path: `run_updates` on the large model with
    preconditioner='auto' (KPM above 4000 sites, matrix-free above 1024)."""
    import math

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates

    h = LARGE
    geo, tbm, em = model_of(h)
    cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=h["Nt"], tol=h["tol"], seed=1, mixed_precision=True,
                           force_dtype="float32", preconditioner="auto", symmetric=symmetric)
    name = "kpm_mf" if symmetric else "kpm_mf_asym"
    md, counts = drive_path(lambda: run_updates(tbm, em, cfg, n_sweeps, device=MAIN_DEVICE),
                            ("mtm_f32", "mtm_f64", name))
    results[name]["launches"] = counts[name][0]
    n_solves = n_sweeps * (2 + h["Nt"] + 1)
    say(f"large-N path ({'symmetric' if symmetric else 'asymmetric'}) on {card}: {n_sweeps} sweep(s) L={h['L']} "
        f"N={md['n_sites']} alpha={h['alpha']} beta={h['beta']} Ltau={md['Ltau']}; kpm_active "
        f"{md.get('kpm_active')} order clips {md.get('kpm_order_clip_count')}; s/sweep "
        f"{[round(t, 4) for t in md['sweep_s']]} (init {md['t_init_s']:.3f} s); acceptance refl "
        f"{md['reflection_acceptance_rate']:.3f} swap {md['swap_acceptance_rate']:.3f} hmc "
        f"{md['hmc_acceptance_rate']:.3f}; iters/solve refl {md['reflection_iters']:.2f} swap "
        f"{md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; {name} launches per solve "
        f"{counts[name][0] / n_solves:.2f}; K1 launches per sweep f32 {counts['mtm_f32'][0] / n_sweeps:.1f} f64 "
        f"{counts['mtm_f64'][0] / n_sweeps:.1f}; dH {rounded(md['hmc_delta_H'], 5)}; launches/plain calls {counts}")
    if md.get("kpm_active") is not True:
        fail(f"the large-N path did not keep an active KPM preconditioner (kpm_active {md.get('kpm_active')})")
    if not md["all_converged"] or not all(math.isfinite(d) for d in md["hmc_delta_H"]):
        fail("the large-N path did not converge or has a non-finite Delta H")

def complex_chain(L, Omega, alpha, mu):
    """The complex chain t e^{i phase} of L sites (phase from COMPLEX)."""
    from smoqyelphqmc_tpu_torch.models.library import complex_chain_model

    return complex_chain_model(L, 1.0, COMPLEX["phase"], mu, Omega, alpha)


def complex_model(device, h=COMPLEX):
    """The complex chain's expanded parameters (seed 0): (tbm, em, tbp, elph)."""
    import numpy as np

    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingParameters

    geo, tbm, em = model_of(h)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device=device)
    return tbm, em, tbp, ElectronPhononParameters.from_model(h["beta"], h["dtau"], em, tbp, rng, device=device)


def cplx_bbar_flops(n_colors: int, symmetric: bool) -> int:
    """Operations per site of one channel-mixing Bbar application on a
    channel pair: each color is re' = C re + S re[p] - S_im im[p] and the
    same for im' (10); the diagonal two multiplies; the symmetric Bbar sweeps
    the colors twice."""
    return (2 if symmetric else 1) * 10 * n_colors + 2


def phase_kpm_cplx_kernel(results, symmetric):
    """K8 against its plain version on the complex chain's matrix-free KPM
    operands at the path's shape: one complex vector, the channel pair's
    frequency planes (240, 1152) each (each solve's right-hand side is one
    pair), the coefficient planes (240, C_pad), live orders from the
    preconditioner. Two vectors are checked as well, not timed."""
    import torch

    from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu_torch.ops import kpm_mf
    from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
    from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner

    *_, tbp, elph = complex_model(torch.device("cuda"))
    structure = build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph), structure, symmetric=symmetric)
    v0 = torch.randn(2 * fdm.n_sites, generator=torch.Generator(device="cpu").manual_seed(18), dtype=torch.float64)
    pre = KPMPreconditioner.build(fdm, v0)
    if not (pre.complex_pair and pre.matrix_free and pre.active):
        fail(f"the complex chain's KPM preconditioner is not an active matrix-free complex one (complex_pair "
             f"{pre.complex_pair}, matrix_free {pre.matrix_free}, active {pre.active})")
    ops = pre.mf_operands()
    gen = torch.Generator(device="cpu").manual_seed(19)
    ure, uim = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to("cuda")
    tol = 2e-4 if symmetric else 5e-4

    def rel_err(u_re, u_im):
        got = kpm_mf.kpm_mf_cplx_cuda(ops, u_re, u_im)
        ref = kpm_mf.kpm_mf_cplx_plain(ops, u_re, u_im)
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max()) for g, r in zip(got, ref)), scale

    err, scale = rel_err(ure, uim)
    u2 = torch.randn((2, 2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float32).to("cuda")
    err2, scale2 = rel_err(*u2)
    ms = cuda_ms(lambda: kpm_mf.kpm_mf_cplx_cuda(ops, ure, uim), 20)
    plain_ms = cuda_ms(lambda: kpm_mf.kpm_mf_cplx_plain(ops, ure, uim), 2)
    # the single vector's u in and y out once, the coefficient planes, the
    # stage tables A, B, B_im and 16-bit partners, orders and the sort;
    # operations per site for every order step: one channel-mixing Bbar, the
    # recurrence on the pair (10) and the coefficient update (4 real, 8 with
    # the asymmetric passes' i-rotation)
    Ltau, N, nc = fdm.Ltau, fdm.n_sites, fdm.cb.n_colors
    orders = pre.orders.astype(int)
    C_pad = ops.coefs_re.shape[1]
    nbytes = 2 * 2 * ure.numel() * 4 + (1 if symmetric else 2) * Ltau * C_pad * 4 \
        + ops.stage_A.shape[0] * N * (3 * 4 + 2) + 2 * Ltau * 4
    if symmetric:
        ops_f32 = N * int(sum(2 + (o - 1) * (cplx_bbar_flops(nc, True) + 14) for o in orders))
    else:
        ops_f32 = 2 * N * int(sum(6 + (o - 1) * (cplx_bbar_flops(nc, False) + 18) for o in orders))
    bound_ms, bound_by = bound(nbytes, {"f32": ops_f32})
    kind = "symmetric" if symmetric else "asymmetric"
    # the per-stage breakdown: the stages of an order step, the time of one
    # order step and of one stage of the longest frequency (which the
    # kernel's time is), the plan's cluster part
    plan = kpm_mf.cluster_plan(ops, 1)
    steps = (1 if symmetric else 2) * (int(orders.max()) - 1)
    say(f"K8 {kind} launch: {plan['stages']} stages per order step; {1e3 * ms / steps:.3f} us per order step, "
        f"{1e3 * ms / steps / plan['stages']:.3f} us per stage of the longest frequency ({ms:.4f} ms / {steps} "
        f"steps); cluster size {plan['cluster_size']}, order threshold {plan['order_threshold']}, "
        f"{plan['sites_per_thread']} site(s) a thread; {plan['n_cluster']} of {Ltau} frequencies took the cluster "
        f"form")
    if plan["sites_per_thread"] == 0:
        fail(f"K8 ({kind}): the cluster form does not fit the complex path's shape")
    say(f"K8 {kind} u 2 x ({Ltau}, {N}), coefficients ({Ltau}, {C_pad}): bounds [{pre.lo:.4f}, {pre.hi:.4f}]; "
        f"max|S_im| {float(ops.S_im.abs().max()):.4f}; live orders max {orders.max()} sum {orders.sum()}; "
        f"max abs err {err:.3e} at max|y| {scale:.4g} (rel {err / scale:.3e}, tol {tol:g}; two vectors "
        f"rel {err2 / scale2:.3e}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")
    if not (err <= tol * scale and err2 <= tol * scale2):
        fail(f"K8 ({kind}) disagrees with its plain version: {err / scale:.3e}, two vectors {err2 / scale2:.3e} "
             f"> {tol:g}")
    results["kpm_mf_cplx" if symmetric else "kpm_mf_cplx_asym"] = dict(
        name="kpm_mf_cplx", route="cuda", source="smoqyelphqmc_tpu_torch/csrc/kpm_mf.cu",
        replaces="smoqyelphqmc_tpu/ops/pallas_fused.py:1307", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)


def phase_cplx_path(results, card, symmetric, n_sweeps, preconditioner):
    """The complex path: `run_updates` on the complex chain. With 'kpm' K8 is
    the only kernel launched; with 'auto' (the doubled-basis spectral
    preconditioner) none is. The complex M^dag M runs as plain PyTorch (its
    calls are counted on ops.fermion_det.CPLX_MTM, by dtype)."""
    import math

    import torch

    from smoqyelphqmc_tpu_torch.driver import run_updates
    from smoqyelphqmc_tpu_torch.ops.fermion_det import CPLX_MTM

    h = COMPLEX
    tbm, em, *_ = complex_model("cpu")
    cfg = headline_config(h, preconditioner=preconditioner, symmetric=symmetric)
    kpm = preconditioner == "kpm"
    for c in CPLX_MTM.values():
        c.reset()
    md, counts = drive_path(lambda: run_updates(tbm, em, cfg, n_sweeps, device=MAIN_DEVICE),
                            ("kpm_mf_cplx",) if kpm else (), only=True)
    n_solves = n_sweeps * (2 + h["Nt"] + 1)
    kind = "symmetric" if symmetric else "asymmetric"
    if kpm:
        results["kpm_mf_cplx"]["launches"] = results["kpm_mf_cplx"].get("launches", 0) + counts["kpm_mf_cplx"][0]
    say(f"complex path ({kind}, {preconditioner}) on {card}: {n_sweeps} sweep(s) N={md['n_sites']} "
        f"phase={h['phase']} beta={h['beta']} Ltau={md['Ltau']}; kpm_active {md.get('kpm_active')}; s/sweep "
        f"{[round(t, 4) for t in md['sweep_s']]} (init {md['t_init_s']:.3f} s); acceptance refl "
        f"{md['reflection_acceptance_rate']:.3f} swap {md['swap_acceptance_rate']:.3f} hmc "
        f"{md['hmc_acceptance_rate']:.3f}; iters/solve refl {md['reflection_iters']:.2f} swap "
        f"{md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; K8 launches per solve "
        f"{counts['kpm_mf_cplx'][0] / n_solves:.2f}; plain complex M^dag M calls per sweep "
        f"f32 {CPLX_MTM[torch.float32].plain_calls / n_sweeps:.1f} f64 {CPLX_MTM[torch.float64].plain_calls / n_sweeps:.1f}; "
        f"dH {rounded(md['hmc_delta_H'], 5)}; launches/plain calls {counts}")
    if kpm and md.get("kpm_active") is not True:
        fail(f"the complex path did not keep an active KPM preconditioner (kpm_active {md.get('kpm_active')})")
    if not md["all_converged"] or not all(math.isfinite(d) for d in md["hmc_delta_H"]):
        fail(f"the complex path ({kind}, {preconditioner}) did not converge or has a non-finite Delta H")
    if any(c.plain_calls <= 0 for c in CPLX_MTM.values()):
        fail("the complex path never applied the complex M^dag M in f32 and f64")


class RefreshSpy:
    """Records every shared preconditioner refresh of the walker path while
    the block runs: its seconds (the card synchronised around it) and the
    refreshed KPM preconditioner's diagnostics (bounds, active, the largest
    live order, the clipped orders), by wrapping
    parallel.walkers.shared_precond_refresh."""

    def __enter__(self):
        import torch

        from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
        from smoqyelphqmc_tpu_torch.parallel import walkers

        self.seconds, self.kpm, self._orig = [], [], walkers.shared_precond_refresh
        orig = self._orig

        def spy(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            pre = out.precond[0]
            if isinstance(pre, KPMPreconditioner):
                self.kpm.append(dict(lo=round(pre.lo, 5), hi=round(pre.hi, 5), active=pre.active,
                                     max_order=int(pre.orders.max()), clips=int(pre.order_clip_count)))
            return out

        walkers.shared_precond_refresh = spy
        return self

    def __exit__(self, *exc):
        from smoqyelphqmc_tpu_torch.parallel import walkers

        walkers.shared_precond_refresh = self._orig


def phase_walker_kpm_path(results, card, h, W, symmetric, preconditioner, path_kernels, key=None, only=False):
    """The walker path with a KPM preconditioner or complex hoppings:
    `run_updates` on model h at W walkers, 1 sweep, the shared refresh (from
    the walker mean, its Lanczos start vector from its own stream) and each
    walker's trajectory on its own (K3 is off KPM and complex chains). Every
    walker's KPM must stay active, every solve converge and every Delta H be
    finite; the kernels of `path_kernels` must launch and no plain version
    run (only=True: no other kernel either). The launches of `key` add to its
    kernels-line entry. The line gives s/sweep, walker-sweeps/s, the shared
    refresh's seconds and its KPM diagnostics, iterations, acceptances and
    the KPM diagnostics folded over the walkers."""
    import math

    from smoqyelphqmc_tpu_torch.driver import run_updates

    cfg = headline_config(h, preconditioner=preconditioner, symmetric=symmetric, n_walkers=W)
    geo, tbm, em = model_of(h)
    with RefreshSpy() as spy:
        md, counts = drive_path(lambda: run_updates(tbm, em, cfg, 1, device=MAIN_DEVICE), path_kernels, only=only)
    if key is not None:
        results[key]["launches"] = results[key].get("launches", 0) + counts[key][0]
    n_solves = W * (2 + h["Nt"] + 1)
    kind = "symmetric" if symmetric else "asymmetric"
    sweep_s = md["sweep_s"][0]
    diag = {k: md.get(k) for k in ("kpm_active", "kpm_inactive_walkers", "kpm_order_clip_count")}
    per_solve = {k: round(counts[k][0] / n_solves, 2) for k in path_kernels}
    say(f"walker path ({h['name']}, {kind}, {preconditioner}) on {card}: W={W}, 1 sweep N={md['n_sites']} "
        f"beta={h['beta']} Ltau={md['Ltau']}; s/sweep {sweep_s:.4f}, walker-sweeps/s {W / sweep_s:.3f} (init "
        f"{md['t_init_s']:.3f} s); shared refresh s {[round(t, 4) for t in spy.seconds]} (KPM {spy.kpm}); "
        f"KPM diagnostics over the walkers {diag}; acceptance refl {md['reflection_acceptance_rate']:.3f} swap "
        f"{md['swap_acceptance_rate']:.3f} hmc {md['hmc_acceptance_rate']:.3f}; iters/solve refl "
        f"{md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; launches per solve "
        f"{per_solve}; fallback sweeps {md['precond_fallback_sweeps']}; converged {md['walker_converged']}; "
        f"dH {rounded(md['hmc_delta_H'], 5)}; launches/plain calls {counts}")
    if preconditioner == "kpm" or h is LARGE:
        if diag != {"kpm_active": True, "kpm_inactive_walkers": 0, "kpm_order_clip_count": 0} or not spy.kpm:
            fail(f"the walker path ({h['name']}, {kind}) did not keep every walker's KPM active: {diag}")
    if not spy.seconds or md["precond_fallback_sweeps"] != 0:
        fail("the walker path's sweep did not run the shared refresh")
    if not (md["all_converged"] and all(md["walker_converged"])):
        fail(f"a walker of the walker path ({h['name']}, {kind}, {preconditioner}) did not converge")
    if not all(math.isfinite(d) for dw in md["hmc_delta_H"] for d in dw):
        fail(f"a Delta H of the walker path ({h['name']}, {kind}, {preconditioner}) is not finite")


def phase_asym_headline(results, card):
    """Item 13 on the headline: K2 in its asymmetric form against its plain
    version, then 1 asymmetric sweep with 'auto' (the half-angle spectral
    preconditioner), K1 and K2 launching."""
    import math

    import torch

    from smoqyelphqmc_tpu_torch.driver import run_updates

    phase_k2(headline_fdm(torch.device("cuda"), symmetric=False), results, key="pcg_asym")
    h = HEADLINE
    geo, tbm, em = model_of(h)
    cfg = headline_config(preconditioner="auto", symmetric=False)
    md, counts = drive_path(lambda: run_updates(tbm, em, cfg, 1, device=MAIN_DEVICE), ("mtm_f32", "mtm_f64", "pcg"))
    say(f"asymmetric headline path on {card}: 1 sweep; s/sweep {[round(t, 4) for t in md['sweep_s']]}; "
        f"acceptance hmc {md['hmc_acceptance_rate']:.3f}; iters/solve refl {md['reflection_iters']:.2f} swap "
        f"{md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f}; dH {rounded(md['hmc_delta_H'], 5)}; "
        f"launches/plain calls {counts}")
    if not md["all_converged"] or not all(math.isfinite(d) for d in md["hmc_delta_H"]):
        fail("the asymmetric headline path did not converge or has a non-finite Delta H")


def phase_ssh_kernels(results):
    """a. K1 (f32, f64) and K2 (cold, warm) on the optical-SSH honeycomb's
    tables at its initial field (x != 0, so the tau rows of C and S differ:
    K1's memory form, K2 at tau stride N) against their plain versions at
    phases 3-4's tolerances, with their times and bounds (the tables' Ltau
    rows counted); K1 also with its tau blocks forced to T = 2 and to a
    ragged T = 7 (240 = 34 x 7 + 2); K2 also at the estimator refresh's
    (20, 240, 288)."""
    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm

    fdm64 = headline_fdm(torch.device("cuda"), h=SSH)
    C = fdm64.cb.C
    spread = float((C - C[:, :1]).abs().max())
    say(f"SSH tables (optical-SSH honeycomb L={SSH['L']}, beta={SSH['beta']}, alpha={SSH['alpha']}, initial field): "
        f"C, S {tuple(C.shape)}, static_hops {fdm64.static_hops}, max_l |C[:, l] - C[:, 0]| {spread:.3e}")
    if fdm64.static_hops or not spread > 0:
        fail("the SSH model's hopping tables do not differ from one tau row to the next")
    phase_k1(fdm64, results, tag="K1 SSH", names=("mtm_tau_f32", "mtm_tau_f64"))
    gen = torch.Generator(device="cpu").manual_seed(14)
    for T in (2, 7):
        for dtype, tol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
            fdm = fdm64.astype(dtype)
            v = torch.randn((2, fdm.Ltau, fdm.n_sites), generator=gen, dtype=torch.float64).to(fdm.device, dtype)
            shape = mtm.launch_shape(fdm, 2, tau_rows=T)
            ref = mtm.mtm_plain(fdm, v)
            rel = float((mtm.mtm_cuda(fdm, v, tau_rows=T) - ref).abs().max() / ref.abs().max())
            say(f"K1 SSH {str(dtype).split('.')[-1]} T={T}: max_rel_err {rel:.3e} (tol {tol:g}); form "
                f"{shape['form']}, grid {shape['grid']}, {shape['smem']} bytes")
            if shape["form"] != 0 or not rel <= tol:
                fail(f"K1 on the SSH tables at T={T} ({dtype}): form {shape['form']}, error {rel:.3e} > {tol:g}")
    phase_k2(fdm64, results, key="pcg_tau")
    phase_k2_estimator(results, h=SSH, two="pcg_tau")
    phase_table_forms()


def phase_table_forms():
    """The cost of the tau-table forms alone: the headline Holstein tables
    compressed to one row against the same values replicated over the Ltau
    rows (static_hops False: K1's memory form, K2 at tau stride N), the same
    shape, inputs and iterations; K1 f32 device ms (a CUDA graph of
    launches; also the memory form on the one-row tables), K2 ms a cold
    solve."""
    import dataclasses

    import torch

    from smoqyelphqmc_tpu_torch.ops import mtm, pcg
    from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral

    hol = headline_fdm(torch.device("cuda"))
    pre = build_spectral(hol)
    one = hol.astype(torch.float32)
    rows = dataclasses.replace(hol, static_hops=False).astype(torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(15)
    v = torch.randn((2, one.Ltau, one.n_sites), generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    k1 = {"register form, one row": graph_ms(lambda: mtm.mtm_cuda(one, v), 50),
          "memory form, one row": graph_ms(lambda: mtm.mtm_cuda(one, v, memory_form=True), 50),
          "memory form, Ltau rows": graph_ms(lambda: mtm.mtm_cuda(rows, v), 50)}
    same = torch.equal(mtm.mtm_cuda(one, v, memory_form=True), mtm.mtm_cuda(rows, v))
    b = (v / torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True)).contiguous()
    its = [int(pcg.pcg_cuda(f, pre, b, 1e-5, 500)[2]) for f in (one, rows)]
    k2 = [cuda_ms(lambda f=f: pcg.pcg_cuda(f, pre, b, 1e-5, 500), 5) for f in (one, rows)]
    say(f"table forms (headline Holstein tables, (2, 240, 288) f32): K1 {rounded(k1, 5)} ms; memory form on one "
        f"row and on Ltau rows bit-identical {same}; K2 cold solve one row {k2[0]:.3f} ms ({its[0]} iterations), "
        f"Ltau rows {k2[1]:.3f} ms ({its[1]} iterations)")
    if not same or its[0] != its[1]:
        fail("the replicated tau tables change K1's output or K2's iterations")


def phase_ssh_measured(results, card, W=1):
    """b, c. The measured SSH path: `simulate` on the optical-SSH honeycomb
    at full size with the SSH examples' configuration (radial updates, Nt=24,
    tol 1e-10 and the package defaults: mixed precision, f32 forces and
    measurements, 'auto' (spectral at N=288), seed 1) and `basic_spec`,
    N_therm=2, N_measurements=4, N_bins=2, Nrv=10, at W walkers (walker by
    walker trajectories, the shared walker-mean refresh); every solve must
    converge, every Delta H be finite, K1, K2 and K4 (its SSH form, once a
    kick a walker) launch and K3, the KPM kernels and every plain version
    not. Returns the launch counts."""
    import math
    import tempfile

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    h = SSH
    geo, tbm, em = model_of(h)
    spec = spec_of(h, geo, tbm)
    cfg = SimulationConfig(beta=h["beta"], dtau=h["dtau"], Nt=h["Nt"], tol=h["tol"], seed=1, use_radial_updates=True,
                           n_walkers=W, **MEASURED)
    with tempfile.TemporaryDirectory() as tmp:
        info = SimulationInfo(filepath=tmp, datafolder_prefix=f"ssh_w{W}", sID=1)
        t0 = time.perf_counter()
        with SweepSpy() as spy:
            (bins, md, finished), counts = drive_path(
                lambda: simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE),
                ("mtm_f32", "mtm_f64", "pcg", "force"), only=True)
        wall = time.perf_counter() - t0
    check_bins(bins, cfg.N_bins, f"the measured SSH path (W={W})", W)
    dH = [d for row in spy.dH for d in row]
    n_meas = md["n_measure_timed"]
    per_sweep = md["t_measure_s"] / n_meas
    ssh = {str(k): rounded([float(v) for v in bins[k]["local"]["ssh_energy"][0]], 5) for k in sorted(bins)}
    say(f"measured SSH path (W={W}) on {card}: simulate optical-SSH honeycomb L={h['L']} beta={h['beta']} "
        f"N={geo.n_sites} Ltau={round(h['beta'] / h['dtau'])} alpha={h['alpha']} radial, Nt={cfg.Nt}, N_therm={cfg.N_therm} "
        f"N_measurements={cfg.N_measurements} N_bins={cfg.N_bins} Nrv={cfg.Nrv}; s per measured sweep "
        f"{per_sweep:.4f}" + (f", walker-measured-sweeps/s {W / per_sweep:.3f}" if W > 1 else "")
        + f" (first {md['t_first_measured_sweep_s']:.3f}, {n_meas} sweeps {md['t_measure_s']:.3f} s; "
        f"thermalization {md['t_therm_s']:.3f} s for {md['n_therm_timed']}); estimator refresh "
        f"{md['t_refresh_s']:.4f} s, share {md['t_refresh_s'] / md['t_measure_s']:.4f}; measurement passes "
        f"{md['t_measurements_s']:.4f} s, share {md['t_measurements_s'] / md['t_measure_s']:.4f}; acceptance hmc "
        f"{md['hmc_acceptance_rate']:.3f} refl {md['reflection_acceptance_rate']:.3f} swap "
        f"{md['swap_acceptance_rate']:.3f} radial {md['radial_acceptance_rate']:.3f}; iters/solve refl "
        f"{md['reflection_iters']:.2f} swap {md['swap_iters']:.2f} hmc {md['hmc_iters']:.2f} measurement "
        f"{md['measurement_iters']:.2f}; "
        + (f"precond_fallback_sweeps {md['precond_fallback_sweeps']}; " if W > 1 else "")
        + f"dH {rounded(dH, 5)}; ssh_energy per bin {ssh}; all converged {md['all_converged']}; wall {wall:.2f} s; "
        f"launches/plain calls {counts}")
    if not (finished and md["all_converged"]):
        fail(f"the measured SSH path (W={W}) did not finish or converge ({finished}, {md['all_converged']})")
    if len(dH) != W * (cfg.N_therm + cfg.N_measurements) or not all(math.isfinite(d) for d in dH):
        fail(f"the measured SSH path (W={W}) has a non-finite Delta H: {dH}")
    return counts


def dispersive_bssh_square(L, Omega, alpha, mu):
    """The bond-SSH square lattice with one dispersion coupling added (as
    tests/test_aux.py:44 adds one)."""
    from smoqyelphqmc_tpu_torch.models.electron_phonon import DispersionCoupling
    from smoqyelphqmc_tpu_torch.models.library import bssh_square_model

    geo, tbm, em = bssh_square_model(L, Omega, alpha, mu)
    em.add_dispersion_coupling(DispersionCoupling(phonon_ids=(0, 0), displacement=[1, 0], Omega_mean=0.5))
    return geo, tbm, em


def complex_ssh_chain(L, Omega, alpha, mu):
    """The chain with a complex SSH constant alpha on real hoppings
    (tests/test_complex_hoppings.py:242)."""
    from smoqyelphqmc_tpu_torch.models.electron_phonon import ElectronPhononModel, PhononMode, SSHCoupling
    from smoqyelphqmc_tpu_torch.models.library import chain_geometry
    from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingModel

    geo, bond = chain_geometry(L)
    tbm = TightBindingModel(geo, [bond], [1.0], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], Omega))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=alpha))
    return geo, tbm, em


DISPERSIVE_BSSH = dict(SSH, name="bond-SSH square + dispersion", model="dispersive_bssh_square")
COMPLEX_SSH = dict(SSH, name="complex-SSH chain", model="complex_ssh_chain", alpha=0.4 + 0.25j, mu=0.1)


def phase_ssh_small_references():
    """d. GPU against CPU on small SSH models: the optical-SSH honeycomb
    L=3, beta=2 measured at W=1 and W=2, each interrupted and resumed bit
    for bit; the bond-SSH square L=4 with a dispersion coupling and the
    complex-SSH chain with 'auto' (the doubled-basis spectral
    preconditioner), their update paths at W=1."""
    phase_measured_small_reference(h=SSH, use_radial_updates=True)
    phase_measured_small_reference(h=SSH, n_walkers=2, use_radial_updates=True)
    phase_small_reference(L=4, h=DISPERSIVE_BSSH)
    phase_small_reference(L=4, beta=0.6, preconditioner="auto", h=COMPLEX_SSH)


# ----------------------------------------------------------------------
# Sweep batching and the walker fleet (32-34)
# ----------------------------------------------------------------------

FLEET_PROCESSES = 2
# the killed-and-resumed fleet: honeycomb L=3, beta=2, 2 walkers a process,
# batches of 2 sweeps
SMALL_FLEET = dict(L=3, beta=2.0, n_walkers=4, sweeps_per_dispatch=2)


def measured_walkers_run(cfg, tag):
    """`simulate` at the headline with cfg (W >= 2) on the card, the bins in
    memory, driven with every count set to 0 just before it and read just
    after (K1 f64, K2 and K3 must launch, no plain version run); in a fleet
    this process's walkers. Returns the bins, metadata, accept flags, last
    fields, counts and s per measured sweep."""
    import tempfile

    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    h = HEADLINE
    geo, tbm, em = model_of(h)
    spec = spec_of(h, geo, tbm)
    with tempfile.TemporaryDirectory() as tmp:
        info = SimulationInfo(filepath=tmp, datafolder_prefix="walkers", sID=1)
        t0 = time.perf_counter()
        with SweepSpy() as spy:
            (bins, md, finished), counts = drive_path(
                lambda: simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE), ("mtm_f64", "pcg", "pcg_force"))
        wall = time.perf_counter() - t0
    if not (finished and md["all_converged"]):
        fail(f"{tag} did not finish or converge ({finished}, {md['all_converged']})")
    return dict(bins=bins, md=md, flags=spy.flags, x=spy.x, counts=counts, wall=wall,
                per_sweep=md["t_measure_s"] / md["n_measure_timed"])


def field_rel_diff(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def phase_batching(card):
    """32. The measured walker path at full width (10a's configuration: the
    headline, W = N_WALKERS, the tutorial set) with sweeps_per_dispatch=2
    against the same run at k = 1: accept flags equal, bins within 1e-5 of
    each observable's largest magnitude. Returns the k = 1 run (phase 33's
    reference)."""
    runs = {k: measured_walkers_run(measured_config(n_walkers=N_WALKERS, sweeps_per_dispatch=k),
                                    f"the batching run k={k}") for k in (1, 2)}
    one, two = runs[1], runs[2]
    for r in runs.values():
        check_bins(r["bins"], r["md"]["N_bins"], "the batching run", N_WALKERS)
    leaves1, leaves2 = bin_leaves(one["bins"]), bin_leaves(two["bins"])
    worst, err = bins_rel_diff(leaves2, leaves1), field_rel_diff(two["x"], one["x"])
    same_flags = one["flags"] == two["flags"]
    bits = same_bins(leaves2, leaves1) and err == 0.0
    say(f"batching on {card}: simulate W={N_WALKERS} L={HEADLINE['L']} beta={HEADLINE['beta']} "
        f"N_therm={one['md']['N_therm']} N_measurements={one['md']['N_measurements']} sweeps_per_dispatch 2 against "
        f"1: accept flags equal {same_flags}; fields max rel diff {err:.3e}; bins max rel diff {worst:.3e} (tol 1e-5); "
        f"bit for bit {bits}; first batches k=2 therm {two['md']['n_first_therm_batch']} measured "
        f"{two['md']['n_first_measured_batch']}; s per measured sweep k=1 {one['per_sweep']:.4f} k=2 "
        f"{two['per_sweep']:.4f}; fallback sweeps k=1 {one['md']['precond_fallback_sweeps']} k=2 "
        f"{two['md']['precond_fallback_sweeps']}; launches/plain calls k=1 {one['counts']} k=2 {two['counts']}")
    if not (same_flags and worst <= 1e-5):
        fail("sweeps_per_dispatch=2 changed the measured walker path's accept flags or bins beyond 1e-5")
    return one


def small_fleet_run(job, folder):
    """Phase 34's run in a fleet process: the measured run on the honeycomb
    L=3, beta=2 at SMALL_FLEET into `folder` on the card, the bins in
    memory: 'ref' to the end, 'stop' with runtime limit 0 (it stops after its
    first batch and checkpoints), 'resume' from that checkpoint to the end."""
    import dataclasses

    from smoqyelphqmc_tpu_torch.driver import SimulationConfig
    from smoqyelphqmc_tpu_torch.io.simulation_info import SimulationInfo

    small = dict(SMALL_FLEET)
    L, beta = small.pop("L"), small.pop("beta")
    geo, tbm, em = model_of(HEADLINE, L)
    spec = spec_of(HEADLINE, geo, tbm)
    cfg = SimulationConfig(**{**dict(beta=beta, dtau=0.1, Nt=12, seed=5, preconditioner="spectral"), **MEASURED,
                              **small})
    if job == "stop":
        cfg = dataclasses.replace(cfg, runtime_limit_hours=0.0)
    info = SimulationInfo(filepath=folder, datafolder_prefix="ref" if job == "ref" else "interrupted", sID=1)
    bins, md, finished = simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE)
    return dict(bins=bins, finished=finished, datafolder=info.datafolder)


def fleet_worker(spec: dict) -> None:
    """One process of the fleet phases (`chip_smoke.py --fleet-worker
    JSON`): joins the gloo group of spec['world'] processes, its compute on
    the card (cuda:0 for every rank of one card), runs spec['jobs'] and
    pickles their results to <out>/rank<r>-<launch>.pkl."""
    import pickle

    from smoqyelphqmc_tpu_torch.parallel.distributed import initialize_distributed, local_walker_ids

    initialize_distributed(f"file://{spec['init']}", spec["world"], spec["rank"])
    out = {"owned": list(local_walker_ids(N_WALKERS))}
    for job in spec["jobs"]:
        if job == "full":
            out[job] = measured_walkers_run(measured_config(n_walkers=N_WALKERS), f"fleet rank {spec['rank']}")
        else:
            out[job] = small_fleet_run(job, os.path.join(spec["out"], "small"))
    with open(os.path.join(spec["out"], f"rank{spec['rank']}-{spec['launch']}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch_fleet(jobs, out, launch, timeout=600.0):
    """Run `jobs` in a fleet of FLEET_PROCESSES processes of this script on
    this card; returns each rank's results. A rank that fails fails the
    phase and ends the others."""
    import pickle

    from smoqyelphqmc_tpu_torch.parallel.distributed import spawn_processes

    init = os.path.join(out, f"pg-{launch}")
    spec = dict(init=init, world=FLEET_PROCESSES, jobs=list(jobs), out=out, launch=launch)
    logs = [os.path.join(out, f"log{r}-{launch}.txt") for r in range(FLEET_PROCESSES)]
    codes = spawn_processes([[sys.executable, os.path.abspath(__file__), "--fleet-worker",
                              json.dumps({**spec, "rank": r})] for r in range(FLEET_PROCESSES)], logs, timeout)
    bad = [(r, code) for r, code in enumerate(codes) if code != 0]
    if bad:
        for r, _ in bad:
            with open(logs[r]) as f:
                print(f"--- fleet rank {r} ({launch}):\n{f.read()[-3000:]}", file=sys.stderr)
        fail(f"fleet ranks failed or timed out (rank, code): {bad}")
    results = []
    for r in range(FLEET_PROCESSES):
        with open(os.path.join(out, f"rank{r}-{launch}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def merged_bins(ranks, job):
    bins = {}
    for r in ranks:
        bins.update(r[job]["bins"])
    return bins


def phase_fleet(card, single):
    """33. A fleet of FLEET_PROCESSES processes on this one card, N_WALKERS
    walkers split in blocks (K3 at 4 walkers a launch), gloo for the
    gathers, against `single` (phase 32's one-process run): accept flags
    equal, fields within 1e-6 relative, bins within 1e-5; each rank's
    launches of K1 f64, K2 and K3 and its s per measured sweep. 34. Kill and
    resume of a fleet at sweeps_per_dispatch=2 on the honeycomb L=3, beta=2:
    runtime limit 0 leaves one checkpoint a process; relaunched, the fleet
    must repeat the uninterrupted fleet's bins bit for bit."""
    import glob
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ranks = launch_fleet(["full", "ref", "stop"], out, "a")
        t1 = time.perf_counter()
        folder = ranks[0]["stop"]["datafolder"]
        cps = [len(glob.glob(os.path.join(folder, f"checkpoint_pID-{r}_slot-*.pkl"))) for r in range(FLEET_PROCESSES)]
        resumed = launch_fleet(["resume"], out, "b")
        t2 = time.perf_counter()
    full = [r["full"] for r in ranks]
    owned = [r["owned"] for r in ranks]
    bins = merged_bins(ranks, "full")
    leaves = check_bins(bins, single["md"]["N_bins"], "the fleet", N_WALKERS)
    worst = bins_rel_diff(leaves, bin_leaves(single["bins"]))
    flags = [tuple(sum((r["flags"][s][u] for r in full), ()) for u in range(len(f)))
             for s, f in enumerate(single["flags"])] if all(len(r["flags"]) == len(single["flags"]) for r in full) \
        else None
    err = field_rel_diff(torch.cat([r["x"] for r in full]), single["x"])
    bits = err == 0.0 and same_bins(leaves, bin_leaves(single["bins"]))
    say(f"fleet on {card}: {FLEET_PROCESSES} processes x {N_WALKERS // FLEET_PROCESSES} walkers (owned {owned}) on "
        f"one card, gloo, simulate W={N_WALKERS} L={HEADLINE['L']} beta={HEADLINE['beta']} against one process: "
        f"accept flags equal {flags == single['flags']}; fields max rel diff {err:.3e} (tol 1e-6); bins max rel diff "
        f"{worst:.3e} (tol 1e-5); bit for bit {bits}; s per measured sweep by rank "
        f"{[round(r['per_sweep'], 4) for r in full]} against one process {single['per_sweep']:.4f}; fallback sweeps "
        f"{[r['md']['precond_fallback_sweeps'] for r in full]}; launches/plain calls by rank "
        f"{[r['counts'] for r in full]}; {t1 - t0:.1f} s for the first launch (with phase 34's runs)")
    if not (flags == single["flags"] and err <= 1e-6 and worst <= 1e-5):
        fail("the fleet's chains disagree with one process's (flags, fields 1e-6 or bins 1e-5)")
    ref, res = bin_leaves(merged_bins(ranks, "ref")), bin_leaves(merged_bins(resumed, "resume"))
    stopped = [r["stop"]["finished"] for r in ranks]
    finished = [r["resume"]["finished"] for r in resumed]
    same = same_bins(res, ref) and len(ref) > 0
    say(f"fleet kill and resume on {card}: honeycomb L={SMALL_FLEET['L']} beta={SMALL_FLEET['beta']} "
        f"W={SMALL_FLEET['n_walkers']} sweeps_per_dispatch {SMALL_FLEET['sweeps_per_dispatch']}: stopped runs finished "
        f"{stopped}, checkpoints a rank {cps}; resumed runs finished {finished}; bins {len(res)} leaves, bit for bit "
        f"with the uninterrupted fleet {same}; {t2 - t1:.1f} s for the relaunch")
    if any(stopped) or min(cps) < 1 or not all(finished) or not same:
        fail("the killed and resumed fleet did not repeat the uninterrupted fleet's bins bit for bit")


# ----------------------------------------------------------------------
# The example twins (35)
# ----------------------------------------------------------------------

# the kernels each twin's path must launch (the Holstein honeycomb
# tutorials at W=1: K1, K2 and K4 after each trajectory solve; the five SSH
# examples: K1, K2 and K4's SSH form; the multiwalker tutorial at W=8: K3, K2, K1 f64; the
# flux chain, complex at N=8 with the doubled-basis spectral preconditioner:
# none); every twin but the multiwalker one may launch no other (its
# per-walker fallback sweeps may take K1 f32 and K4)
HOLSTEIN_TWIN = ("mtm_f32", "mtm_f64", "pcg", "force")
SSH_TWIN = ("mtm_f32", "mtm_f64", "pcg", "force")
TWIN_KERNELS = {"holstein_honeycomb_multiwalker": ("mtm_f64", "pcg", "pcg_force"), "holstein_flux_chain": (),
                **{n: SSH_TWIN for n in ("bssh_chain", "bssh_square", "ossh_chain", "ossh_square", "ossh_honeycomb")}}
# the twins' models as the kernel checks take them: the Holstein tutorials'
# (examples/holstein_honeycomb_multiwalker.py:49-51 defaults: N=18, Ltau=80)
# and the bond-SSH chain example's (examples/bssh_chain.py defaults: N=16,
# Ltau=80, a frozen M = inf mode under each bond's live one)
TUTORIAL = dict(HEADLINE, L=3, beta=4.0, alpha=1.5, name="honeycomb tutorial")
BSSH_CHAIN = dict(SSH, L=16, beta=4.0, alpha=0.5, name="bond-SSH chain", model="bssh_chain_model")
# the twins held GPU against CPU on their own models and configurations:
# every one with a kernel on its update path, but the checkpoint twin (the
# tutorial's model and configuration) and the density twin (its mu tuning
# needs the measured run)
TWIN_REFERENCES = ("holstein_honeycomb", "holstein_honeycomb_multiwalker", "bssh_chain", "bssh_square", "ossh_chain",
                   "ossh_square", "ossh_honeycomb")


def phase_twin_kernels():
    """35a. The kernels at the twins' shapes against their plain versions:
    K3 at the multiwalker tutorial's (8, 2, 80, 18) (its tau block depends
    on the systems, Ltau and N), K1 f32 / f64 and K2 cold / warm on the
    bond-SSH chain's tau tables (the frozen mode's M = inf in them), at
    phases 3, 4 and 12's tolerances."""
    import torch

    phase_k3(None, h=TUTORIAL)
    fdm64 = headline_fdm(torch.device("cuda"), h=BSSH_CHAIN)
    C = fdm64.cb.C
    spread = float((C - C[:, :1]).abs().max())
    say(f"bond-SSH chain tables (L={BSSH_CHAIN['L']}, beta={BSSH_CHAIN['beta']}, initial field): C, S "
        f"{tuple(C.shape)}, static_hops {fdm64.static_hops}, max_l |C[:, l] - C[:, 0]| {spread:.3e}")
    if fdm64.static_hops or not spread > 0:
        fail("the bond-SSH chain's hopping tables do not differ from one tau row to the next")
    phase_k1(fdm64, {}, tag="K1 bond-SSH chain", names=None)
    phase_k2(fdm64, {})


def twin_reference(name, n_sweeps=3, f64_forces=False):
    """35b. One twin's model and configuration (`setup` at its script's
    defaults) through run_updates on the GPU (the kernels, counted) and on
    the CPU (the plain versions) from the same seed: the acceptance rates
    must be equal, every solve converge and the fields agree to 1e-4
    relative, as in the small-model references. f64_forces also prints how
    far the CPU chain moves when its forces are solved in f64, the scale
    of f32 rounding on these chains."""
    import importlib

    mod = importlib.import_module(f"smoqyelphqmc_tpu_torch.examples.{name}")
    _, tbm, em, _, cfg = mod.setup()
    chain_reference(f"twin {name}", tbm, em, cfg, TWIN_KERNELS.get(name, HOLSTEIN_TWIN),
                    name != "holstein_honeycomb_multiwalker", n_sweeps, f64_forces)


def chain_reference(tag, tbm, em, cfg, kernels, only, n_sweeps=3, f64_forces=False):
    """A model and configuration through run_updates on the GPU (the path's
    kernels launched, counted) and on the CPU from the same seed, held as
    twin_reference holds them."""
    import dataclasses

    from smoqyelphqmc_tpu_torch.driver import run_updates

    t0 = time.perf_counter()
    gpu, counts = drive_path(lambda: run_updates(tbm, em, cfg, n_sweeps, device=MAIN_DEVICE), kernels, only=only)
    t1 = time.perf_counter()
    cpu = run_updates(tbm, em, cfg, n_sweeps, device="cpu")
    t2 = time.perf_counter()
    xg, xc = gpu["x_final"].cpu(), cpu["x_final"]
    err = float((xg - xc).abs().max() / xc.abs().max())
    rates = [k for k in gpu if k.endswith("_acceptance_rate")]
    same = all(gpu[k] == cpu[k] for k in rates)
    dH = [(g, c) for gw, cw in zip(gpu["hmc_delta_H"], cpu["hmc_delta_H"])
          for g, c in (zip(gw, cw) if isinstance(gw, list) else [(gw, cw)])]
    say(f"{tag} GPU vs CPU (W={cfg.n_walkers}, N={gpu['n_sites']}, Ltau={gpu['Ltau']}, {n_sweeps} sweeps): "
        f"field max rel err {err:.3e}; same acceptance {same} ({', '.join(f'{k} {gpu[k]:.3f}' for k in rates)}); "
        f"dH max abs diff {max(abs(g - c) for g, c in dH):.3e}; hmc iters/solve gpu {gpu['hmc_iters']:.2f} cpu "
        f"{cpu['hmc_iters']:.2f}; converged gpu {gpu['all_converged']} cpu {cpu['all_converged']}; "
        f"{t1 - t0:.1f} s GPU, {t2 - t1:.1f} s CPU; launches {({k: v[0] for k, v in counts.items() if v[0]})}")
    if f64_forces:
        cpu64 = run_updates(tbm, em, dataclasses.replace(cfg, force_dtype="float64"), n_sweeps, device="cpu")
        err64 = float((cpu64["x_final"] - xc).abs().max() / xc.abs().max())
        dH64 = max(abs(a - c) for a, c in zip(cpu64["hmc_delta_H"], cpu["hmc_delta_H"]))
        say(f"  the same CPU chain with f64 forces: field max rel diff {err64:.3e}, dH max abs diff {dH64:.3e}")
    if not (same and err <= 1e-4 and gpu["all_converged"] and cpu["all_converged"]):
        fail(f"{tag}: the GPU chain disagrees with its CPU reference")


def phase_twins(card):
    """35. Each example twin (smoqyelphqmc_tpu_torch.examples) at its
    script's defaults through `setup`, the sweep counts cut to MEASURED's
    (the multiwalker twin at its W=8, the checkpoint twin with its limits),
    driven through `simulate` with the bins in memory: every solve
    converged, every bin value finite but the NaN globals, the key the JAX
    example test asserts in the metadata (holstein_honeycomb's R_cdw from
    the in-memory bins, by the code that reads it from binned_data.h5),
    the path's kernels launched and no plain version run. One line a twin.
    First 35a (phase_twin_kernels) and 35b (twin_reference on
    TWIN_REFERENCES)."""
    import importlib
    import math
    import tempfile

    from smoqyelphqmc_tpu_torch.examples import TWINS
    from smoqyelphqmc_tpu_torch.examples.holstein_honeycomb import cdw_neighbors
    from smoqyelphqmc_tpu_torch.io.correlation_ratio import composite_ratio_from_bins

    cut = {k: MEASURED[k] for k in ("N_therm", "N_measurements", "N_bins")}
    t_phase = time.perf_counter()
    phase_twin_kernels()
    for name in TWIN_REFERENCES:
        twin_reference(name, f64_forces=name in ("holstein_honeycomb", "bssh_chain"))
    for name in TWINS:
        mod = importlib.import_module(f"smoqyelphqmc_tpu_torch.examples.{name}")
        kernels = TWIN_KERNELS.get(name, HOLSTEIN_TWIN)
        with tempfile.TemporaryDirectory() as tmp:
            info, tbm, em, spec, cfg = mod.setup(filepath=tmp, **cut)
            t0 = time.perf_counter()
            (bins, md, finished), counts = drive_path(
                lambda: simulate_in_memory(info, tbm, em, spec, cfg, MAIN_DEVICE), kernels,
                only=name != "holstein_honeycomb_multiwalker")
            wall = time.perf_counter() - t0
        W = cfg.n_walkers
        check_bins(bins, cfg.N_bins, f"the {name} twin", W)
        geo = spec.geometry
        key = ""
        if name == "holstein_honeycomb":
            R, dR = composite_ratio_from_bins(bins, "cdw", spec, (0, 0), cdw_neighbors(geo.L[0]))
            md["Rcdw_mean_real"], md["Rcdw_std"] = float(R.real), float(dR)
            key = f"R_cdw {R.real:.6f} +- {dR:.6f} (imag {R.imag:.3e}); "
            ok = math.isfinite(R.real) and math.isfinite(R.imag) and math.isfinite(dR)
        elif name == "holstein_honeycomb_density_tuning":
            key = f"final_mu {md['final_mu']:.6f} (target density {cfg.target_density}); "
            ok = math.isfinite(md["final_mu"])
        elif name == "holstein_honeycomb_multiwalker":
            key = f"n_walkers {md['n_walkers']}; precond_fallback_sweeps {md['precond_fallback_sweeps']}; "
            ok = md["n_walkers"] == W == N_WALKERS
        else:
            ok = math.isfinite(md["hmc_acceptance_rate"])
        n_meas = md["n_measure_timed"]
        rates = " ".join(f"{k} {md[f'{k}_acceptance_rate']:.3f}"
                         for k in ("hmc", "reflection", "swap") + (("radial",) if cfg.use_radial_updates else ()))
        iters = " ".join(f"{k} {md[f'{k}_iters']:.2f}" for k in ("reflection", "swap", "hmc", "radial", "measurement")
                         if f"{k}_iters" in md)
        launched = {k: v[0] for k, v in counts.items() if v[0]}
        say(f"twin {name} on {card}: W={W} N={geo.n_sites} Ltau={round(cfg.beta / cfg.dtau)} beta={cfg.beta} "
            f"N_therm={cfg.N_therm} N_measurements={cfg.N_measurements} N_bins={cfg.N_bins} Nrv={cfg.Nrv}; "
            f"s per measured sweep {md['t_measure_s'] / n_meas:.4f} ({n_meas} sweeps {md['t_measure_s']:.3f} s; "
            f"thermalization {md['t_therm_s']:.3f} s); acceptance {rates}; iters/solve {iters}; {key}"
            f"all converged {md['all_converged']}; wall {wall:.2f} s; launches {launched}")
        if not (finished and md["all_converged"] and ok):
            fail(f"the {name} twin did not finish, converge or give its key ({finished}, {md['all_converged']}, "
                 f"{ok})")
    say(f"twins: {len(TWINS)} in {time.perf_counter() - t_phase:.1f} s")


# the CDW study (scripts/physics_sweep.py:64-87, smoqyelphqmc_tpu_torch.physics_sweep):
# the Holstein honeycomb at alpha 1.5, W=8; its largest and smallest points
STUDY = dict(HEADLINE, alpha=1.5, name="CDW study")
STUDY_POINTS = ((9, 10.0), (6, 2.0))
STUDY_KERNELS = ("mtm_f64", "pcg", "pcg_force")


def study_model(L, beta):
    return dict(STUDY, L=L, beta=beta, name=f"CDW study L={L} beta={beta:g}")


def phase_study_kernels():
    """36a. The kernels at the study's extreme shapes against their plain
    versions (phases 4, 8 and 35a's tolerances), with their times and tau
    blocks: K3 at L=6, beta=2 (8, 2, 40, 72) and L=9, beta=10 (8, 2, 200,
    162), cold and warm; K1 f32 / f64, K2 cold / warm and K2 at the
    refresh's 20 systems on the L=9, beta=10 tables."""
    import torch

    for L, beta in sorted(STUDY_POINTS):
        phase_k3({}, h=study_model(L, beta))
    h = study_model(*max(STUDY_POINTS))
    fdm64 = headline_fdm(torch.device("cuda"), h=h)
    phase_k1(fdm64, {}, tag=f"K1 {h['name']}", names=None)
    two = {}
    phase_k2(fdm64, two)
    phase_k2_estimator(two, h=h)


def phase_study(card):
    """36. The CDW study's twin: 36a (phase_study_kernels); 36b, its command
    line at each of STUDY_POINTS, W=8, cut to MEASURED's depth, through
    drive_path: K1 f64, K2 and K3 launch and no plain version runs, the row's
    solves converged, every bin value finite but the NaN globals, R_cdw and
    its error finite; 36c, the L=6, beta=2 point's model and configuration
    through run_updates, 3 sweeps, GPU against CPU (chain_reference)."""
    import math
    import pickle
    import tempfile

    from smoqyelphqmc_tpu_torch import physics_sweep

    t_phase = time.perf_counter()
    phase_study_kernels()
    cut = ["--therm", str(MEASURED["N_therm"]), "--meas", str(MEASURED["N_measurements"]),
           "--bins", str(MEASURED["N_bins"]), "--walkers", str(N_WALKERS)]
    for L, beta in STUDY_POINTS:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--Ls", str(L), "--betas", f"{beta:g}", "--out", tmp, "--device", MAIN_DEVICE] + cut
            t0 = time.perf_counter()
            code, counts = drive_path(lambda: physics_sweep.main(argv), STUDY_KERNELS)
            wall = time.perf_counter() - t0
            with open(os.path.join(tmp, "results.json")) as f:
                rows = json.load(f)
            info, *_ = physics_sweep.point_setup(L, beta, physics_sweep.parse_args(argv))
            bins = {}
            for p in range(N_WALKERS):
                for b in range(MEASURED["N_bins"]):
                    with open(physics_sweep.bin_path(info, p, b), "rb") as f:
                        bins[(p, b)] = pickle.load(f)
        check_bins(bins, MEASURED["N_bins"], f"the CDW study twin at L={L} beta={beta:g}", N_WALKERS)
        if code != 0 or len(rows) != 1:
            fail(f"the CDW study twin at L={L} beta={beta:g} exited {code} with {len(rows)} rows")
        r = rows[0]
        say(f"CDW study twin on {card}: L={L} beta={beta:g} W={r['walkers']} N={2 * L * L} Ltau={round(beta / 0.05)} "
            f"seed {r['seed']} N_therm={r['therm']} N_measurements={r['meas']} bins {r['bins_total']}; s per "
            f"measured sweep {r['s_per_measured_sweep']:.4f}, thermalization sweep {r['s_per_therm_sweep']:.4f}; "
            f"acceptance hmc {r['hmc_acceptance_rate']:.3f} refl {r['reflection_acceptance_rate']:.3f} swap "
            f"{r['swap_acceptance_rate']:.3f}; iters/solve hmc {r['hmc_iters']:.2f} refl {r['reflection_iters']:.2f} "
            f"swap {r['swap_iters']:.2f} measurement {r['measurement_iters']:.2f}; precond_fallback_sweeps "
            f"{r['precond_fallback_sweeps']}; R_cdw {r['Rcdw_unrounded']:.6f} +- {r['Rcdw_err_unrounded']:.6f} (imag "
            f"{r['Rcdw_imag']:.3e}); all converged {r['all_converged']}; wall {wall:.2f} s; launches "
            f"{({k: v[0] for k, v in counts.items() if v[0]})}")
        if not (r["all_converged"] and all(math.isfinite(r[k]) for k in ("Rcdw_unrounded", "Rcdw_err_unrounded"))):
            fail(f"the CDW study twin at L={L} beta={beta:g} did not converge or gave no finite R_cdw")
    L, beta = min(STUDY_POINTS)
    _, tbm, em, _, cfg = physics_sweep.point_setup(L, beta, physics_sweep.parse_args(cut))
    chain_reference(f"CDW study L={L} beta={beta:g}", tbm, em, cfg, STUDY_KERNELS, False)
    say(f"CDW study phase: {time.perf_counter() - t_phase:.1f} s")


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
    if sys.argv[1:2] == ["--fleet-worker"]:
        fleet_worker(json.loads(sys.argv[2]))
        return

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
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, built {info['built']}); "
        f"ptxas: {' | '.join(ptxas_summary(info['log']))}")

    results: dict = {}
    fdm64 = headline_fdm(torch.device("cuda"))
    phase_k1(fdm64, results)
    phase_k1_large()
    phase_k2(fdm64, results)
    phase_k2_estimator(results)
    phase_main(results, card)
    measured = phase_measured(results, card)
    phase_small_reference()
    phase_measured_small_reference()
    phase_k5(results, card)
    phase_k3(results)
    phase_k4(results)
    results["force"]["launches"] = measured["force"][0]
    phase_walkers(results, card)
    counts = phase_measured_walkers(results, card, "main")
    results["pcg_force"]["launches"] = counts["pcg_force"][0]
    phase_measured_walkers(results, card, "options", use_radial_updates=True, hmc_integrator="omelyan", Nt=8,
                           target_acceptance=0.7, target_density=0.9)
    phase_measured_small_reference(n_walkers=2, use_radial_updates=True, hmc_integrator="omelyan", Nt=4,
                                   target_acceptance=0.7, target_density=0.9)
    phase_k4_shapes()
    phase_k4_ssh(results)
    phase_small_reference(n_walkers=2)
    phase_kpm_kernel(results, symmetric=True)
    phase_kpm_kernel(results, symmetric=False)
    phase_large_path(results, card, symmetric=True, n_sweeps=N_LARGE_SWEEPS)
    phase_large_path(results, card, symmetric=False, n_sweeps=1)
    phase_small_reference(L=24, beta=1.0, preconditioner="kpm")
    phase_kpm_cplx_kernel(results, symmetric=True)
    phase_kpm_cplx_kernel(results, symmetric=False)
    phase_cplx_path(results, card, symmetric=True, n_sweeps=2, preconditioner="kpm")
    phase_cplx_path(results, card, symmetric=False, n_sweeps=1, preconditioner="kpm")
    phase_cplx_path(results, card, symmetric=True, n_sweeps=1, preconditioner="auto")
    phase_cplx_path(results, card, symmetric=False, n_sweeps=1, preconditioner="auto")
    phase_asym_headline(results, card)
    phase_small_reference(L=COMPLEX["L"], beta=1.0, preconditioner="kpm", h=COMPLEX)
    phase_ssh_kernels(results)
    counts = phase_ssh_measured(results, card, W=1)
    results["mtm_tau_f32"]["launches"] = counts["mtm_f32"][0]
    results["pcg_tau"]["launches"] = counts["pcg"][0]
    results["force_ssh"]["launches"] = counts["force"][0]
    phase_ssh_measured(results, card, W=N_WALKERS)
    phase_ssh_small_references()
    # the walker path with KPM and complex hoppings (27-31)
    phase_walker_kpm_path(results, card, LARGE, N_WALKERS, True, "auto", ("mtm_f32", "mtm_f64", "kpm_mf"),
                          key="kpm_mf")
    phase_walker_kpm_path(results, card, LARGE, 2, False, "auto", ("mtm_f32", "mtm_f64", "kpm_mf_asym"),
                          key="kpm_mf_asym")
    phase_walker_kpm_path(results, card, COMPLEX, N_WALKERS, True, "kpm", ("kpm_mf_cplx",), key="kpm_mf_cplx",
                          only=True)
    phase_walker_kpm_path(results, card, COMPLEX, 2, True, "auto", (), only=True)
    phase_small_reference(n_walkers=2, L=24, beta=1.0, preconditioner="kpm")
    phase_small_reference(n_walkers=2, L=24, beta=1.0, preconditioner="kpm", shared_precond=False)
    phase_small_reference(n_walkers=2, L=COMPLEX["L"], beta=1.0, preconditioner="kpm", h=COMPLEX)
    phase_small_reference(n_walkers=2, L=4, beta=0.6, preconditioner="auto", h=COMPLEX_SSH)
    phase_measured_small_reference(L=24, beta=1.0, preconditioner="kpm", n_walkers=2, N_therm=1, N_measurements=2,
                                   N_bins=1)
    # sweep batching and the walker fleet (32-34)
    phase_fleet(card, phase_batching(card))
    # the example twins (35)
    phase_twins(card)
    # the CDW study's twin (36)
    phase_study(card)
    # K8's entry carries its symmetric instantiation's times (the asymmetric
    # one's are on its own line above), the larger error of the two, and the
    # launches of both complex KPM paths
    results["kpm_mf_cplx"]["max_abs_err"] = max(results[k]["max_abs_err"] for k in ("kpm_mf_cplx", "kpm_mf_cplx_asym"))
    kernels = []
    for k in ("mtm_f32", "mtm_f64", "pcg", "pcg_force", "force", "mtm_irregular_f32", "kpm_mf", "kpm_mf_asym",
              "kpm_mf_cplx", "mtm_tau_f32", "pcg_tau", "force_ssh"):
        r = results[k]
        # no single PyTorch call computes any of these functions from their
        # operands (checkerboard tables, a whole preconditioned solve, a
        # Chebyshev recurrence): library_ms is null for each
        kernels.append(dict(name=r["name"], route=r["route"], source=r["source"], replaces=r["replaces"],
                            launches=r.get("launches", 0), max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=None))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
