"""One sweep at production size against the JAX package: the Holstein
honeycomb L=24 (N=1152 sites), beta=6 (Ltau=120), alpha=1.5, Omega=1, with
preconditioner='kpm' (matrix-free above 1024 sites, in both packages) at
W=1: reflection, swap and a 24-step leapfrog trajectory from one state, the
port fed the JAX package's draws (the keys' splits and the Lanczos vectors,
as tests/test_torch_kpm.py replays them).

With f64 forces solved to tol_force=1e-11 in both packages (as
tests/test_torch_ssh_timestep.py solves them): the same accept flags, Delta H
within 1e-4 and the end field within 1e-6 relative. With the default f32
forces (solves that stop at tol_force = sqrt(tol) = 1e-5 relative, in
another order of sums) both Delta H are printed (`-s`): the trajectories
part at that level, and so they do with f64 forces at that tol_force (Delta
H 5.2e-4 apart, the field 1.3e-6).

beta=6, not 12: at beta=12 the f64 case alone ran past 39 minutes on an
8-core host without finishing. It is `slow` (minutes of CPU in each
package):
python -m pytest tests/test_torch_large_n_parity.py -m slow -s
"""

import time

import jax
import numpy as np
import pytest
import torch

from _torch_common import both_models, np64, t64
from test_torch_hmc import _hmc_draws, _reflection_draws, _swap_draws
from test_torch_kpm import _v0

from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import global_updates as jglobal
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.global_updates import _candidate_modes, _type_pairs, reflection_update, swap_update
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update

torch.set_num_threads(2)

MODEL = dict(L=24, beta=6.0, dtau=0.05, alpha=1.5, Omega=1.0)
SEED, NT = 4, 24


@pytest.mark.slow
@pytest.mark.parametrize("force_dtype", ["float64", "float32"])
def test_large_n_kpm_sweep_matches_jax_draws(force_dtype):
    (_, _, jtbp, _, jelph), _ = both_models("honeycomb", **MODEL)
    opts = dict(mixed_precision=True, force_dtype=force_dtype, preconditioner="kpm",
                **({"tol_force": 1e-11} if force_dtype == "float64" else {}))
    t0 = time.perf_counter()
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=SEED, **opts)
    N, L = jctx.n_sites, jctx.Ltau
    assert (N, L) == (1152, 120) and jstate.precond.matrix_free and bool(jstate.precond.active)
    params = jhmc.HMCParams(Nt=NT)

    @jax.jit
    def jax_sweep(s):
        s, r = jglobal.reflection_update(jctx, s)
        s, sw = jglobal.swap_update(jctx, s)
        s, h = jhmc.hmc_update(jctx, s, params)
        return s.x, r.accepted, sw.accepted, h

    jx, ja_r, ja_s, jh = jax.block_until_ready(jax_sweep(jstate))
    t1 = time.perf_counter()
    print(f"\nJAX sweep ({force_dtype} forces): {t1 - t0:.1f} s, Delta H {float(jh.delta_H)!r}", flush=True)

    v_init = t64(_v0(jax.random.split(jax.random.PRNGKey(SEED))[1], N))
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), lanczos_v0=v_init, **opts)
    assert isinstance(pstate.precond, KPMPreconditioner) and pstate.precond.matrix_free and pstate.precond.active
    rd, key = _reflection_draws(jstate.key, len(_candidate_modes(pctx, None)), L, N)
    sd, key = _swap_draws(key, len(_type_pairs(pctx, None)), pctx.elph.n_cells, L, N)
    hd, _ = _hmc_draws(key, pctx.elph.n_phonon, L, N)
    hd.v_pre0 = t64(_v0(jax.random.split(key, 6)[5], N))
    pstate, pr = reflection_update(pctx, pstate, rd)
    pstate, ps = swap_update(pctx, pstate, sd)
    pstate, ph = hmc_update(pctx, pstate, HMCParams(Nt=NT), hd)
    t2 = time.perf_counter()

    xj = np64(jx)
    rel = float(np.max(np.abs(pstate.x.numpy() - xj)) / np.max(np.abs(xj)))
    flags = ((pr.accepted, ps.accepted, ph.accepted), (bool(ja_r), bool(ja_s), bool(jh.accepted)))
    print(f"L=24 beta=6 alpha=1.5 'kpm' {force_dtype} forces: Delta H port {ph.delta_H!r} JAX "
          f"{float(jh.delta_H)!r} (diff {abs(ph.delta_H - float(jh.delta_H)):.3e}); accept flags port / JAX {flags}; "
          f"end field max rel diff {rel:.3e}; hmc iters/solve port {ph.iters_avg:.2f}; CPU seconds JAX "
          f"{t1 - t0:.1f}, port {t2 - t1:.1f}", flush=True)
    assert pr.converged and ps.converged and ph.converged and bool(jh.converged)
    assert np.isfinite(ph.delta_H) and np.isfinite(float(jh.delta_H))
    if force_dtype == "float64":
        assert flags[0] == flags[1]
        assert abs(ph.delta_H - float(jh.delta_H)) <= 1e-4
        assert rel <= 1e-6
