"""The port's twin of tests/test_physics_dimer_ed.py: the interacting
Holstein dimer (periodic L=2 chain, so the hopping appears twice: 2t)
sampled on the port's walker path (W = 2 walkers of reflection, swap and
HMC sweeps, the shared preconditioner refresh, their measurements pooled)
and measured by its stochastic estimator and measurement pass, against
exact diagonalization with a truncated phonon space.

  H = -2t sum_s (c^dag_0s c_1s + h.c.) + sum_i Omega (a^dag_i a_i + 1/2)
      + alpha sum_i X_i (n_i - 1),   X = (a + a^dag)/sqrt(2 Omega),  M = 1.

The models, run lengths and thresholds are the JAX checks' (slow, as
there); the draws come from the port's generators. No jax import: they run
on the card with SMOQY_TORCH_TEST_DEVICE=cuda (tests/_torch_physics.py).
"""

import numpy as np
import pytest

from _torch_physics import DEVICE, Sampler, chain, ed_holstein_dimer, ed_holstein_dimer_correlations

from smoqyelphqmc_tpu_torch.measure.container import MeasurementSpec, make_measurements
from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.measure.scalar import measure_double_occ, measure_n
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

# walkers pooled (the JAX checks run one chain)
W = 2


@pytest.mark.slow
def test_holstein_dimer_vs_ed():
    t, Omega, alpha, beta, dtau = 0.5, 1.0, 0.8, 2.0, 0.05
    n_ed, d_ed, X_ed, X2_ed = ed_holstein_dimer(2 * t, Omega, alpha, beta, n_boson=12)
    geo, tbp, elph = chain(L=2, t=t, mu=0.0, Omega=Omega, alpha=alpha, beta=beta, dtau=dtau)
    ctx, state = initialize_qmc(tbp, elph, tol=1e-9)
    run = Sampler(ctx, state, HMCParams(Nt=10), seed=5, W=W)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=8, device=DEVICE)

    for _ in range(80):
        run.sweep()

    n_acc = d_acc = x_acc = x2_acc = 0.0
    cnt = 0
    for i in range(400):
        run.sweep()
        if i % 2 == 0:
            for e, x in zip(run.refresh(est), run.x):
                n_acc += float(measure_n(e).real)
                d_acc += float(measure_double_occ(e).real)
                x_acc += x.mean()
                x2_acc += (x**2).mean()
                cnt += 1

    n_avg = 2 * n_acc / cnt
    d_avg = d_acc / cnt
    x_avg = x_acc / cnt
    x2_avg = x2_acc / cnt
    print(f"dimer: n {n_avg} (ED {n_ed}), docc {d_avg} ({d_ed}), X {x_avg} ({X_ed}), X2 {x2_avg} ({X2_ed})")

    np.testing.assert_allclose(n_avg, n_ed, atol=0.06)
    np.testing.assert_allclose(d_avg, d_ed, rtol=0.15)
    np.testing.assert_allclose(x2_avg, X2_ed, rtol=0.15)
    assert abs(x_avg - X_ed) < 0.25 * np.sqrt(X2_ed)


@pytest.mark.slow
def test_holstein_dimer_correlations_vs_ed():
    """Greens / density / spin_z / pair correlations, equal-time and at
    tau = beta/2, of the interacting dimer against ED: the port's
    stochastic contractions on an exactly solvable interacting model."""
    t, Omega, alpha, beta, dtau = 0.5, 1.0, 0.8, 1.0, 0.1
    ed = ed_holstein_dimer_correlations(t, Omega, alpha, beta, n_boson=10)
    geo, tbp, elph = chain(L=2, t=t, mu=0.0, Omega=Omega, alpha=alpha, beta=beta, dtau=dtau)
    ctx, state = initialize_qmc(tbp, elph, tol=1e-9)
    run = Sampler(ctx, state, HMCParams(Nt=10), seed=7, W=W)
    spec = MeasurementSpec(geometry=geo)
    kinds = ("greens", "density", "spin_z", "pair")
    for kind in kinds:
        spec.add_correlation(kind, [(0, 0)], time_displaced=True)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=8, device=DEVICE)

    for _ in range(50):
        run.sweep()
    accs, cnt = None, 0
    for i in range(240):
        run.sweep()
        if i % 2 == 0:
            for e, x in zip(run.refresh(est), run.states.x):
                out = make_measurements(ctx, spec, e, x)
                m = {k: out["correlations"][k][0][0].cpu().numpy() for k in kinds}
                accs = m if accs is None else {k: accs[k] + m[k] for k in m}
                cnt += 1

    Lt = elph.Ltau
    tidx = [0, Lt // 2]
    # the JAX check's tolerances: Trotter at dtau = 0.1 contributes up to
    # ~0.1 on density; stochastic error ~0.02-0.05 at Nrv = 8 x 120 samples
    atol = {"density": 0.2, "spin_z": 0.06, "pair": 0.12, "greens": 0.1}
    for k in kinds:
        C = accs[k] / cnt  # (Ltau+1, 2)
        for j, ti in enumerate(tidx):
            for r in (0, 1):
                print(f"{k} tau_idx={ti} r={r}: {C[ti, r]} (ED {ed[k][j][r]})")
                np.testing.assert_allclose(C[ti, r], ed[k][j][r], atol=atol[k], err_msg=f"{k} tau_idx={ti} r={r}")
