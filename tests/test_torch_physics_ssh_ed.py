"""The port's twin of tests/test_physics_ssh_ed.py: the interacting SSH
dimer (OPEN two-site chain, one bond) sampled on the port's walker path
(W = 2 walkers of reflection, swap and HMC sweeps, the shared
preconditioner refresh, their measurements pooled) and measured by its
stochastic estimator, against exact
diagonalization: the hopping dressing, the colour-walk forces and the
open-boundary masking.

  H = -[t - alpha (X_1 - X_0)] sum_s (c^dag_0s c_1s + h.c.)
      + sum_i Omega (a^dag_i a_i + 1/2),   X_i = (a_i + a_i^dag)/sqrt(2 Omega).

The model, run length and thresholds are the JAX check's (slow, as there);
the draws come from the port's generators. No jax import: it runs on the
card with SMOQY_TORCH_TEST_DEVICE=cuda (tests/_torch_physics.py).
"""

import numpy as np
import pytest

from _torch_physics import DEVICE, Sampler, chain, ed_ssh_dimer

from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.measure.scalar import measure_double_occ, measure_n
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

# walkers pooled (the JAX check runs one chain)
W = 2


@pytest.mark.slow
def test_ssh_dimer_vs_ed():
    t, Omega, alpha, beta, dtau = 0.5, 1.0, 0.6, 2.0, 0.05
    n_ed, d_ed, dx_ed, dx2_ed = ed_ssh_dimer(t, Omega, alpha, beta, n_boson=12)
    geo, tbp, elph = chain(L=2, t=t, mu=0.0, alpha=alpha, beta=beta, dtau=dtau, periodic=False, ssh=True)
    ctx, state = initialize_qmc(tbp, elph, tol=1e-9)
    run = Sampler(ctx, state, HMCParams(Nt=10), seed=11, W=W)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=8, device=DEVICE)

    for _ in range(80):
        run.sweep()

    n_acc = d_acc = dx_acc = dx2_acc = 0.0
    cnt = 0
    for i in range(400):
        run.sweep()
        if i % 2 == 0:
            for e, x in zip(run.refresh(est), run.x):  # x (2 modes, Ltau)
                dx = x[1] - x[0]
                n_acc += float(measure_n(e).real)
                d_acc += float(measure_double_occ(e).real)
                dx_acc += dx.mean()
                dx2_acc += (dx**2).mean()
                cnt += 1

    n_avg = 2 * n_acc / cnt
    d_avg = d_acc / cnt
    dx_avg = dx_acc / cnt
    dx2_avg = dx2_acc / cnt
    print(f"ssh dimer: n {n_avg} (ED {n_ed}), docc {d_avg} ({d_ed}), dx {dx_avg} ({dx_ed}), dx2 {dx2_avg} ({dx2_ed})")

    np.testing.assert_allclose(n_avg, n_ed, atol=0.06)
    np.testing.assert_allclose(d_avg, d_ed, rtol=0.15)
    np.testing.assert_allclose(dx2_avg, dx2_ed, rtol=0.15)
    assert abs(dx_avg - dx_ed) < 0.25 * np.sqrt(dx2_ed)
