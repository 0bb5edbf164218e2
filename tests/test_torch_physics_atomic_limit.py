"""The port's twin of tests/test_physics_atomic_limit.py: the exactly
solvable atomic-limit Holstein model (t = 0, mu = 0, ph-symmetric coupling
alpha X (n - 1)) sampled on the port's walker path (W = 4 walkers of
reflection, swap and HMC sweeps, the trajectories of all walkers in one
hmc_update with the shared spectral preconditioner refresh, their
measurements pooled) and measured by its stochastic estimator, against the
closed form.

Per site the model decouples into displaced oscillators:
  lambda = alpha^2 / (2 M Omega^2),
  <n> = 1 (particle-hole symmetry),
  <n_up n_dn> = e^{beta lambda} / (2 + 2 e^{beta lambda}),
  <X> = 0,
  <X^2> = sigma^2_disc + (alpha / M Omega^2)^2 e^{beta lambda} / (1 + e^{beta lambda}),
with sigma^2_disc the discretized free-oscillator width (1/Ltau) sum_k 1/Q_k.

The model, the run lengths and the thresholds are the JAX check's; the
draws come from the port's generators. The JAX check runs one chain,
unpreconditioned, by reflection and HMC alone, and its thresholds are
close to one chain's statistical spread, so that one chain with other
draws than the JAX check's passes or fails by chance; the twin pools four
walkers. A swap move and a preconditioner leave the sampled distribution
as it is. No jax import: it runs on the card
with SMOQY_TORCH_TEST_DEVICE=cuda (tests/_torch_physics.py).
"""

import numpy as np

from _torch_physics import DEVICE, Sampler, chain

from smoqyelphqmc_tpu_torch.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu_torch.measure.scalar import measure_double_occ, measure_n
from smoqyelphqmc_tpu_torch.ops.bosonic import harmonic_curvature
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams

# walkers pooled (the JAX check runs one chain)
W = 4


def test_atomic_limit_holstein():
    beta, dtau, alpha, Omega = 2.0, 0.05, 1.0, 1.0
    geo, tbp, elph = chain(L=2, t=0.0, mu=0.0, Omega=Omega, alpha=alpha, beta=beta, dtau=dtau)
    ctx, state = initialize_qmc(tbp, elph, tol=1e-9, preconditioner="spectral")
    run = Sampler(ctx, state, HMCParams(Nt=10), seed=3, W=W)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=8, device=DEVICE)

    for _ in range(60):
        run.sweep()

    n_acc = d_acc = x2_acc = x_acc = 0.0
    cnt = 0
    for i in range(300):
        run.sweep()
        if i % 2 == 0:
            for e, x in zip(run.refresh(est), run.x):
                n_acc += float(measure_n(e).real)
                d_acc += float(measure_double_occ(e).real)
                x_acc += x.mean()
                x2_acc += (x**2).mean()
                cnt += 1

    n_avg = 2 * n_acc / cnt  # spin-summed density
    d_avg = d_acc / cnt
    x_avg = x_acc / cnt
    x2_avg = x2_acc / cnt

    lam = alpha**2 / (2.0 * Omega**2)
    w = np.exp(beta * lam)
    d_exact = w / (2.0 + 2.0 * w)
    sigma2 = float(np.mean(1.0 / harmonic_curvature(elph).cpu().numpy()))
    x2_exact = sigma2 + (alpha / Omega**2) ** 2 * w / (1.0 + w)
    print(f"atomic limit: n {n_avg}, docc {d_avg} (exact {d_exact}), X {x_avg}, X2 {x2_avg} (exact {x2_exact})")

    np.testing.assert_allclose(n_avg, 1.0, atol=0.05)
    np.testing.assert_allclose(d_avg, d_exact, rtol=0.15)
    np.testing.assert_allclose(x2_avg, x2_exact, rtol=0.15)
    assert abs(x_avg) < 0.3 * np.sqrt(x2_exact)
