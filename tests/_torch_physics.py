"""Helpers of the port's physics checks (tests/test_torch_physics_*.py): the
small models of tests/_models.py and tests/test_open_boundaries.py built
with the port's classes, exact diagonalization of two-site models with a
truncated phonon space, and the sampling loop.

Neither this module nor the physics checks import jax or the JAX package,
so that they run on the GPU machine as well:

    SMOQY_TORCH_TEST_DEVICE=cuda python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_physics_*.py

(add `-m slow` for the exact-diagonalization checks alone). Without the
variable they run on the CPU.
"""

import os

import numpy as np
import torch

from smoqyelphqmc_tpu_torch import (
    Bond,
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    Lattice,
    ModelGeometry,
    PhononMode,
    SSHCoupling,
    TightBindingModel,
    TightBindingParameters,
    UnitCell,
)
from smoqyelphqmc_tpu_torch.measure.greens_estimator import draw_theta
from smoqyelphqmc_tpu_torch.parallel.walkers import (
    draw_shared,
    draw_walker,
    init_walker_states,
    walker_refresh,
    walker_sweep,
)

DEVICE = os.environ.get("SMOQY_TORCH_TEST_DEVICE", "cpu")

torch.set_num_threads(2)


def chain(L=2, t=1.0, mu=0.0, Omega=1.0, alpha=0.5, beta=1.0, dtau=0.1, periodic=True, ssh=False, seed=0):
    """The Holstein chain of tests/_models.py:chain_model (periodic) or the
    open chain of tests/test_open_boundaries.py:open_chain (an SSH coupling
    with ssh=True), expanded from np.random.default_rng(seed) on DEVICE."""
    geo = ModelGeometry(UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), Lattice(L=[L], periodic=[periodic]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    tbm = TightBindingModel(model_geometry=geo, t_bonds=[bond], t_mean=[t], eps_mean=[0.0], mu=mu)
    em = ElectronPhononModel(model_geometry=geo, tight_binding_model=tbm)
    p = em.add_phonon_mode(PhononMode(basis_vec=[0.0], Omega_mean=Omega))
    if ssh:
        em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=alpha))
    else:
        em.add_holstein_coupling(HolsteinCoupling(phonon_id=p, orbital_id=0, displacement=[0], alpha_mean=alpha,
                                                  ph_sym_form=True))
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng, device=DEVICE)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, device=DEVICE)
    return geo, tbp, elph


class Sampler:
    """W chains on the port's walker path (`parallel.walkers.walker_sweep`:
    reflection, swap and HMC, the trajectories of all walkers in one
    `hmc_update` with the shared preconditioner refresh when the chains carry
    a preconditioner), walker w's draws from a generator seeded from (seed,
    w), its initial field the chain's jittered by 0.1 N(0, 1) (W >= 2), and
    estimator refreshes whose phases come from generators of their own."""

    def __init__(self, ctx, state, params, seed, W=1):
        self.ctx, self.params = ctx, params
        self.gens = [torch.Generator().manual_seed(int(np.random.SeedSequence([seed, w]).generate_state(1)[0]))
                     for w in range(W)]
        self.gen_shared = torch.Generator().manual_seed(seed)
        self.gen_theta = [torch.Generator().manual_seed(seed + 1 + w) for w in range(W)]
        noise = torch.stack([0.1 * torch.randn(tuple(state.x.shape), generator=g, dtype=torch.float64)
                             for g in self.gens]) if W > 1 else torch.zeros((1,) + tuple(state.x.shape))
        self.states = init_walker_states(ctx, state, noise)

    def sweep(self):
        """One sweep of every walker; returns the HMC stats, a list over walkers."""
        ctx, pre = self.ctx, self.states.precond
        draws = [draw_walker(g, ctx, pre[w], self.params) for w, g in enumerate(self.gens)]
        self.states, st = walker_sweep(ctx, self.states, self.params, draws,
                                       v_shared=draw_shared(self.gen_shared, ctx, pre[0]))
        assert all(s.converged for ups in st for s in ups)
        return st.hmc

    def refresh(self, est, tol=1e-9, maxiter=2000):
        """Each walker's estimator at its current field (f64 solves)."""
        thetas = [draw_theta(g, est, DEVICE) for g in self.gen_theta]
        upds = walker_refresh(self.ctx, self.states, est, thetas, tol=tol, maxiter=maxiter)
        assert all(bool(u.converged) for u in upds)
        return [u.estimator for u in upds]

    @property
    def x(self) -> np.ndarray:
        """The walkers' fields (W, n_phonon, Ltau)."""
        return self.states.x.cpu().numpy()


def _mode_ops(n_modes=4):
    """Jordan-Wigner annihilators of (site 0 up, site 1 up, site 0 dn, site 1 dn)."""
    I2 = np.eye(2)
    c = np.array([[0.0, 1.0], [0.0, 0.0]])
    z = np.diag([1.0, -1.0])
    ops = []
    for k in range(n_modes):
        fac = [z] * k + [c] + [I2] * (n_modes - k - 1)
        out = fac[0]
        for o in fac[1:]:
            out = np.kron(out, o)
        ops.append(out)
    return ops


def _kron3(A, B, C):
    return np.kron(A, np.kron(B, C))


def _phonon(Omega, nb):
    a = np.diag(np.sqrt(np.arange(1, nb)), 1)
    return (a + a.T) / np.sqrt(2 * Omega), Omega * (a.T @ a + 0.5 * np.eye(nb))


def _thermal(H, beta):
    w, V = np.linalg.eigh(H)
    w = w - w.min()
    return w, V, np.exp(-beta * w)


def ed_holstein_dimer(t_eff, Omega, alpha, beta, n_boson=10):
    """Thermal <n>, <docc>, <X>, <X^2> of the Holstein dimer
    H = -t_eff sum_s (c^dag_0s c_1s + h.c.) + sum_i Omega (a^dag_i a_i + 1/2)
    + alpha sum_i X_i (n_i - 1) by dense ED (tests/test_physics_dimer_ed.py)."""
    c_ops = _mode_ops()
    n_ops = [op.T @ op for op in c_ops]
    n0, n1 = n_ops[0] + n_ops[2], n_ops[1] + n_ops[3]
    docc0, docc1 = n_ops[0] @ n_ops[2], n_ops[1] @ n_ops[3]
    hop = sum(c_ops[i].T @ c_ops[j] + c_ops[j].T @ c_ops[i] for (i, j) in [(0, 1), (2, 3)])
    nb = n_boson
    X1, Hb1 = _phonon(Omega, nb)
    Ib, If = np.eye(nb), np.eye(16)
    H = (np.kron(-t_eff * hop, np.eye(nb * nb)) + _kron3(If, Hb1, Ib) + _kron3(If, Ib, Hb1)
         + alpha * _kron3(n0 - If, X1, Ib) + alpha * _kron3(n1 - If, Ib, X1))
    _, V, boltz = _thermal(H, beta)
    Z = boltz.sum()

    def avg(op):
        return float(np.einsum("i,ji,jk,ki->", boltz, V, op, V) / Z)

    n_avg = avg(np.kron((n0 + n1) / 2, np.eye(nb * nb)))
    d_avg = avg(np.kron((docc0 + docc1) / 2, np.eye(nb * nb)))
    X_avg = avg((_kron3(If, X1, Ib) + _kron3(If, Ib, X1)) / 2)
    X2_avg = avg((_kron3(If, X1 @ X1, Ib) + _kron3(If, Ib, X1 @ X1)) / 2)
    return n_avg, d_avg, X_avg, X2_avg


def ed_holstein_dimer_correlations(t, Omega, alpha, beta, n_boson=10):
    """Greens, density, spin_z and pair correlations of the periodic L=2
    Holstein chain (hopping 2t) at tau = 0 and beta / 2, for r = 0 and 1
    (tests/test_physics_dimer_ed.py:test_holstein_dimer_correlations_vs_ed)."""
    c_ops = _mode_ops()
    n_ops = [op.T @ op for op in c_ops]
    nb = n_boson
    X1, Hb1 = _phonon(Omega, nb)
    Ib, If = np.eye(nb), np.eye(16)
    n0, n1 = n_ops[0] + n_ops[2], n_ops[1] + n_ops[3]
    hop = sum(c_ops[i].T @ c_ops[j] + c_ops[j].T @ c_ops[i] for (i, j) in [(0, 1), (2, 3)])
    H = (np.kron(-2 * t * hop, np.eye(nb * nb)) + _kron3(If, Hb1, Ib) + _kron3(If, Ib, Hb1)
         + alpha * _kron3(n0 - If, X1, Ib) + alpha * _kron3(n1 - If, Ib, X1))
    w, V, boltz = _thermal(H, beta)
    Z = boltz.sum()

    def corr_tau(A, B, tau):
        Am = V.T @ np.kron(A, np.eye(nb * nb)) @ V
        Bm = V.T @ np.kron(B, np.eye(nb * nb)) @ V
        return float(np.einsum("i,ij,j,ji->", np.exp(-(beta - tau) * w), Am, np.exp(-tau * w), Bm) / Z)

    Sz0, Sz1 = (n_ops[0] - n_ops[2]) / 2.0, (n_ops[1] - n_ops[3]) / 2.0
    D0, D1 = c_ops[2] @ c_ops[0], c_ops[3] @ c_ops[1]  # onsite pairs c_dn c_up
    taus = [0.0, beta / 2]

    def both(A0, A1, B0, B1):
        return [[(corr_tau(A0, B0, tt) + corr_tau(A1, B1, tt)) / 2, (corr_tau(A1, B0, tt) + corr_tau(A0, B1, tt)) / 2]
                for tt in taus]

    return {"density": both(n0, n1, n0, n1), "spin_z": both(Sz0, Sz1, Sz0, Sz1),
            "pair": both(D0, D1, D0.T, D1.T), "greens": both(c_ops[0], c_ops[1], c_ops[0].T, c_ops[1].T)}


def ed_ssh_dimer(t, Omega, alpha, beta, n_boson=10):
    """Thermal <n>, <docc>, <dx>, <dx^2> of the open two-site SSH chain
    H = -[t - alpha (X_1 - X_0)] sum_s (c^dag_0s c_1s + h.c.)
    + sum_i Omega (a^dag_i a_i + 1/2) (tests/test_physics_ssh_ed.py)."""
    c_ops = _mode_ops()
    n_ops = [op.T @ op for op in c_ops]
    n0, n1 = n_ops[0] + n_ops[2], n_ops[1] + n_ops[3]
    docc = (n_ops[0] @ n_ops[2] + n_ops[1] @ n_ops[3]) / 2
    hop = sum(c_ops[i].T @ c_ops[j] + c_ops[j].T @ c_ops[i] for (i, j) in [(0, 1), (2, 3)])
    nb = n_boson
    X, Hb = _phonon(Omega, nb)
    Ib, If = np.eye(nb), np.eye(16)
    dX = _kron3(If, Ib, X) - _kron3(If, X, Ib)  # X_1 - X_0
    hopb = np.kron(hop, np.eye(nb * nb))
    H = -t * hopb + _kron3(If, Hb, Ib) + _kron3(If, Ib, Hb) + alpha * hopb @ dX
    _, V, boltz = _thermal(H, beta)
    Z = boltz.sum()

    def avg(op):
        return float(np.einsum("i,ji,jk,ki->", boltz, V, op, V) / Z)

    return (avg(np.kron((n0 + n1) / 2, np.eye(nb * nb))), avg(np.kron(docc, np.eye(nb * nb))), avg(dX),
            avg(dX @ dX))
