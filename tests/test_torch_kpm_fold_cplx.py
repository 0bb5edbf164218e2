"""The host side of the redesigned K8 (ops/kpm_mf.py): the complex stage
tables that fold Bbar / half of complex hoppings into a few channel-mixing
gathers, and the recurrence K8 computes through them. CPU only: the complex
chain (L = 6; L = 7, whose odd ring leaves a site of a color unpaired) and a
complex honeycomb (L = 2, t e^{0.7 i} on every bond).

Tolerances: the tables against `AveragedPropagator.apply` 1e-12 relative in
float64 (the same products, the middle color's two sides and the diagonal
multiplied out once); the staged recurrence (the operands' float32 tables,
center / half subtracted in the step, each frequency to its own order)
against the JAX package's `_mf_cheb_pair` 2e-4 (symmetric) and 5e-4
(asymmetric) of max|y|, K8's own tolerances (tests/test_torch_complex.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import np64
from test_torch_complex import KPM_CHAIN, cplx_fdm_pair
from test_torch_kpm import _rel

from smoqyelphqmc_tpu.ops import kpm as jkpm
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.lattice import Bond, Lattice, ModelGeometry, UnitCell
from smoqyelphqmc_tpu_torch.models.electron_phonon import (ElectronPhononModel, ElectronPhononParameters,
                                                           HolsteinCoupling, PhononMode)
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.models.library import complex_chain_model
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingModel, TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import kpm_mf
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.kpm import averaged_propagator

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]
LATTICES = [pytest.param("chain", 6, id="chain-6"), pytest.param("chain", 7, id="chain-7"),
            pytest.param("honeycomb", 2, id="honeycomb-2")]


def _complex_honeycomb(L, phase=0.7):
    """The Holstein honeycomb with the complex hopping t e^{i phase} on its
    three bonds."""
    uc = UnitCell(lattice_vecs=[[1.5, np.sqrt(3) / 2], [1.5, -np.sqrt(3) / 2]], basis_vecs=[[0.0, 0.0], [1.0, 0.0]])
    geo = ModelGeometry(uc, Lattice(L=[L, L], periodic=[True, True]))
    bonds = [Bond(orbitals=(0, 1), displacement=d) for d in ([0, 0], [-1, 0], [0, -1])]
    for b in bonds:
        geo.add_bond(b)
    tbm = TightBindingModel(geo, bonds, [np.exp(1j * phase)] * 3, [0.0, 0.0], mu=0.1)
    em = ElectronPhononModel(geo, tbm)
    for orb, basis in enumerate(([0.0, 0.0], [1.0, 0.0])):
        p = em.add_phonon_mode(PhononMode(basis, 1.0))
        em.add_holstein_coupling(HolsteinCoupling(p, orb, [0, 0], 0.4, ph_sym_form=True))
    return geo, tbm, em


def _bbar(name, L, symmetric):
    """Bbar (float64) of a complex lattice at a field drawn from a seed."""
    geo, tbm, em = complex_chain_model(L) if name == "chain" else _complex_honeycomb(L)
    rng = np.random.default_rng(0)
    tbp = TightBindingParameters.from_model(tbm, rng, device="cpu")
    elph = ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, device="cpu")
    x = torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal(tuple(elph.x.shape)))
    fdm = FermionDetMatrix.from_path_integral(build_path_integral(tbp, elph, x),
                                              build_checkerboard_structure(tbp.neighbor_table, tbp.n_sites),
                                              symmetric=symmetric)
    assert fdm.complex_hops
    return averaged_propagator(fdm)


@pytest.mark.parametrize("name,L", LATTICES)
@pytest.mark.parametrize("symmetric", SYM)
def test_complex_stage_tables_reproduce_bbar(symmetric, name, L):
    """The channel-mixing stage tables are Bbar / half on a channel pair
    (f64, 1e-12); every table pairs the sites; the folded middle block's
    diagonal s[n] s[p] is real; colors 1.. are Bbar's own tables."""
    bbar = _bbar(name, L, symmetric)
    cb, N = bbar.cb, bbar.expV.shape[0]
    inv_half = 0.37
    A, B, B_im, P, stages = kpm_mf.build_stage_tables_pair(bbar, inv_half)
    n = cb.n_colors
    assert stages == ([abs(s - (n - 1)) for s in range(2 * n - 1)] if symmetric else list(range(n)))
    assert A.shape == B.shape == B_im.shape == P.shape == (n, N) and A.dtype == B_im.dtype == torch.float64
    for t in range(n):
        assert torch.equal(P[t][P[t]], torch.arange(N))
    p0, S0, I0 = cb.partner[0], cb.S[0], cb.S_im[0]
    assert torch.equal(S0 * I0[p0] + I0 * S0[p0], torch.zeros(N, dtype=torch.float64))
    if name == "chain" and L % 2:
        assert bool((cb.partner == torch.arange(N)).any())  # an unpaired site: a pair (n, n)
    if symmetric and n > 1:
        torch.testing.assert_close(B_im[1:], cb.S_im[1:], rtol=0, atol=0)
    u = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 2, 5, N)))
    ref = bbar.apply(u) * inv_half
    got = kpm_mf.apply_stage_tables(A, B, P, stages, u, B_im=B_im)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_stage_table_builders_refuse_the_other_hopping_type():
    """build_stage_tables takes real hoppings, build_stage_tables_pair complex ones."""
    bbar = _bbar("chain", 6, True)
    with pytest.raises(ValueError, match="real hoppings only"):
        kpm_mf.build_stage_tables(bbar, 1.0)
    real = dataclasses.replace(bbar, cb=dataclasses.replace(bbar.cb, S_im=None))
    with pytest.raises(ValueError, match="complex hoppings only"):
        kpm_mf.build_stage_tables_pair(real, 1.0)


def test_complex_stage_tables_refuse_unconjugated_sides():
    """A pair whose two S_im sides are not conjugate would make the folded
    diagonal complex: refused, not dropped."""
    bbar = _bbar("chain", 6, True)
    bad = dataclasses.replace(bbar, cb=dataclasses.replace(bbar.cb, S_im=bbar.cb.S_im.abs()))
    with pytest.raises(ValueError, match="not real"):
        kpm_mf.build_stage_tables_pair(bad, 1.0)


def _staged_pass(ops, t_re, t_im, cim_sign):
    """One Chebyshev pass as K8 computes it: the operands' f32 stage tables,
    t_k = a ((Bbar / half) t - cih t) - b t_prev, every frequency to its own
    live order; (t_re, t_im) (B, F, N)."""
    n_tables = ops.stage_A.shape[0]
    stages = [abs(s - (n_tables - 1)) for s in range(2 * n_tables - 1)] if ops.symmetric else list(range(n_tables))
    P = kpm_mf.unpack_partner16(ops.stage_P)
    y_re, y_im = torch.zeros_like(t_re), torch.zeros_like(t_im)
    for f in range(ops.coefs_re.shape[0]):
        cre, cim = ops.coefs_re[f], cim_sign * ops.coefs_im[f]
        tc = torch.stack([t_re[:, f], t_im[:, f]])  # (2, B, N): the channel pair at axis -3
        tp = torch.zeros_like(tc)
        for k in range(int(ops.orders_host[f])):
            if k > 0:
                w = kpm_mf.apply_stage_tables(ops.stage_A, ops.stage_B, P, stages, tc, B_im=ops.stage_B_im)
                tc, tp = (1.0 if k == 1 else 2.0) * (w - ops.cih * tc) - (0.0 if k == 1 else 1.0) * tp, tc
            y_re[:, f] += cre[k] * tc[0] - cim[k] * tc[1]
            y_im[:, f] += cre[k] * tc[1] + cim[k] * tc[0]
    return y_re, y_im


@pytest.mark.parametrize("symmetric", SYM)
def test_staged_complex_recurrence_matches_jax(symmetric):
    """kpm_mf_cplx's function computed through the complex stage tables (what
    K8 computes) against the JAX package's `_mf_cheb_pair` on the JAX
    preconditioner's state, and against kpm_mf_cplx_plain."""
    jfdm, pfdm, *_ = cplx_fdm_pair(symmetric=symmetric, x_seed=2, **KPM_CHAIN)
    jpre = jkpm.KPMPreconditioner.build(jfdm, jax.random.PRNGKey(8), matrix_free=True)
    ppre = convert.kpm_preconditioner(jpre, device="cpu")
    ops = kpm_mf.build_operands(ppre)
    assert ops.complex_pair and ops.stage_B_im is not None and ops.stage_P.dtype == torch.int16
    assert ops.orders_host.max() > 1
    w = np.random.default_rng(12).standard_normal((2, 2, pfdm.Ltau, pfdm.n_sites)).astype(np.float32)
    u_re, u_im = torch.as_tensor(w[:, 0]), torch.as_tensor(w[:, 1])
    if symmetric:
        got = _staged_pass(ops, u_re, u_im, 0.0)
    else:
        got = _staged_pass(ops, *_staged_pass(ops, u_re, u_im, -1.0), 1.0)
    got = torch.stack(got, dim=1).numpy()
    cre, cim = jpre.coefs_re[0], jpre.coefs_im[0]
    bbar32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jpre.bbar)
    jw = jnp.asarray(w)
    if symmetric:
        ref = jkpm._mf_cheb_pair(jpre, jw, cre, cim, bbar32)
    else:
        ref = jkpm._mf_cheb_pair(jpre, jkpm._mf_cheb_pair(jpre, jw, cre, -cim, bbar32), cre, cim, bbar32)
    tol = 2e-4 if symmetric else 5e-4
    assert _rel(got, np64(ref)) <= tol
    plain = torch.stack(kpm_mf.kpm_mf_cplx_plain(ops, u_re, u_im), dim=1).numpy()
    assert _rel(got, np64(plain)) <= tol
