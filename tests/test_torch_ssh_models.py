"""Parity of the port's SSH and dispersion couplings with the JAX package on
small models built in both packages from the same NumPy seed: the optical-SSH
chain (tests/_models.py:chain_model(ssh=True)), the optical-SSH honeycomb
L=2, the bond-SSH square L=2 with its frozen mode (here with two dispersion
couplings, one of them to the frozen mode), and the chain with the complex
SSH constant 0.4 + 0.25i (tests/test_complex_hoppings.py:242) on real and
on complex hoppings.

Tolerances: every quantity here is an f64 chain of elementwise products,
gathers and scatter-adds, held to 1e-12 of its largest magnitude
(parameter expansion, path integral, M and M^T products, the M-derivative
force in both factorizations, the bosonic action and the dispersive force,
K1's tau-blocked pair stages); the SSH energy from the same R and GR to
1e-10 in f64 and 1e-5 in f32 (f32 products of the estimator's fields, as
tests/test_torch_measure.py holds the other measurements).

Also here: the gate that keeps kernels K3 and K4 (Holstein force planes)
off a model with SSH couplings, and the walker path at W = 2 with complex
SSH constants.
"""

import dataclasses
import os
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smoqyelphqmc_tpu as J
import smoqyelphqmc_tpu_torch as P
from _torch_common import np64, t64

from smoqyelphqmc_tpu.io import simulation_info as jsi
from smoqyelphqmc_tpu.measure import greens_estimator as jge
from smoqyelphqmc_tpu.measure import local_measurements as jlm
from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral as jbuild
from smoqyelphqmc_tpu.ops import bosonic as jbos
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure as jstruct
from smoqyelphqmc_tpu.ops.derivatives import add_M_derivative_force as jforce
from smoqyelphqmc_tpu.ops.derivatives import build_force_plan as jplan
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix as JFdm
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.driver import SimulationConfig, run_updates
from smoqyelphqmc_tpu_torch.io import simulation_info as psi
from smoqyelphqmc_tpu_torch.measure import local_measurements as plm
from smoqyelphqmc_tpu_torch.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu_torch.ops import bosonic as pbos
from smoqyelphqmc_tpu_torch.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu_torch.ops.derivatives import add_M_derivative_force, build_force_plan
from smoqyelphqmc_tpu_torch.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu_torch.ops.force import FORCE
from smoqyelphqmc_tpu_torch.ops.mtm import mtm_blocked_plain, mtm_plain, mtm_tables, pair_tables
from smoqyelphqmc_tpu_torch.ops.pcg_force import PCG_FORCE
from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
from smoqyelphqmc_tpu_torch.ops.spectral_precond import build_spectral
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm
from smoqyelphqmc_tpu_torch.updates.hmc import k3_trajectory_applies

torch.set_num_threads(2)

KINDS = ["ossh_chain", "ossh_honeycomb", "bssh_square_disp", "complex_ssh_chain", "complex_ssh_flux_chain"]
# (beta, dtau) of each model
SHAPES = {"ossh_chain": (0.8, 0.1), "ossh_honeycomb": (0.6, 0.1), "bssh_square_disp": (0.6, 0.1),
          "complex_ssh_chain": (0.6, 0.1), "complex_ssh_flux_chain": (0.6, 0.1)}


def _chain(ns, L):
    geo = ns.ModelGeometry(ns.UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]]), ns.Lattice(L=[L], periodic=[True]))
    bond = ns.Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    return geo, bond


def build(ns, kind, seed=0, L=None):
    """(geometry, tight-binding model, tbp, electron-phonon model, elph) of
    one model in package `ns` (smoqyelphqmc_tpu or smoqyelphqmc_tpu_torch),
    expanded from np.random.default_rng(seed)."""
    beta, dtau = SHAPES[kind]
    if kind == "ossh_chain":  # tests/_models.py:chain_model(L=6, beta=0.8, alpha=0.4, ssh=True)
        geo, bond = _chain(ns, L or 6)
        tbm = ns.TightBindingModel(geo, [bond], [1.0], [0.0], mu=0.1)
        em = ns.ElectronPhononModel(geo, tbm)
        p = em.add_phonon_mode(ns.PhononMode([0.0], 1.0))
        em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.4))
    elif kind == "ossh_honeycomb":  # examples/_common.py:ossh_honeycomb_model
        uc = ns.UnitCell(lattice_vecs=[[1.5, np.sqrt(3) / 2], [1.5, -np.sqrt(3) / 2]],
                         basis_vecs=[[0.0, 0.0], [1.0, 0.0]])
        geo = ns.ModelGeometry(uc, ns.Lattice(L=[L or 2] * 2, periodic=[True, True]))
        bonds = [ns.Bond(orbitals=(0, 1), displacement=d) for d in ([0, 0], [-1, 0], [0, -1])]
        for b in bonds:
            geo.add_bond(b)
        tbm = ns.TightBindingModel(geo, bonds, [1.0] * 3, [0.0, 0.0], mu=0.0)
        em = ns.ElectronPhononModel(geo, tbm)
        pa = em.add_phonon_mode(ns.PhononMode([0.0, 0.0], 1.0))
        pb = em.add_phonon_mode(ns.PhononMode([1.0, 0.0], 1.0))
        for b in bonds:
            em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(pa, pb), bond=b, alpha_mean=0.5))
    elif kind == "bssh_square_disp":  # examples/_common.py:bssh_square_model + dispersion
        geo = ns.ModelGeometry(ns.UnitCell(lattice_vecs=[[1.0, 0.0], [0.0, 1.0]], basis_vecs=[[0.0, 0.0]]),
                               ns.Lattice(L=[L or 2] * 2, periodic=[True, True]))
        bx, by = ns.Bond(orbitals=(0, 0), displacement=[1, 0]), ns.Bond(orbitals=(0, 0), displacement=[0, 1])
        geo.add_bond(bx)
        geo.add_bond(by)
        tbm = ns.TightBindingModel(geo, [bx, by], [1.0, 1.0], [0.0], mu=0.0)
        em = ns.ElectronPhononModel(geo, tbm)
        px = em.add_phonon_mode(ns.PhononMode([0.5, 0.0], 1.0))
        py = em.add_phonon_mode(ns.PhononMode([0.0, 0.5], 1.0))
        frozen = em.add_phonon_mode(ns.PhononMode([0.0, 0.0], 1.0, M=np.inf))
        em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(frozen, px), bond=bx, alpha_mean=0.5))
        em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(frozen, py), bond=by, alpha_mean=0.5))
        em.add_dispersion_coupling(ns.DispersionCoupling(phonon_ids=(px, px), displacement=[1, 0], Omega_mean=0.5))
        em.add_dispersion_coupling(ns.DispersionCoupling(phonon_ids=(py, frozen), displacement=[0, 1],
                                                         Omega_mean=0.3, Omega4_mean=0.05))
    else:  # tests/test_complex_hoppings.py:complex_ssh_chain_model, t_phase 0 and 0.5
        geo, bond = _chain(ns, L or 4)
        t0 = np.exp(0.5j) if kind == "complex_ssh_flux_chain" else 1.0
        tbm = ns.TightBindingModel(geo, [bond], [t0], [0.0], mu=0.1)
        em = ns.ElectronPhononModel(geo, tbm)
        p = em.add_phonon_mode(ns.PhononMode([0.0], 1.0))
        em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.4 + 0.25j))
    kw = {} if ns is J else {"device": "cpu"}
    rng = np.random.default_rng(seed)
    tbp = ns.TightBindingParameters.from_model(tbm, rng, **kw)
    elph = ns.ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng, **kw)
    return geo, tbm, tbp, em, elph


def both(kind, **kw):
    return build(J, kind, **kw), build(P, kind, **kw)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def field(elph, seed, scale=0.3):
    return scale * np.random.default_rng(seed).standard_normal(np64(elph.x).shape)


def fdms(kind, x, symmetric=True, L=None):
    """The JAX and port fermion matrices of one model at field x, and both
    packages' (tbp, elph)."""
    (_, _, jtbp, _, jelph), (_, _, ptbp, _, pelph) = both(kind, L=L)
    nt = np.asarray(ptbp.neighbor_table)
    jf = JFdm.from_path_integral(jbuild(jtbp, jelph, x=jnp.asarray(x)), jstruct(nt, jtbp.n_sites),
                                 symmetric=symmetric)
    pf = FermionDetMatrix.from_path_integral(build_path_integral(ptbp, pelph, t64(x)),
                                             build_checkerboard_structure(nt, ptbp.n_sites), symmetric=symmetric)
    return jf, pf, (jtbp, jelph), (ptbp, pelph)


FLOAT_FIELDS = ("x", "Omega", "Omega4", "mass", "hol_alpha", "ssh_alpha", "ssh_alpha2", "ssh_alpha3", "ssh_alpha4",
                "ssh_alpha_im", "ssh_alpha2_im", "ssh_alpha3_im", "ssh_alpha4_im", "disp_Omega", "disp_Omega4")
INDEX_FIELDS = ("hol_to_phonon", "hol_to_site", "ssh_to_phonon", "ssh_to_hop", "disp_to_phonon", "frozen_mask")


@pytest.mark.parametrize("kind", KINDS)
def test_parameter_expansion_matches(kind):
    """Every field of the expanded parameters, from the same seed with
    disorder on the SSH and dispersion constants, and through convert."""
    (_, _, _, _, jelph), (_, _, _, _, pelph) = both(kind)
    assert (pelph.n_ssh, pelph.n_dispersion) == (jelph.n_ssh, jelph.n_dispersion) and pelph.n_ssh > 0
    assert pelph.complex_ssh == (jelph.ssh_alpha_im is not None) == kind.startswith("complex")
    conv = convert.electron_phonon_parameters(jelph, device="cpu")
    for name in FLOAT_FIELDS:
        ref = getattr(jelph, name)
        for got in (getattr(pelph, name), getattr(conv, name)):
            if ref is None:
                assert got is None, name
                continue
            g, r = got.numpy(), np64(ref)
            assert g.shape == r.shape and np.array_equal(np.isinf(g), np.isinf(r)), name
            fin = np.isfinite(r)
            assert np.max(np.abs(g[fin] - r[fin]), initial=0.0) <= 1e-12 * max(np.max(np.abs(r[fin]), initial=0), 1), name
    for name in INDEX_FIELDS:
        for got in (getattr(pelph, name), getattr(conv, name)):
            np.testing.assert_array_equal(got, np.asarray(getattr(jelph, name)), err_msg=name)


def test_ssh_disorder_draws_match():
    """Disordered SSH and dispersion constants take the JAX package's draws."""
    def model(ns):
        geo, bond = _chain(ns, 5)
        tbm = ns.TightBindingModel(geo, [bond], [1.0], [0.0], mu=0.0)
        em = ns.ElectronPhononModel(geo, tbm)
        p = em.add_phonon_mode(ns.PhononMode([0.0], 1.0, Omega_std=0.1))
        em.add_ssh_coupling(ns.SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.3 + 0.1j, alpha_std=0.05,
                                           alpha3_mean=0.02, alpha3_std=0.01))
        em.add_dispersion_coupling(ns.DispersionCoupling(phonon_ids=(p, p), displacement=[2], Omega_mean=0.4,
                                                         Omega_std=0.02, Omega4_mean=0.1, Omega4_std=0.01))
        kw = {} if ns is J else {"device": "cpu"}
        rng = np.random.default_rng(11)
        tbp = ns.TightBindingParameters.from_model(tbm, rng, **kw)
        return ns.ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, **kw)

    jelph, pelph = model(J), model(P)
    for name in FLOAT_FIELDS:
        ref = getattr(jelph, name)
        if ref is not None:
            np.testing.assert_allclose(getattr(pelph, name).numpy(), np64(ref), rtol=1e-13, atol=0, err_msg=name)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("kind", KINDS)
def test_path_integral_and_M_products(kind, symmetric):
    """V, t, t_im at a field x != 0 (tau rows that differ), the propagator
    factors and M, M^T on channel pairs; a walker batch gives each walker
    its own hopping rows."""
    (_, _, _, _, jelph0), _ = both(kind)
    x = field(jelph0, 1)
    jf, pf, (jtbp, jelph), (ptbp, pelph) = fdms(kind, x, symmetric)
    jfpi, pfpi = jbuild(jtbp, jelph, x=jnp.asarray(x)), build_path_integral(ptbp, pelph, t64(x))
    assert not pfpi.static_hops and not pf.static_hops
    assert float((pfpi.t - pfpi.t[:1]).abs().max()) > 1e-3
    for a, b in ((pfpi.V, jfpi.V), (pfpi.t, jfpi.t), (pf.cosh_hop, jf.cosh_hop), (pf.sinh_hop, jf.sinh_hop),
                 (pf.cb.C, jf.cb.C), (pf.cb.S, jf.cb.S), (pf.exp_nV, jf.exp_nV)):
        assert rel_err(a.numpy(), np64(b)) <= 1e-12
    assert (pfpi.t_im is None) == (jfpi.t_im is None) == (not kind.startswith("complex"))
    if pfpi.t_im is not None:
        assert rel_err(pfpi.t_im.numpy(), np64(jfpi.t_im)) <= 1e-12
        assert rel_err(pf.cb.S_im.numpy(), np64(jf.cb.S_im)) <= 1e-12
    v = np.random.default_rng(2).standard_normal((2, pf.Ltau, pf.n_sites))
    for mul in ("mul_M", "mul_Mt"):
        assert rel_err(getattr(pf, mul)(t64(v)).numpy(), np64(getattr(jf, mul)(jnp.asarray(v)))) <= 1e-12
    x2 = np.stack([x, field(jelph0, 5)])
    batch = build_path_integral(ptbp, pelph, t64(x2))
    assert batch.t.shape == (2, pf.Ltau, ptbp.n_hops)
    for w in range(2):
        one = build_path_integral(ptbp, pelph, t64(x2[w]))
        assert torch.equal(batch.t[w], one.t) and torch.equal(batch.V.expand((2,) + one.V.shape)[w], one.V)
        if one.t_im is not None:
            assert torch.equal(batch.t_im[w], one.t_im)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("kind", KINDS)
def test_M_derivative_force_matches(kind, symmetric):
    """force += nu Re <u | dM/dx | v> for random u, v: the SSH colour walks
    of both factorizations, the complex 2x2 block derivative, frozen modes
    masked (their rows stay zero)."""
    (_, _, _, _, jelph0), _ = both(kind)
    x = field(jelph0, 3)
    jf, pf, (jtbp, jelph), (ptbp, pelph) = fdms(kind, x, symmetric)
    rng = np.random.default_rng(4)
    u, v = rng.standard_normal((2, 2, pf.Ltau, pf.n_sites))
    ref = np64(jforce(jnp.zeros(x.shape), -2.0, jnp.asarray(u), jnp.asarray(v), jf, jelph, jnp.asarray(x),
                      jplan(jelph, jf.structure)))
    got = add_M_derivative_force(torch.zeros(x.shape, dtype=torch.float64), -2.0, t64(u), t64(v), pf, pelph, t64(x),
                                 build_force_plan(pelph, pf.structure)).numpy()
    assert np.max(np.abs(ref)) > 1e-3 and rel_err(got, ref) <= 1e-12
    if pelph.frozen_mask.any():
        assert np.all(got[pelph.frozen_mask] == 0.0)


def test_bosonic_action_and_dispersive_force():
    """The dispersion terms (one pair with a frozen member: the live mass)
    in the action and its force, alone and over a leading walker axis."""
    (_, _, _, _, jelph), (_, _, _, _, pelph) = both("bssh_square_disp")
    x = field(jelph, 6, scale=0.5)
    S_ref = float(jbos.bosonic_action(jelph, jnp.asarray(x)))
    assert abs(float(pbos.bosonic_action(pelph, t64(x))) - S_ref) <= 1e-12 * abs(S_ref)
    np.testing.assert_allclose(pbos._reduced_mass(pelph).numpy(), np64(jbos._reduced_mass(jelph)), rtol=1e-15)
    ref = np64(jbos.add_dispersive_force(jnp.zeros(x.shape), jelph, jnp.asarray(x)))
    got = pbos.add_dispersive_force(torch.zeros(x.shape, dtype=torch.float64), pelph, t64(x)).numpy()
    assert np.max(np.abs(ref)) > 1e-3 and rel_err(got, ref) <= 1e-12
    x2 = np.stack([x, field(jelph, 7, scale=0.5)])
    S2 = pbos.bosonic_action(pelph, t64(x2))
    f2 = pbos.add_dispersive_force(torch.zeros(x2.shape, dtype=torch.float64), pelph, t64(x2))
    for w in range(2):
        assert float(S2[w]) == pytest.approx(float(pbos.bosonic_action(pelph, t64(x2[w]))), rel=1e-14)
        np.testing.assert_array_equal(f2[w].numpy(),
                                      pbos.add_dispersive_force(torch.zeros(x.shape, dtype=torch.float64), pelph,
                                                                t64(x2[w])).numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["ossh_honeycomb", "bssh_square_disp", "complex_ssh_flux_chain"])
def test_ssh_and_dispersion_energies_match(kind, dtype):
    """measure_ssh_energy of every coupling type and measure_dispersion_energy
    from the same R and GR (random fields) and x."""
    (jg, _, jtbp, _, jelph), (pg, _, ptbp, _, pelph) = both(kind)
    x = field(jelph, 8)
    jest = jge.build_greens_estimator(jelph.Ltau, jg.n_orbitals, jg.L, Nrv=3, dtype=dtype)
    rng = np.random.default_rng(9)
    R, GR = rng.standard_normal((2,) + tuple(np.asarray(jest.R).shape))
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    jest = dataclasses.replace(jest, R=jnp.asarray(R, jdt), GR=jnp.asarray(GR, jdt))
    pest = convert.greens_estimator(jest, device="cpu")
    tol = 1e-10 if dtype == "float64" else 1e-5
    for s in range(pelph.n_ssh // pelph.n_cells):
        re, im = jlm.measure_ssh_energy(jest, jelph, jtbp, jnp.asarray(x), s)
        ref = float(re) + 1j * float(im)
        got = complex(plm.measure_ssh_energy(pest, pelph, ptbp, t64(x), s))
        assert abs(got - ref) <= tol * abs(ref), s
    for d in range(pelph.n_dispersion // pelph.n_cells):
        ref = float(jlm.measure_dispersion_energy(jelph, jnp.asarray(x), d))
        assert float(plm.measure_dispersion_energy(pelph, t64(x), d)) == pytest.approx(ref, rel=1e-12)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("kind", ["ossh_chain", "ossh_honeycomb", "bssh_square_disp"])
def test_mtm_blocked_pairs_on_tau_tables(kind, symmetric):
    """K1's algebra on tables whose tau rows differ: its pair tables carry
    one row a tau row, and the tau-blocked pair stages (mtm_blocked_plain
    with pairs) equal M^T M for T = 1, 2, 3 and Ltau, ragged last blocks
    included (K1's memory form)."""
    (_, _, _, _, jelph0), _ = both(kind)
    _, pf, _, _ = fdms(kind, field(jelph0, 10), symmetric)
    _, C, S, _ = pair_tables(pf)
    assert C.shape[1] == pf.Ltau and float((C - C[:, :1]).abs().max()) > 1e-4
    v = t64(np.random.default_rng(11).standard_normal((2, pf.Ltau, pf.n_sites)))
    ref = mtm_plain(pf, v)
    for T in (1, 2, 3, pf.Ltau):
        got, _ = mtm_blocked_plain(pf, v, T, pairs=True)
        assert rel_err(got.numpy(), ref.numpy()) <= 1e-12, T


def test_table_caches_follow_the_matrix():
    """K1 / K2's tables are cached on the fermion matrix object: a matrix at
    another field, built fresh or by dataclasses.replace from a matrix whose
    tables are cached, gets its own tables."""
    (_, _, _, _, jelph), _ = both("ossh_honeycomb")
    _, f1, _, _ = fdms("ossh_honeycomb", field(jelph, 20))
    _, f2, _, _ = fdms("ossh_honeycomb", field(jelph, 21))
    t1 = mtm_tables(f1)
    _, C1, _, _ = pair_tables(f1)
    swapped = dataclasses.replace(f1, cb=f2.cb, cosh_hop=f2.cosh_hop, sinh_hop=f2.sinh_hop, exp_nV=f2.exp_nV)
    for f in (f2, swapped):
        t, (_, C, _, _) = mtm_tables(f), pair_tables(f)
        assert torch.equal(t[0], f2.cb.C) and not torch.equal(t[0], t1[0]) and not torch.equal(C, C1)


def test_holstein_kernels_gated_off_ssh():
    """Kernels K3 and K4 compute the Holstein force planes: with SSH
    couplings fused_step and fused_force must not reach them (their plain
    versions count no call) and the force is the plain chain's; the HMC gate
    of K3 says no."""
    _, _, ptbp, _, pelph = build(P, "ossh_honeycomb")
    ctx, state = initialize_qmc(ptbp, pelph, mixed_precision=True, force_dtype="float32", preconditioner="spectral")
    assert not k3_trajectory_applies(ctx, state.precond)
    x = state.x
    fdm = make_fdm(ctx, x)
    R = t64(np.random.default_rng(12).standard_normal((2, ctx.Ltau, ctx.n_sites)) / np.sqrt(2.0))
    Phi, _ = sample_pseudofermion_fields(R, pelph, fdm, x)
    pre = build_spectral(fdm)
    calls = (PCG_FORCE.plain_calls, FORCE.plain_calls)
    res = [fermionic_action_and_force(Phi, pelph, make_fdm(ctx, x, dtype="float32"), x, ctx.plan, precond=pre,
                                      tol=1e-5, solve_dtype="float32", fused_step=fs, fused_force=ff)
           for fs, ff in ((True, True), (False, True), (False, False))]
    assert (PCG_FORCE.plain_calls, FORCE.plain_calls) == calls
    assert float(res[-1].force.abs().max()) > 1e-3
    for r in res[:2]:
        assert torch.equal(r.force, res[-1].force)


def test_complex_ssh_walkers_run():
    """Complex SSH constants on real hoppings make M complex: the walker
    path runs them at W = 2 with the doubled-basis spectral preconditioner,
    with the shared refresh and per walker, as it runs them at W = 1."""
    _, tbm, _, em, _ = build(P, "complex_ssh_chain")
    cfg = SimulationConfig(beta=0.6, dtau=0.1, Nt=4, n_walkers=2)
    for shared in (True, False):
        md = run_updates(tbm, em, dataclasses.replace(cfg, shared_precond=shared), 1, device="cpu")
        assert md["all_converged"] and md["walker_converged"] == [True, True]
        assert np.isfinite(md["hmc_delta_H"]).all() and md["precond_fallback_sweeps"] == (0 if shared else 1)
    md = run_updates(tbm, em, dataclasses.replace(cfg, n_walkers=1), 1, device="cpu")
    assert md["all_converged"] and np.isfinite(md["hmc_delta_H"][0])


def test_model_summary_ssh_sections(tmp_path):
    """model_summary.toml of an SSH and dispersion model: both packages
    write the same tree."""
    trees = []
    for tag, ns, si in (("jax", J, jsi), ("port", P, psi)):
        geo, tbm, _, em, _ = build(ns, "bssh_square_disp")
        info = si.SimulationInfo(filepath=str(tmp_path / tag), datafolder_prefix="run", sID=1)
        si.initialize_datafolder(info)
        si.model_summary(info, 0.6, 0.1, geo, tbm, (em,))
        with open(os.path.join(info.datafolder, "model_summary.toml"), "rb") as fh:
            trees.append(tomllib.load(fh))
    assert trees[0] == trees[1]
    assert len(trees[1]["electron_phonon"]["ssh_couplings"]) == 2
    assert len(trees[1]["electron_phonon"]["dispersion_couplings"]) == 2
