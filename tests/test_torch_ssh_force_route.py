"""The SSH trajectory force through K2 + K4 (route 'k4'), on the CPU: K4's
SSH form as its plain models compute it (ops/force.py: `planes` and
`force_blocked_plain` with `hops`), the contraction of its hop plane
(`derivatives.ssh_force_from_hops`) inside `fermionic_action_and_force`, and
the route's choice for SSH couplings (`updates.hmc.force_route`).

Tolerances: the hop plane H against the products of the two color walks of
`add_M_derivative_force` in float64, 1e-12 relative to max|H| (the same
products, the walks' colors applied row by row); route 'k4' against route
'plain' in float32, 1e-5 relative to max|force| (the same K2 solution, the
products grouped otherwise). No jax import.
"""

import numpy as np
import pytest
import torch

from smoqyelphqmc_tpu_torch.models.electron_phonon import (
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    PhononMode,
    SSHCoupling,
)
from smoqyelphqmc_tpu_torch.models.library import (
    bssh_chain_model,
    bssh_square_model,
    chain_geometry,
    ossh_chain_model,
    ossh_honeycomb_model,
    ossh_square_model,
)
from smoqyelphqmc_tpu_torch.models.tight_binding import TightBindingModel, TightBindingParameters
from smoqyelphqmc_tpu_torch.ops import derivatives, force, mtm
from smoqyelphqmc_tpu_torch.ops.derivatives import add_M_derivative_force
from smoqyelphqmc_tpu_torch.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, force_route

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def mixed_honeycomb_model(L: int):
    """The optical-SSH honeycomb with a Holstein coupling of the
    particle-hole-symmetric form on each mode (K4's P2 and the Lambda
    term), and the SSH couplings' polynomial to third order with disorder."""
    geo, tbm, _ = ossh_honeycomb_model(L, 1.0, 0.5, 0.0)
    em = ElectronPhononModel(geo, tbm)
    pA = em.add_phonon_mode(PhononMode([0.0, 0.0], 1.0))
    pB = em.add_phonon_mode(PhononMode([1.0, 0.0], 1.2))
    em.add_holstein_coupling(HolsteinCoupling(pA, 0, [0, 0], 0.4, ph_sym_form=True))
    em.add_holstein_coupling(HolsteinCoupling(pB, 1, [0, 0], 0.3, alpha3_mean=0.05, ph_sym_form=True))
    for b in tbm.t_bonds:
        em.add_ssh_coupling(SSHCoupling(phonon_ids=(pA, pB), bond=b, alpha_mean=0.5, alpha_std=0.1,
                                        alpha2_mean=0.08, alpha3_mean=0.03))
    return geo, tbm, em


def complex_ssh_chain_model(L: int):
    """A chain whose SSH constant is complex (a complex fermion matrix)."""
    geo, bond = chain_geometry(L)
    tbm = TightBindingModel(geo, [bond], [1.0], [0.0], mu=0.1)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], 1.0))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=0.4 + 0.25j))
    return geo, tbm, em


MODELS = {
    "ossh_honeycomb": lambda: ossh_honeycomb_model(3, 1.0, 0.5, 0.0),
    "ossh_chain": lambda: ossh_chain_model(8, 1.0, 0.5, 0.1),
    "ossh_square": lambda: ossh_square_model(3, 1.0, 0.5, 0.0),
    "bssh_chain": lambda: bssh_chain_model(8, 1.0, 0.5, 0.0),  # a frozen mode
    "bssh_square": lambda: bssh_square_model(4, 1.0, 0.5, 0.0),  # a frozen mode
    "holstein_ssh": lambda: mixed_honeycomb_model(2),
    "complex_ssh": lambda: complex_ssh_chain_model(8),
}


def _chain(model, **kw):
    """(context, preconditioner, field) of the model at beta 1, dtau 0.1 on
    CPU tensors, the field jittered from its initial value (seed 5)."""
    _, tbm, em = MODELS[model]()
    rng = np.random.default_rng(4)
    tbp = TightBindingParameters.from_model(tbm, rng, device=CPU)
    elph = ElectronPhononParameters.from_model(1.0, 0.1, em, tbp, rng, device=CPU)
    opts = dict(mixed_precision=True, force_dtype="float32", preconditioner="auto")
    opts.update(kw)
    ctx, state = initialize_qmc(tbp, elph, **opts)
    gen = torch.Generator().manual_seed(5)
    x = state.x + 0.3 * torch.randn(state.x.shape, generator=gen, dtype=torch.float64)
    x[torch.as_tensor(elph.frozen_mask)] = state.x[torch.as_tensor(elph.frozen_mask)]
    return ctx, state.precond, x


def _operands(model, W):
    """(context, fermion matrix, Lambda, psi_raw, field), float64: one chain
    at W = 0, else a walker batch of W fields (each its own hop tables),
    psi_raw from a seed."""
    from smoqyelphqmc_tpu_torch.ops.lambda_shift import build_lambda

    ctx, _, x = _chain(model)
    if W:
        gen = torch.Generator().manual_seed(6)
        x = x[None] + 0.1 * torch.randn((W,) + tuple(x.shape), generator=gen, dtype=torch.float64)
    fdm = make_fdm(ctx, x)
    Lam = build_lambda(ctx.elph, x, ctx.n_sites)
    psi = torch.randn(x.shape[:-2] + (2, ctx.Ltau, ctx.n_sites), generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64)
    return ctx, fdm, Lam, psi, x


def _walk_products(ctx, fdm, Lam, psi, x, monkeypatch):
    """The hop products of `add_M_derivative_force`'s two color walks, as
    (n_hops, Ltau) sums over both walks: its SSH terms recorded color by color
    (u = A psi, v = Lambda psi from psi_raw as K4 takes them)."""
    lam_psi = torch.roll(Lam * (torch.roll(psi, 1, dims=-2) / Lam), -1, dims=-2)
    A = fdm.mul_M(lam_psi)
    H = torch.zeros((ctx.structure.n_hops, ctx.Ltau), dtype=psi.dtype)
    seen = []

    def spy(force_, nu, up, vp, fdm_, elph, x, plan, dtau_eff, color):
        grp = plan.ssh_groups[color]
        hops, first = np.unique(grp.hop.numpy(), return_index=True)
        i, j = grp.site_i[first], grp.site_j[first]
        H[hops] += torch.sum(up[..., j] * vp[..., i] + up[..., i] * vp[..., j], dim=0).T
        seen.append(color)
        return force_

    monkeypatch.setattr(derivatives, "_add_ssh_color_force", spy)
    add_M_derivative_force(torch.zeros((ctx.elph.n_phonon, ctx.Ltau), dtype=psi.dtype), -2.0, A, lam_psi, fdm,
                           ctx.elph, x, ctx.plan)
    nc = ctx.structure.n_colors
    assert seen == list(reversed(range(nc))) + list(range(nc))
    return H


@pytest.mark.parametrize("T", [1, 3, None], ids=["T-1", "T-3", "T-Ltau"])
@pytest.mark.parametrize("model", ["ossh_honeycomb", "ossh_chain", "bssh_square", "holstein_ssh"])
def test_hop_plane_matches_the_derivative_walks(model, T, monkeypatch):
    """K4's hop plane, whole planes (`planes`) and tau blocks of T rows
    (`force_blocked_plain`, ragged at T = 3), against the two color walks
    of `add_M_derivative_force` in float64, each hop at its slot; the
    planes P1 and P2 as the Holstein form gives them; 0 at every slot no hop
    takes."""
    ctx, fdm, Lam, psi, x = _operands(model, 0)
    want_p2 = bool(np.any(ctx.elph.hol_ph_sym))
    ref = _walk_products(ctx, fdm, Lam, psi, x, monkeypatch)
    L = ctx.Ltau
    P1, P2, H = force.planes(fdm, Lam, psi, want_p2, hops=True)
    P1b, P2b, n_apply, Hb = force.force_blocked_plain(fdm, Lam, psi, want_p2, L if T is None else T, hops=True)
    slots = torch.as_tensor(mtm.hop_slots(ctx.structure))
    scale = float(ref.abs().max())
    for h in (H, Hb):
        assert h.shape == (L, ctx.structure.n_colors, force.pair_index(ctx.structure, CPU, 8)[0].shape[1])
        flat = h.reshape(L, -1)
        assert float((flat[:, slots].T - ref).abs().max()) <= 1e-12 * scale
        rest = torch.ones(flat.shape[1], dtype=torch.bool)
        rest[slots] = False
        assert not flat[:, rest].any()
    for got, r in zip((P1, P2, P1b, P2b), force.planes(fdm, Lam, psi, want_p2) * 2):
        assert float((got - r).abs().max()) <= 1e-12 * max(float(r.abs().max()), 1e-300)
    assert n_apply == sum(min(T or L, L - l0) + 1 for l0 in range(0, L, T or L))


def test_hop_plane_walker_batch():
    """A walker batch with each walker's own hop tables (ossh honeycomb, W =
    3): the plain models' hop plane is each walker's own, and K4's tables
    refuse the batch (the trajectory launches K4 a walker at a time)."""
    ctx, fdm, Lam, psi, x = _operands("ossh_honeycomb", 3)
    assert fdm.cb.C.dim() == 5
    H = force.planes(fdm, Lam, psi, False, hops=True)[2]
    Hb = force.force_blocked_plain(fdm, Lam, psi, False, 4, hops=True)[3]
    for w in range(3):
        one = make_fdm(ctx, x[w])
        ref = force.planes(one, Lam[w], psi[w], False, hops=True)[2]
        for h in (H, Hb):
            assert float((h[w] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    with pytest.raises(ValueError, match="a walker at a time"):
        force.force_pair_tables(fdm.astype(torch.float32))


@pytest.mark.parametrize("model", ["ossh_honeycomb", "ossh_chain", "ossh_square", "bssh_chain", "bssh_square",
                                   "holstein_ssh"])
def test_route_k4_equals_route_plain(model):
    """fermionic_action_and_force in float32 through K2 + K4's SSH form (its
    plain version on the CPU) against the eager chain: the same solution,
    the same force to 1e-5 of its largest; frozen modes take no force."""
    ctx, precond, x = _chain(model)
    gen = torch.Generator().manual_seed(8)
    R = torch.randn((2, ctx.Ltau, ctx.n_sites), generator=gen, dtype=torch.float64) / np.sqrt(2.0)
    fdm = make_fdm(ctx, x)
    Phi, _ = sample_pseudofermion_fields(R, ctx.elph, fdm, x)
    fdm32 = make_fdm(ctx, x, dtype="float32")
    out = {}
    for route in ("plain", "k4"):
        plain_calls = force.FORCE.plain_calls
        out[route] = fermionic_action_and_force(Phi, ctx.elph, fdm32, x, ctx.plan, precond=precond, tol=1e-6,
                                                maxiter=500, solve_dtype="float32", route=route)
        assert force.FORCE.plain_calls == plain_calls + (route == "k4")
    k4, plain = out["k4"], out["plain"]
    assert bool(k4.stats.converged) and torch.equal(k4.psi_raw, plain.psi_raw)
    scale = float(plain.force.abs().max())
    assert scale > 0 and float((k4.force - plain.force).abs().max()) <= 1e-5 * scale
    frozen = torch.as_tensor(ctx.elph.frozen_mask)
    assert not k4.force[frozen].any() and (model.startswith("bssh") == bool(frozen.any()))


ROUTES = [
    pytest.param("ossh_honeycomb", {}, CUDA, {}, "k4", id="cuda"),
    pytest.param("holstein_ssh", {}, CUDA, {}, "k4", id="cuda-holstein-ssh"),
    pytest.param("ossh_honeycomb", {}, CUDA, {"fused_step_force": True}, "k4", id="cuda-no-k3"),
    pytest.param("ossh_honeycomb", {}, CPU, {}, "plain", id="cpu"),
    pytest.param("ossh_honeycomb", {}, CPU, {"fused_force": True}, "k4", id="cpu-forced-k4"),
    pytest.param("ossh_honeycomb", {}, CUDA, {"fused_force": False}, "plain", id="cuda-forced-plain"),
    pytest.param("complex_ssh", {}, CUDA, {}, "plain", id="cuda-complex"),
    pytest.param("complex_ssh", {}, CUDA, {"fused_force": True}, "plain", id="cuda-complex-forced"),
    pytest.param("ossh_honeycomb", {"force_dtype": "float64"}, CUDA, {}, "plain", id="cuda-f64-forces"),
    pytest.param("ossh_honeycomb", {"symmetric": False}, CUDA, {}, "plain", id="cuda-asymmetric"),
]


@pytest.mark.parametrize("model,opts,device,params,route", ROUTES)
def test_ssh_force_route_follows_the_input(model, opts, device, params, route):
    """SSH couplings take 'k4' on the card (no K3, whatever the walker
    sweep asks) for f32 forces, the symmetric factorization and real
    hoppings, and keep 'plain' on the CPU and for complex constants, f64
    forces and the asymmetric factorization."""
    ctx, precond, _ = _chain(model, **opts)
    assert ctx.elph.n_ssh > 0
    assert force_route(ctx, precond, HMCParams(**params), device) == route


def test_k3_route_refuses_ssh():
    """Route 'k3' on an SSH model raises: K3 has no SSH form."""
    ctx, precond, x = _chain("ossh_chain")
    Phi = torch.zeros((2, ctx.Ltau, ctx.n_sites), dtype=torch.float64)
    with pytest.raises(ValueError, match="no SSH form"):
        fermionic_action_and_force(Phi, ctx.elph, make_fdm(ctx, x), x, ctx.plan, precond=precond,
                                   solve_dtype="float32", route="k3")


def test_plan_slots_cover_the_couplings():
    """Each SSH coupling's slot in K4's hop plane is a pair of its hop's two
    sites in the hop's color; the phonons are p_i then p_f, and each
    phonon's gathered terms are -1 (0 if frozen) of every coupling where it
    is p_i and +1 (0 if frozen) where it is p_f."""
    for model in ("ossh_honeycomb", "bssh_square", "holstein_ssh"):
        ctx, _, _ = _chain(model)
        plan, elph, st = ctx.plan, ctx.elph, ctx.structure
        a, b = force.pair_sites(st, CPU, 8)
        P = a.shape[1]
        slot = plan.ssh_slot.numpy()
        c, q = slot // P, slot % P
        i, j = st.neighbor_table[:, elph.ssh_to_hop]
        assert np.array_equal(np.sort(np.stack([a[c, q], b[c, q]]), 0), np.sort(np.stack([i, j]), 0))
        assert np.array_equal(st.site_hop[c, i], elph.ssh_to_hop)
        p_i, p_f = elph.ssh_to_phonon
        assert np.array_equal(plan.ssh_phonon.numpy(), np.concatenate([p_i, p_f]))
        live = ~elph.frozen_mask
        want, got = np.zeros((elph.n_phonon, elph.n_ssh)), np.zeros((elph.n_phonon, elph.n_ssh))
        np.add.at(want, (p_i, np.arange(elph.n_ssh)), -1.0 * live[p_i])
        np.add.at(want, (p_f, np.arange(elph.n_ssh)), 1.0 * live[p_f])
        rows = np.broadcast_to(np.arange(elph.n_phonon)[:, None], plan.ssh_gather.shape)
        np.add.at(got, (rows, plan.ssh_gather.numpy()), plan.ssh_weight.numpy())
        assert np.array_equal(got, want)

