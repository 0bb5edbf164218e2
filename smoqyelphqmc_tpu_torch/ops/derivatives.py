"""Fermion-matrix derivative forces: force[p, l] += nu * Re <u | dM/dx_{p,l} | v>
(port of the JAX package's ops/derivatives.py).

The derivative of the checkerboard-factorized M is never formed: the walk
goes through the checkerboard colors, moving u' and v' with forward and
inverse color applications, so that each factor's derivative is taken in
its own basis. A color's SSH (hopping-derivative) terms are one gather,
elementwise products and a scatter-add over the couplings of that color; the
Holstein (potential-derivative) term is one pass.

u, v carry a leading complex-channel axis (2, Ltau, N); with real couplings
Re <u|A|v> is the channel sum of elementwise products. The force from the
product planes of kernels K3 / K4 (`holstein_force_from_planes`) and from
K4's hop plane (`ssh_force_from_hops`) takes a leading walker axis."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters
from .checkerboard import CheckerboardStructure
from .fermion_det import FermionDetMatrix, boundary_sign
from .mtm import hop_slots


@dataclasses.dataclass(frozen=True)
class SSHColorGroup:
    """The SSH couplings whose hop lies in one checkerboard color, as long
    tensors on the parameters' device: coupling, hop, the hop's two sites,
    the two phonons, and the finite-mass masks of the phonons (float64;
    frozen phonons take no force)."""

    idx: torch.Tensor
    hop: torch.Tensor
    site_i: torch.Tensor
    site_j: torch.Tensor
    phonon_i: torch.Tensor
    phonon_f: torch.Tensor
    finite_i: torch.Tensor
    finite_f: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ForcePlan:
    """Static grouping of the SSH couplings by checkerboard color (one group
    a color, empty without SSH couplings) and the finite-mass mask of the
    Holstein couplings; for K4's hop plane (`ssh_force_from_hops`) each SSH
    coupling's slot there and its two phonons, and for each phonon the
    couplings it takes a term from with their signed finite-mass masks
    (-finite_i where it is p_i, +finite_f where it is p_f; weight 0 pads a
    row), summed in a fixed order."""

    hol_finite: np.ndarray  # (n_holstein,) float64
    ssh_groups: Tuple[SSHColorGroup, ...] = ()
    ssh_slot: Optional[torch.Tensor] = None  # (n_ssh,) long
    ssh_phonon: Optional[torch.Tensor] = None  # (2 n_ssh,) long: p_i, then p_f
    ssh_gather: Optional[torch.Tensor] = None  # (n_phonon, K) long: coupling indices
    ssh_weight: Optional[torch.Tensor] = None  # (n_phonon, K) float64


def build_force_plan(elph: ElectronPhononParameters, structure: CheckerboardStructure) -> ForcePlan:
    frozen = elph.frozen_mask
    hol_finite = (~frozen[elph.hol_to_phonon]).astype(np.float64) if elph.n_holstein else np.zeros(0)
    groups = []
    hop_plane = {}
    if elph.n_ssh:
        p_i, p_f = elph.ssh_to_phonon
        phonon = np.concatenate([p_i, p_f]).astype(np.int64)
        sign = np.concatenate([-(~frozen[p_i]).astype(np.float64), (~frozen[p_f]).astype(np.float64)])
        # row p of gather / weight: the couplings whose p_i or p_f is p, with their signs (0 pads)
        counts = np.bincount(phonon, minlength=elph.n_phonon)
        order = np.argsort(phonon, kind="stable")
        col = np.arange(phonon.size) - np.repeat(np.cumsum(counts) - counts, counts)
        gather = np.zeros((elph.n_phonon, counts.max()), dtype=np.int64)
        weight = np.zeros(gather.shape)
        gather[phonon[order], col] = order % elph.n_ssh
        weight[phonon[order], col] = sign[order]
        hop_plane = dict(
            ssh_slot=torch.as_tensor(hop_slots(structure)[elph.ssh_to_hop], device=elph.device),
            ssh_phonon=torch.as_tensor(phonon, device=elph.device),
            ssh_gather=torch.as_tensor(gather, device=elph.device),
            ssh_weight=torch.as_tensor(weight, device=elph.device),
        )
        color_of_hop = np.zeros(structure.n_hops, dtype=np.int64)
        for c, (start, stop) in enumerate(structure.color_slices):
            color_of_hop[structure.perm[start:stop]] = c
        dev = elph.device

        def long(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        for c in range(structure.n_colors):
            idx = np.where(color_of_hop[elph.ssh_to_hop] == c)[0]
            hops = elph.ssh_to_hop[idx]
            p_i, p_f = elph.ssh_to_phonon[0, idx], elph.ssh_to_phonon[1, idx]
            groups.append(SSHColorGroup(
                idx=long(idx), hop=long(hops),
                site_i=long(structure.neighbor_table[0, hops]), site_j=long(structure.neighbor_table[1, hops]),
                phonon_i=long(p_i), phonon_f=long(p_f),
                finite_i=torch.as_tensor((~frozen[p_i]).astype(np.float64), device=dev),
                finite_f=torch.as_tensor((~frozen[p_f]).astype(np.float64), device=dev),
            ))
    return ForcePlan(hol_finite=hol_finite, ssh_groups=tuple(groups), **hop_plane)


def _add_ssh_color_force(
    force: torch.Tensor,
    nu: float,
    up: torch.Tensor,
    vp: torch.Tensor,
    fdm: FermionDetMatrix,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
    dtau_eff: float,
    color: int,
) -> torch.Tensor:
    """The SSH kinetic-derivative term of one checkerboard color.

    Real hoppings: the inserted operator is dE_c E_c^{-1} = dtau_eff (dt/dx)
    H0 (H0 the off-diagonal ones). Complex hoppings (complex t0 or complex
    SSH constants): dK_c does not commute with K_c inside a 2x2 hop block,
    so the exact block derivative is used: with t = |t| e^{i theta},
    t_hat = t/|t|, c = cosh(dtau_eff |t|), s = sinh(dtau_eff |t|),

      dE E^{-1} = dtau_eff |t|' H + i theta' (s c G + s^2 Z),
      H = [[0, conj(t_hat)], [t_hat, 0]],  G = [[0, -conj(t_hat)], [t_hat, 0]],
      Z = diag(+1_i, -1_j),   |t|' = Re(conj(t_hat) dt/dx),
      theta' = Im(conj(t_hat) dt/dx) / |t|."""
    grp = plan.ssh_groups[color]
    if grp.idx.numel() == 0:
        return force
    i, j, p, pf, idx = grp.site_i, grp.site_j, grp.phonon_i, grp.phonon_f, grp.idx
    dx = x[pf, :] - x[p, :]  # (n_c, Ltau)

    def dpoly(a1, a2, a3, a4):
        """d(coupling polynomial)/d(dx) = -dt/dx."""
        return (a1[idx][:, None] + 2.0 * a2[idx][:, None] * dx + 3.0 * a3[idx][:, None] * dx**2
                + 4.0 * a4[idx][:, None] * dx**3)

    g_re = dpoly(elph.ssh_alpha, elph.ssh_alpha2, elph.ssh_alpha3, elph.ssh_alpha4)
    if fdm.sinh_hop_im is None:
        prod = torch.sum(up[..., j] * vp[..., i] + up[..., i] * vp[..., j], dim=0)  # (Ltau, n_c)
        val = nu * dtau_eff * g_re * prod.T
    else:
        g_im = (dpoly(elph.ssh_alpha_im, elph.ssh_alpha2_im, elph.ssh_alpha3_im, elph.ssh_alpha4_im)
                if elph.complex_ssh else torch.zeros_like(g_re))
        hops = grp.hop
        sh_re = fdm.sinh_hop[:, hops].T  # (n_c, Ltau)
        sh_im = fdm.sinh_hop_im[:, hops].T
        c = fdm.cosh_hop[:, hops].T
        s = torch.sqrt(sh_re**2 + sh_im**2)
        s_safe = torch.where(s > 0, s, torch.ones_like(s))
        a_re = sh_re / s_safe  # t_hat (1 where the hop vanishes)
        a_im = -sh_im / s_safe
        abs_t = torch.asinh(s) / dtau_eff
        abs_t_safe = torch.where(abs_t > 0, abs_t, torch.ones_like(abs_t))
        dabs = -(a_re * g_re + a_im * g_im)
        dtheta = -(a_re * g_im - a_im * g_re) / abs_t_safe
        dtheta = torch.where(abs_t > 0, dtheta, torch.zeros_like(dtheta))
        u_re, u_im, v_re, v_im = up[0], up[1], vp[0], vp[1]

        def cprod(a, b):  # conj(u_a) v_b as (re, im), (n_c, Ltau)
            return ((u_re[..., a] * v_re[..., b] + u_im[..., a] * v_im[..., b]).T,
                    (u_re[..., a] * v_im[..., b] - u_im[..., a] * v_re[..., b]).T)

        Pji_re, Pji_im = cprod(j, i)
        Pij_re, Pij_im = cprod(i, j)
        _, Dii_im = cprod(i, i)
        _, Djj_im = cprod(j, j)
        term1 = dtau_eff * dabs * (a_re * (Pji_re + Pij_re) - a_im * (Pji_im - Pij_im))
        term2 = -dtheta * s * c * (a_re * (Pji_im - Pij_im) + a_im * (Pji_re + Pij_re))
        term3 = -dtheta * s**2 * (Dii_im - Djj_im)
        val = -nu * (term1 + term2 + term3)
    force = force.index_add(0, p, -val * grp.finite_i.to(val.dtype)[:, None])
    return force.index_add(0, pf, val * grp.finite_f.to(val.dtype)[:, None])


def _add_holstein_V_force(
    force: torch.Tensor,
    nu: float,
    up: torch.Tensor,
    vp: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """Holstein potential-derivative contribution."""
    if elph.n_holstein == 0:
        return force
    sites, phonons = elph.hol_to_site_t, elph.hol_to_phonon_t
    xp = x[phonons, :]
    dV = elph.dtau * (
        elph.hol_alpha[:, None]
        + 2.0 * elph.hol_alpha2[:, None] * xp
        + 3.0 * elph.hol_alpha3[:, None] * xp**2
        + 4.0 * elph.hol_alpha4[:, None] * xp**3
    )
    prod = torch.sum(up[..., sites] * vp[..., sites], dim=0)
    finite = torch.as_tensor(plan.hol_finite, dtype=prod.dtype, device=prod.device)
    val = nu * dV * prod.T * finite[:, None]
    return force.index_add(0, phonons, val)


def add_M_derivative_force(
    force: torch.Tensor,
    nu: float,
    u: torch.Tensor,
    v: torch.Tensor,
    fdm: FermionDetMatrix,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """force += nu * Re <u | dM/dx | v> (both factorizations). u, v: (2,
    Ltau, N); force: (n_phonon, Ltau)."""
    cb = fdm.cb
    n_colors = cb.n_colors
    dtau = elph.dtau
    # v' = B_l (+-v[l-1]): the tau-shifted, sign-fixed column the derivative acts on
    vp = torch.roll(v, 1, dims=-2) * boundary_sign(fdm.Ltau, True, v.dtype, v.device)
    vp = fdm.apply_B(vp)
    up = u

    def walk(force, up, vp, colors, dtau_eff):
        for color in colors:
            force = _add_ssh_color_force(force, -nu, up, vp, fdm, elph, x, plan, dtau_eff, color)
            up = cb.apply_color(up, color)
            vp = cb.apply_color(vp, color, inverse=True)
        return force, up, vp

    if fdm.symmetric:
        # the left factor CB: walk the colors in reverse (u takes CB^dag, v
        # peels CB with the plain inverse)
        if elph.n_ssh > 0:
            force, up, vp = walk(force, up, vp, reversed(range(n_colors)), dtau / 2)
        else:
            up = cb.apply(up, transpose=True)
            vp = cb.apply(vp, inverse=True)
        if elph.n_holstein > 0:
            force = _add_holstein_V_force(force, -nu, up, vp, elph, x, plan)
        if elph.n_ssh > 0:  # the right factor CB^T: walk the colors forward
            up = up * fdm.exp_nV
            vp = vp / fdm.exp_nV
            force, _, _ = walk(force, up, vp, range(n_colors), dtau / 2)
    else:  # B = exp(-dtau V) CB: the potential term, then the kinetic walk
        if elph.n_holstein > 0:
            force = _add_holstein_V_force(force, -nu, up, vp, elph, x, plan)
        if elph.n_ssh > 0:
            up = up * fdm.exp_nV
            vp = vp / fdm.exp_nV
            force, _, _ = walk(force, up, vp, reversed(range(n_colors)), dtau)
    return force


def ssh_force_from_hops(
    force: torch.Tensor,
    H: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """force + the SSH couplings' dS_f/dx from kernel K4's hop plane H
    (..., Ltau, n_colors, P), every coupling at once: H holds each hop's
    products sum_ch (u'_j v'_i + u'_i v'_j) over both color walks of
    `add_M_derivative_force` (u = A psi, v = Lambda psi, both walks at
    dtau / 2), so the coupling's term is 2 (dtau / 2) g(dx) H[slot] with g the
    coupling polynomial's derivative at dx = x_f - x_i, taken from p_i and
    given to p_f (frozen phonons take none). Each phonon sums its terms in
    the plan's order, not by an atomic scatter, so the force is the same
    bits on every run. force and x are (..., n_phonon, Ltau)."""
    n = elph.n_ssh
    if n == 0:
        return force
    xs = x[..., plan.ssh_phonon, :]
    dx = xs[..., n:, :] - xs[..., :n, :]
    a1, a2, a3, a4 = (a[:, None] for a in (elph.ssh_alpha, elph.ssh_alpha2, elph.ssh_alpha3, elph.ssh_alpha4))
    g = a1 + dx * (2.0 * a2 + dx * (3.0 * a3 + dx * (4.0 * a4)))
    val = elph.dtau * g * H.flatten(-2)[..., plan.ssh_slot].transpose(-1, -2)
    return force + torch.sum(val[..., plan.ssh_gather, :] * plan.ssh_weight.to(val.dtype)[:, :, None], dim=-2)


def holstein_force_from_planes(
    P1: torch.Tensor,
    P2: torch.Tensor,
    elph: ElectronPhononParameters,
    x: torch.Tensor,
    Lam: torch.Tensor,
    plan: ForcePlan,
) -> torch.Tensor:
    """dS_f/dx (..., n_phonon, Ltau) from the planes P1, P2 (..., Ltau, N) of
    kernels K3 / K4 (the JAX package's ops/derivatives.py:215-256): P1 carries
    the M-derivative site products, P2 the Lambda-derivative ones; x is
    (..., n_phonon, Ltau) and Lam (..., Ltau, N) with the same leading axes."""
    force = torch.zeros(x.shape[:-2] + (elph.n_phonon, elph.Ltau), dtype=P1.dtype, device=P1.device)
    if elph.n_holstein == 0:
        return force
    sites, phonons = elph.hol_to_site_t, elph.hol_to_phonon_t
    xp = x[..., phonons, :]
    dV = elph.dtau * (
        elph.hol_alpha[:, None]
        + 2.0 * elph.hol_alpha2[:, None] * xp
        + 3.0 * elph.hol_alpha3[:, None] * xp**2
        + 4.0 * elph.hol_alpha4[:, None] * xp**3
    )
    finite = torch.as_tensor(plan.hol_finite, dtype=P1.dtype, device=P1.device)
    val = 2.0 * dV * P1[..., sites].transpose(-1, -2) * finite[:, None]
    force = force.index_add(-2, phonons, val)
    idx = np.where(elph.hol_ph_sym)[0]
    if idx.size:
        idx_t = torch.as_tensor(idx, dtype=torch.long, device=P1.device)
        s_sites, s_phonons = sites[idx_t], phonons[idx_t]
        xs = x[..., s_phonons, :]
        dcoup = 0.5 * elph.dtau * (elph.hol_alpha[idx_t][:, None] + 3.0 * elph.hol_alpha3[idx_t][:, None] * xs**2)
        val2 = -2.0 * (dcoup.transpose(-1, -2) * Lam[..., s_sites] * P2[..., s_sites])
        force = force.index_add(-2, s_phonons, val2.transpose(-1, -2))
    return force
