"""Plain PyTorch reference of one measured sweep of an electron-phonon
model with Holstein and optical-SSH couplings.

This file imports nothing of the program under test. It rebuilds from the
configuration what the program derives (the lattice's hops and their
checkerboard colours, exp(-dtau V), the hoppings the SSH couplings modulate,
the shift matrix Lambda, the exact Fourier-accelerated leapfrog) and replays
one measured sweep of each walker from a state and a random-generator state:
a reflection move, a swap move, with `Settings.radial` a radial move, an HMC
trajectory (each a Metropolis decision), then the Green's-estimator refresh
and the measurements compared (the time-displaced Green's function and the
density).

Definitions (one walker; fields are (Ltau, N) planes, phonon fields
(n_phonon, Ltau)):

  t_h(x_l) = t0_h - sum_{SSH c on h} alpha_c (x_{final_c, l} - x_{initial_c, l})
  B_l = CB_l exp(-dtau V_l) CB_l^T,  CB_l = product of the colours' exact hop
        rotations exp(dtau/2 t_h(x_l) (c_i^+ c_j + h.c.)), colour 0 applied first
  M v [l] = v[l] - B_l v[l-1] (l >= 1),   M v [0] = v[0] + B_0 v[Ltau-1]
  S_f(x) = rhs^T (M^T M)^{-1} rhs,  rhs[l] = Phi[l+1] / Lambda[l+1]
  Lambda[l, i] = s_l exp(dtau/2 sum alpha x) over the Holstein couplings,
        s_0 = 1, s_l = -1
  Phi = Lambda (.) roll(M^T R, +1) at the field the pseudofermions are drawn at

The force dS_f/dx is taken by autograd of 2 psi.rhs(x) - |M(x) psi|^2 with
psi = (M^T M)^{-1} rhs held fixed, which has the gradient of S_f; each kick's
solve starts from the previous kick's solution. Solves are
conjugate gradients in float64 preconditioned by the tau-averaged propagator
of the bare hoppings t0 (exact in its eigenbasis and antiperiodic
frequencies); the preconditioner moves iteration counts only. The radial
move scales every field by e^gamma, gamma = z / sqrt(d) over the d = n_phonon
Ltau fields, and weighs its acceptance by the Jacobian term d gamma.

`precision` selects the operand precision of the fermion operator: "exact"
keeps every table (exp(-dtau V) and, with SSH couplings, the per-slice hop
rotations) in float64; "config" rounds the force and measurement
solves' tables to the float32 the configuration states, at the program's
tolerances (1e-5 for forces, 2e-5 for the refresh); "control" rounds them one
step below, to bfloat16 (the step a kernel of those float32 solves would
take), and keeps the float64 action the Metropolis decisions rest on. Every
mode solves in float64 arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

F64 = torch.float64
_LOWER = {"float32": torch.bfloat16}


def greedy_colors(neighbor_table: np.ndarray) -> List[List[int]]:
    """Hops in colours: each hop, in table order, joins the first colour that
    touches neither of its sites (greedy edge colouring)."""
    colors: List[List[int]] = []
    sites: List[set] = []
    for h in range(neighbor_table.shape[1]):
        i, j = int(neighbor_table[0, h]), int(neighbor_table[1, h])
        for c, s in enumerate(sites):
            if i not in s and j not in s:
                s.update((i, j))
                colors[c].append(h)
                break
        else:
            sites.append({i, j})
            colors.append([h])
    return colors


def _empty(dtype=np.float64, shape=(0,)):
    return dataclasses.field(default_factory=lambda: np.zeros(shape, dtype=dtype))


@dataclasses.dataclass
class ElPhModel:
    """An electron-phonon model on a lattice of cells: hops (2, n_hops) with
    real bare amplitudes t, on-site energies eps (N,), cells L (C order, site
    = cell * n_orb + orbital), phonon p = type * n_cells + cell with mass and
    Omega, Holstein couplings (phonon, site, alpha, particle-hole form) and
    SSH couplings (hop, (initial, final) phonon pair, alpha), each linear in
    the fields with a real constant. Every mode is live: a frozen one (infinite
    mass, as bond-SSH models have) is refused."""

    neighbor_table: np.ndarray
    t: np.ndarray
    eps: np.ndarray
    L: tuple
    n_orb: int
    mass: np.ndarray
    Omega: np.ndarray
    n_types: int
    hol_phonon: np.ndarray = _empty(np.int64)
    hol_site: np.ndarray = _empty(np.int64)
    hol_alpha: np.ndarray = _empty()
    hol_ph_sym: np.ndarray = _empty(bool)
    ssh_hop: np.ndarray = _empty(np.int64)
    ssh_phonon: np.ndarray = _empty(np.int64, (2, 0))
    ssh_alpha: np.ndarray = _empty()

    def __post_init__(self):
        if not np.all(np.isfinite(self.mass)):
            raise ValueError("the reference replays live phonon modes only: a frozen mode (infinite mass, "
                             "bond SSH) is not replayed")
        for name in ("t", "eps", "hol_alpha", "ssh_alpha"):
            if np.iscomplexobj(getattr(self, name)):
                raise ValueError(f"the reference replays real {name} only: complex values are not replayed")

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.L))

    @property
    def n_sites(self) -> int:
        return self.n_cells * self.n_orb

    @property
    def n_phonon(self) -> int:
        return self.n_types * self.n_cells

    @property
    def n_ssh(self) -> int:
        return int(self.ssh_hop.shape[0])


@dataclasses.dataclass
class Settings:
    """The sweep's settings from the configuration file."""

    beta: float
    dtau: float
    mu: float
    Nt: int
    jitter: float
    tol: float
    Nrv: int
    kpm: bool  # the program draws a Lanczos start vector after each trajectory's draws
    radial: bool = False  # a radial move after the swap move

    @property
    def Ltau(self) -> int:
        return int(round(self.beta / self.dtau))


class Operator:
    """The fermion operator's tables for a batch of fields x (W, n_phonon, Ltau)."""

    def __init__(self, model: ElPhModel, s: Settings, device):
        self.model, self.s, self.device = model, s, torch.device(device)
        N, Lt = model.n_sites, s.Ltau
        nt = model.neighbor_table
        colors = greedy_colors(nt)
        partner = np.tile(np.arange(N), (len(colors), 1))
        site_hop = np.zeros((len(colors), N), dtype=np.int64)
        covered = np.zeros((len(colors), N), dtype=bool)
        for c, hops in enumerate(colors):
            for h in hops:
                i, j = int(nt[0, h]), int(nt[1, h])
                partner[c, i], partner[c, j] = j, i
                site_hop[c, i] = site_hop[c, j] = h
                covered[c, i] = covered[c, j] = True
        self.partner = torch.as_tensor(partner, dtype=torch.long, device=self.device)
        self.site_hop = torch.as_tensor(site_hop, dtype=torch.long, device=self.device)
        self.cov = torch.as_tensor(covered, device=self.device)
        self.t0 = torch.as_tensor(model.t, dtype=F64, device=self.device)
        self.C, self.S = self._planes(self.t0[self.site_hop])  # of the bare hoppings t0
        self.ssh_hop = torch.as_tensor(model.ssh_hop, dtype=torch.long, device=self.device)
        self.ssh_phonon = torch.as_tensor(model.ssh_phonon, dtype=torch.long, device=self.device)
        self.ssh_alpha = torch.as_tensor(model.ssh_alpha, dtype=F64, device=self.device)
        self.hol_phonon = torch.as_tensor(model.hol_phonon, dtype=torch.long, device=self.device)
        self.hol_site = torch.as_tensor(model.hol_site, dtype=torch.long, device=self.device)
        self.hol_alpha = torch.as_tensor(model.hol_alpha, dtype=F64, device=self.device)
        self.ph_sym = torch.as_tensor(model.hol_ph_sym, device=self.device)
        self.eps = torch.as_tensor(model.eps, dtype=F64, device=self.device)
        self.mass = torch.as_tensor(model.mass, dtype=F64, device=self.device)
        self.Omega = torch.as_tensor(model.Omega, dtype=F64, device=self.device)
        sign = torch.full((Lt, 1), -1.0, dtype=F64, device=self.device)
        sign[0] = 1.0
        self.lam_sign = sign
        self.first_sign = sign  # +1 on row 0 (M)
        last = torch.full((Lt, 1), -1.0, dtype=F64, device=self.device)
        last[-1] = 1.0
        self.last_sign = last  # +1 on row Ltau-1 (M^T)

    # -- tables --------------------------------------------------------------
    def _site_sum(self, x: torch.Tensor, coef: torch.Tensor, mask=None) -> torch.Tensor:
        """(W, Ltau, N): sum over couplings c -> site of coef_c x_{phonon_c}."""
        vals = coef[:, None] * x[:, self.hol_phonon, :]
        if mask is not None:
            vals = vals * mask[:, None]
        out = torch.zeros(x.shape[0], self.model.n_sites, x.shape[-1], dtype=x.dtype, device=x.device)
        out = out.index_add(1, self.hol_site, vals)
        return out.transpose(1, 2)

    def _planes(self, ts: torch.Tensor):
        """The colours' planes (C, S) = (cosh, sinh)(dtau/2 t) of the hop
        amplitudes ts (..., n_colors, N) on each site's hop, (1, 0) where a
        colour leaves a site out."""
        half = self.s.dtau / 2.0
        C = torch.where(self.cov, torch.cosh(half * ts), torch.ones_like(ts))
        S = torch.where(self.cov, torch.sinh(half * ts), torch.zeros_like(ts))
        return C, S

    def hoppings(self, x: torch.Tensor) -> torch.Tensor:
        """t_h(x_l) = t0_h - sum_{SSH c on h} alpha_c (x_final - x_initial)
        (W, Ltau, n_hops) of fields x (W, n_phonon, Ltau)."""
        dx = x[:, self.ssh_phonon[1], :] - x[:, self.ssh_phonon[0], :]
        shift = torch.zeros(x.shape[0], self.t0.shape[0], x.shape[-1], dtype=x.dtype, device=x.device)
        shift = shift.index_add(1, self.ssh_hop, self.ssh_alpha[:, None] * dx)
        return (self.t0[:, None] - shift).transpose(1, 2)

    def tables(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """(E, C, S): E = exp(-dtau V) (W, 1, Ltau, N) and the colours' planes,
        (n_colors, N) of the bare hoppings or, with SSH couplings, slice l's
        in row l, (n_colors, W, 1, Ltau, N); rounded to `dtype` and back when
        it is given."""
        V = (self.eps - self.s.mu) + self._site_sum(x, self.hol_alpha)
        E = torch.exp(-self.s.dtau * V)[:, None]
        C, S = self.C, self.S
        if self.model.n_ssh:
            C, S = (a.movedim(-2, 0)[:, :, None] for a in self._planes(self.hoppings(x)[..., self.site_hop]))
        if dtype is not None:
            E, C, S = (a.to(dtype).to(F64) for a in (E, C, S))
        return E, C, S

    def lam(self, x: torch.Tensor) -> torch.Tensor:
        """Lambda (W, 1, Ltau, N)."""
        expo = self._site_sum(x, 0.5 * self.s.dtau * self.hol_alpha, self.ph_sym.to(x.dtype))
        return (self.lam_sign * torch.exp(expo))[:, None]

    # -- products ------------------------------------------------------------
    def _cb(self, u, C, S, transpose: bool):
        order = range(C.shape[0])
        for c in (reversed(order) if transpose else order):
            u = C[c] * u + S[c] * u[..., self.partner[c]]
        return u

    def B(self, u, tabs):
        E, C, S = tabs
        return self._cb(E * self._cb(u, C, S, True), C, S, False)

    def M(self, v, tabs):
        return v + self.first_sign * self.B(torch.roll(v, 1, dims=-2), tabs)

    def Mt(self, v, tabs):
        return v + self.last_sign * torch.roll(self.B(v, tabs), -1, dims=-2)

    def MtM(self, v, tabs):
        return self.Mt(self.M(v, tabs), tabs)

    def cb_matrix(self) -> torch.Tensor:
        """CB of the bare hoppings as a dense (N, N) matrix."""
        N = self.model.n_sites
        eye = torch.eye(N, dtype=F64, device=self.device)
        return self._cb(eye, self.C, self.S, False).T


class Preconditioner:
    """(Mbar^T Mbar)^{-1} of the tau-averaged propagator Bbar = CB mean_l(E_l) CB^T,
    a walker each: in Bbar's eigenbasis and the antiperiodic frequencies w_n
    it is 1 / (1 - 2 b cos w_n + b^2)."""

    def __init__(self, op: Operator, E: torch.Tensor):
        cbm = op.cb_matrix()
        Ebar = E[:, 0].mean(dim=1)  # (W, N)
        Bbar = cbm[None] @ (Ebar[:, :, None] * cbm.T[None])
        b, self.U = torch.linalg.eigh(0.5 * (Bbar + Bbar.transpose(1, 2)))
        Lt = E.shape[-2]
        l = torch.arange(Lt, dtype=F64, device=E.device)
        w = math.pi * (2.0 * l + 1.0) / Lt
        self.den = (1.0 - 2.0 * b[:, None, :] * torch.cos(w)[None, :, None] + b[:, None, :] ** 2)[:, None]
        self.twist = torch.polar(torch.ones_like(l), -math.pi * l / Lt)[:, None]

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        U = self.U[:, None]
        y = torch.fft.fft((v @ U) * self.twist, dim=-2) / self.den
        y = (torch.fft.ifft(y, dim=-2) * self.twist.conj()).real
        return y @ U.transpose(-1, -2)


def _dot(a, b):
    return (a * b).sum(dim=(-2, -1), keepdim=True)


def pcg(A, b: torch.Tensor, pre, tol: float, maxiter: int = 5000, x0: Optional[torch.Tensor] = None):
    """Preconditioned CG for every (Ltau, N) system of b, each to
    ||r|| <= tol ||b||, from x0 (zero by default). Returns (x, iterations)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x) if x0 is not None else b.clone()
    z = pre(r)
    p = z
    rz = _dot(r, z)
    bn = torch.sqrt(_dot(b, b))
    bn = torch.where(bn > 0, bn, torch.ones_like(bn))
    for it in range(1, maxiter + 1):
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if bool((torch.sqrt(_dot(r, r)) <= tol * bn).all()):
            return x, it
        z = pre(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError(f"reference CG did not reach {tol} in {maxiter} iterations")


def bosonic_action(op: Operator, x: torch.Tensor) -> torch.Tensor:
    """S_b (W,) of the harmonic phonons."""
    m, Om, dtau = op.mass[:, None], op.Omega[:, None], op.s.dtau
    kin = m / (2.0 * dtau) * (torch.roll(x, -1, dims=-1) - x) ** 2
    pot = dtau * 0.5 * m * Om**2 * x**2
    return (kin + pot).sum(dim=(-2, -1))


class Fourier:
    """The exact harmonic drift of (x, p) in the unnormalised DFT along tau,
    with per-(mode, frequency) masses m = M ((4/dtau) sin^2(pi k / Ltau) +
    dtau Omega^2), which equal the harmonic curvature, so that every mode
    turns at unit angular frequency."""

    def __init__(self, op: Operator):
        Lt, dtau = op.s.Ltau, op.s.dtau
        k = torch.arange(Lt, dtype=F64, device=op.device)
        self.m = op.mass[:, None] * (4.0 / dtau * torch.sin(math.pi * k / Lt)[None] ** 2
                                     + dtau * op.Omega[:, None] ** 2)
        self.Lt = Lt

    @staticmethod
    def fwd(v):
        z = torch.fft.fft(v.to(F64), dim=-1)
        return z.real, z.imag

    @staticmethod
    def tau(re, im):
        return torch.fft.ifft(torch.complex(re, im), dim=-1).real

    def drift(self, xw, pw, t):
        """Rotate by angle t (a tensor broadcasting over walkers)."""
        c, s = torch.cos(t), torch.sin(t)
        xr, xi = xw
        pr, pi = pw
        m = self.m
        return (c * xr + s * pr / m, c * xi + s * pi / m), (c * pr - s * m * xr, c * pi - s * m * xi)

    def momenta(self, xi):
        xr, xim = self.fwd(xi)
        s = torch.sqrt(self.m)
        return (s * xr, s * xim)

    def kinetic(self, pw):
        return 0.5 * ((pw[0] ** 2 + pw[1] ** 2) / self.m).sum(dim=(-2, -1)) / self.Lt


@dataclasses.dataclass
class Draws:
    """One walker's draws of a measured sweep, in the program's order."""

    mode: int
    R_refl: torch.Tensor
    u_refl: float
    pair: int
    c1: int
    shift: int
    c2_other: int
    R_swap: torch.Tensor
    u_swap: float
    u_dt: float
    R_hmc: torch.Tensor
    xi: torch.Tensor
    u_acc: float
    theta: torch.Tensor
    z: Optional[float] = None  # the radial move's, with Settings.radial
    R_rad: Optional[torch.Tensor] = None
    u_rad: Optional[float] = None


def draw(gen_state, model: ElPhModel, s: Settings) -> Draws:
    """Replay a walker's draws from its generator state (a uint8 array):
    reflection, swap, radial (z, then its noise; with `s.radial`), HMC, the
    refresh's phases."""
    g = torch.Generator(device="cpu")
    g.set_state(torch.as_tensor(np.asarray(gen_state), dtype=torch.uint8))
    Lt, N, Nc = s.Ltau, model.n_sites, model.n_cells

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=g))

    def noise():
        R = torch.randn((2, Lt, N), generator=g, dtype=F64) / math.sqrt(2.0)
        return R, float(torch.rand((), generator=g, dtype=F64))

    mode = randint(0, model.n_phonon)
    R1, u1 = noise()
    pair, c1, shift, c2 = randint(0, model.n_types), randint(0, Nc), randint(1, max(Nc, 2)), randint(0, Nc)
    R2, u2 = noise()
    radial = {}
    if s.radial:
        z = float(torch.randn((), generator=g, dtype=F64))
        R_rad, u_rad = noise()
        radial = dict(z=z, R_rad=R_rad, u_rad=u_rad)
    u_dt = float(torch.rand((), generator=g, dtype=F64))
    R3 = torch.randn((2, Lt, N), generator=g, dtype=F64) / math.sqrt(2.0)
    xi = torch.randn((model.n_phonon, Lt), generator=g, dtype=F64)
    u_acc = float(torch.rand((), generator=g, dtype=F64))
    if s.kpm:
        torch.randn((N,), generator=g, dtype=F64)
    theta = 2.0 * math.pi * torch.rand((s.Nrv, Lt, N), generator=g, dtype=F64)
    return Draws(mode, R1, u1, pair, c1, shift, c2, R2, u2, u_dt, R3, xi, u_acc, theta, **radial)


@dataclasses.dataclass
class Plan:
    """Operand precisions and tolerances of one replay."""

    action: Optional[torch.dtype]
    force: Optional[torch.dtype]
    measure: Optional[torch.dtype]
    tol_force: float
    tol_measure: float

    @staticmethod
    def of(precision: str, tol: float) -> "Plan":
        if precision == "exact":
            return Plan(None, None, None, 1e-8, tol)
        if precision == "config":
            return Plan(None, torch.float32, torch.float32, math.sqrt(tol), 2e-5)
        if precision == "control":
            return Plan(None, _LOWER["float32"], _LOWER["float32"], math.sqrt(tol), 2e-5)
        raise ValueError(precision)


@dataclasses.dataclass
class Sweep:
    """The replayed update sweep of a batch of walkers."""

    x_moved: torch.Tensor  # after reflection, swap and radial (W, n_phonon, Ltau)
    x_prop: torch.Tensor  # the trajectory's end
    dH: torch.Tensor  # (W,)
    log_u: torch.Tensor  # (W,) log of the acceptance draw
    global_accepted: list  # [(reflection, swap)], with radial moves (reflection, swap, radial), a walker


class Reference:
    def __init__(self, model: ElPhModel, s: Settings, device, precision: str = "exact"):
        self.model, self.s = model, s
        self.op = Operator(model, s, device)
        self.plan = Plan.of(precision, s.tol)
        self.fourier = Fourier(self.op)
        self.device = self.op.device
        self._warm = None  # the last force solve's solution, the next one's start

    def _solve(self, x, rhs, dtype, tol, x0=None):
        tabs = self.op.tables(x, dtype)
        psi, _ = pcg(lambda v: self.op.MtM(v, tabs), rhs, self.pre, tol, x0=x0)
        return psi

    def _phi(self, x, R):
        tabs = self.op.tables(x)
        return self.op.lam(x) * torch.roll(self.op.Mt(R, tabs), 1, dims=-2)

    def action(self, x, Phi):
        """S_f (W,) at the configuration's action precision."""
        rhs = torch.roll(Phi / self.op.lam(x), -1, dims=-2)
        psi = self._solve(x, rhs, self.plan.action, self.s.tol)
        return (rhs * psi).sum(dim=(-3, -2, -1))

    def force(self, x, Phi):
        """dS_f/dx (W, n_phonon, Ltau)."""
        with torch.no_grad():
            rhs = torch.roll(Phi / self.op.lam(x), -1, dims=-2)
            # warm-started from the previous kick's solution, as the program's trajectory is
            psi = self._solve(x, rhs, self.plan.force, self.plan.tol_force, x0=self._warm)
            self._warm = psi
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            tabs = self.op.tables(xg, self.plan.force)
            rhs_g = torch.roll(Phi / self.op.lam(xg), -1, dims=-2)
            f = 2.0 * (psi * rhs_g).sum() - (self.op.M(psi, tabs) ** 2).sum()
            (grad,) = torch.autograd.grad(f, xg)
        return grad

    def _metropolis(self, x_old, x_new, R, u, log_weight=None):
        """Accept flags (W,) of a global move with fresh pseudofermions at
        x_old, its proposal weighed by e^log_weight (W,) when given."""
        Phi = self._phi(x_old, R)
        S_old = (R * R).sum(dim=(-3, -2, -1)) + bosonic_action(self.op, x_old)
        S_new = self.action(x_new, Phi) + bosonic_action(self.op, x_new)
        dS = S_new - S_old
        return torch.log(u) < (-dS if log_weight is None else -dS + log_weight)

    def radial(self, x: torch.Tensor, z: Sequence[float]):
        """The radial move's proposal of fields x (W, n_phonon, Ltau): e^gamma x
        with gamma = z / sqrt(d) over the d = n_phonon Ltau fields, and its log
        weight, the Jacobian term d gamma (W,)."""
        d = x.shape[-2] * x.shape[-1]
        gamma = [zw * (1.0 / math.sqrt(d)) for zw in z]
        scale = torch.stack([torch.exp(torch.tensor(g, dtype=F64, device=x.device)) for g in gamma])
        return x * scale[:, None, None], torch.tensor([d * g for g in gamma], dtype=F64, device=x.device)

    def sweep(self, x0: torch.Tensor, draws: Sequence[Draws]) -> Sweep:
        """Reflection, swap, with `Settings.radial` the radial move, and the
        trajectory of every walker (no decision on the trajectory: its end and
        Delta H are returned)."""
        model, dev = self.model, self.device
        W, Nc = x0.shape[0], model.n_cells
        R = lambda name: torch.stack([getattr(d, name) for d in draws]).to(dev)  # noqa: E731
        u = lambda name: torch.tensor([getattr(d, name) for d in draws], dtype=F64, device=dev)  # noqa: E731
        # one preconditioner a sweep, from its starting fields: it moves iteration counts only
        self.pre = Preconditioner(self.op, self.op.tables(x0)[0])
        x = x0.clone()
        flipped = x.clone()
        for w, d in enumerate(draws):
            flipped[w, d.mode] *= -1.0
        acc_r = self._metropolis(x, flipped, R("R_refl"), u("u_refl"))
        x = torch.where(acc_r[:, None, None], flipped, x)
        swapped = x.clone()
        for w, d in enumerate(draws):
            p1 = d.pair * Nc + d.c1
            p2 = d.pair * Nc + (d.c1 + d.shift) % Nc
            swapped[w, p1], swapped[w, p2] = x[w, p2], x[w, p1]
        acc_s = self._metropolis(x, swapped, R("R_swap"), u("u_swap"))
        x_moved = torch.where(acc_s[:, None, None], swapped, x)
        accepted = [acc_r.tolist(), acc_s.tolist()]
        if self.s.radial:
            scaled, log_weight = self.radial(x_moved, [d.z for d in draws])
            acc_g = self._metropolis(x_moved, scaled, R("R_rad"), u("u_rad"), log_weight)
            x_moved = torch.where(acc_g[:, None, None], scaled, x_moved)
            accepted.append(acc_g.tolist())

        Rh = R("R_hmc")
        Phi = self._phi(x_moved, Rh)
        self._warm = None
        fo = self.fourier
        pw = fo.momenta(R("xi"))
        H0 = (Rh * Rh).sum(dim=(-3, -2, -1)) + bosonic_action(self.op, x_moved) + fo.kinetic(pw)
        step = math.pi / (2 * self.s.Nt)
        dt = (step * (1.0 + (2.0 * u("u_dt") - 1.0) * self.s.jitter))[:, None, None]
        xw = fo.fwd(x_moved)
        xw, pw = fo.drift(xw, pw, dt / 2.0)
        for t in range(self.s.Nt):
            f = self.force(fo.tau(*xw), Phi)
            fr, fi = fo.fwd(f)
            pw = (pw[0] - dt * fr, pw[1] - dt * fi)
            xw, pw = fo.drift(xw, pw, dt if t < self.s.Nt - 1 else dt / 2.0)
        x1 = fo.tau(*xw)
        H1 = self.action(x1, Phi) + bosonic_action(self.op, x1) + fo.kinetic(pw)
        return Sweep(x_moved, x1, H1 - H0, torch.log(u("u_acc")), list(zip(*accepted)))

    def green(self, x: torch.Tensor, theta: torch.Tensor):
        """GR = M^{-1} R for R = e^{i theta} (W, Nrv, 2, Ltau, N) as (re, im)
        channel pairs, at the configuration's measurement precision."""
        R = torch.stack([torch.cos(theta), torch.sin(theta)], dim=2).to(self.device)
        W, Nrv, _, Lt, N = R.shape
        tabs = self.op.tables(x, self.plan.measure)
        rhs = self.op.Mt(R.reshape(W, 2 * Nrv, Lt, N), tabs)
        GR, _ = pcg(lambda v: self.op.MtM(v, tabs), rhs, Preconditioner(self.op, self.op.tables(x)[0]),
                    self.plan.tol_measure)
        return R, GR.reshape(W, Nrv, 2, Lt, N)


def measurements(model: ElPhModel, R: torch.Tensor, GR: torch.Tensor, pairs) -> dict:
    """Per walker: the density 2 (1 - <conj(R) GR>) and the time-displaced
    Green's function G_ab(tau, r) = (1 / (Nrv Ltau Nc)) sum_{n,l,i} s GR_n,a
    [(l + tau) mod Ltau, i + r] conj(R_n,b[l, i]), s = -1 where l + tau wraps,
    for tau = 0..Ltau - 1, with G(beta) = delta_ab delta_r0 - G(0):
    complex (W, n_pairs, Ltau + 1, *L)."""
    W, Nrv, _, Lt, N = GR.shape
    Lc, no = tuple(model.L), model.n_orb
    G = torch.complex(GR[:, :, 0], GR[:, :, 1])
    Rc = torch.complex(R[:, :, 0], -R[:, :, 1])
    density = 2.0 * (1.0 - (Rc * G).sum(dim=(1, 2, 3)) / (Nrv * Lt * N))
    l = torch.arange(Lt, dtype=F64, device=GR.device)
    tw = torch.polar(torch.ones_like(l), math.pi * l / Lt).reshape((Lt,) + (1,) * len(Lc))
    dims = tuple(range(-1 - len(Lc), 0))
    out = []
    for a, b in pairs:
        ga = G.reshape(W, Nrv, Lt, *Lc, no)[..., a] * tw
        hb = Rc.reshape(W, Nrv, Lt, *Lc, no)[..., b] * tw.conj()
        S = torch.fft.ifftn(torch.fft.fftn(ga, dim=dims) * torch.fft.ifftn(hb, dim=dims), dim=dims).sum(dim=1)
        S = S * tw.conj() / Nrv
        Gb = -S[:, 0]
        if a == b:
            Gb[(slice(None),) + (0,) * len(Lc)] += 1.0
        out.append(torch.cat([S, Gb[:, None]], dim=1))
    return {"density": density, "greens": torch.stack(out, dim=1)}
