"""Simulation context and Markov-chain state (port of
the JAX package's updates/context.py).

`QMCContext` holds what stays constant along the chain; `QMCState` is the
phonon field and the carried preconditioner. The JAX state also carries a PRNG
key; here every update takes its random draws as an argument instead."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..models.electron_phonon import ElectronPhononParameters
from ..models.fermion_path_integral import build_path_integral
from ..models.tight_binding import TightBindingParameters
from ..ops.checkerboard import CheckerboardStructure, build_checkerboard_structure
from ..ops.derivatives import ForcePlan, build_force_plan
from ..ops.efa import FourierAccelerator
from ..ops.fermion_det import FermionDetMatrix
from ..ops.preconditioner import build_preconditioner

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def complex_hops(tbp: TightBindingParameters, elph: ElectronPhononParameters) -> bool:
    """True when M is complex: complex hoppings or complex SSH constants."""
    return tbp.t0_im is not None or elph.complex_ssh


@dataclasses.dataclass
class QMCContext:
    tbp: TightBindingParameters
    elph: ElectronPhononParameters  # coupling arrays; the live field is QMCState.x
    efa: FourierAccelerator
    structure: CheckerboardStructure
    plan: ForcePlan
    symmetric: bool
    tol: float
    tol_force: float
    maxiter: int
    mixed_precision: bool = False
    force_dtype: str = "float64"
    # refresh the carried preconditioner at the proposal of every reflection,
    # swap and radial move (the JAX package's option; off by default: one
    # mode of n_phonon barely moves the tau- and site-averaged Bbar)
    refresh_precond_global: bool = False

    @property
    def Ltau(self) -> int:
        return self.elph.Ltau

    @property
    def n_sites(self) -> int:
        return self.tbp.n_sites

    @property
    def device(self) -> torch.device:
        return self.elph.device

    @property
    def complex_hops(self) -> bool:
        return complex_hops(self.tbp, self.elph)

    @property
    def lanczos_dim(self) -> int:
        """Length of a KPM Lanczos start vector: N, or 2N for complex hoppings."""
        return 2 * self.n_sites if self.complex_hops else self.n_sites


def with_mu(ctx: QMCContext, mu) -> QMCContext:
    """The context at chemical potential mu: a float, a 0-dim tensor, or a
    walker batch's (W,) values (the fermion matrix of a (W, n_phonon, Ltau)
    field then carries each walker's mu in its exp_nV planes)."""
    mu = torch.as_tensor(mu, dtype=torch.float64).to(ctx.device)
    return dataclasses.replace(ctx, tbp=dataclasses.replace(ctx.tbp, mu=mu))


def walker_context(ctx: QMCContext, w: int) -> QMCContext:
    """Walker w's context: its own mu when the context carries one a walker."""
    return with_mu(ctx, ctx.tbp.mu[w]) if ctx.tbp.mu.dim() == 1 else ctx


@dataclasses.dataclass
class QMCState:
    x: torch.Tensor  # (n_phonon, Ltau)
    precond: Optional[object]


def make_fdm(ctx: QMCContext, x: torch.Tensor, dtype: Optional[str] = None) -> FermionDetMatrix:
    """Propagator factors at field x; dtype='float32' casts (V, t) before
    exponentiation (the force path).

    For a walker batch x (W, n_phonon, Ltau) the fermion matrix carries exp_nV
    as (W, 1, Ltau, N): its products broadcast over the channel axis of
    (W, 2, Ltau, N) fields, and kernels K3 / K4 read the planes with a walker
    stride. Without SSH couplings the hopping tables are shared; with them
    each walker has its own: cosh_hop / sinh_hop (W, Ltau, n_hops) and the
    checkerboard planes (n_colors, W, 1, Ltau, N). Complex hoppings carry
    their imaginary parts through the path integral (t_im) into the fermion
    matrix (sinh_hop_im, cb.S_im)."""
    fpi = build_path_integral(ctx.tbp, ctx.elph, x)
    if dtype is not None and _DTYPES[dtype] != fpi.V.dtype:
        fpi = fpi.to_dtype(_DTYPES[dtype])
    fdm = FermionDetMatrix.from_path_integral(fpi, ctx.structure, symmetric=ctx.symmetric)
    if x.dim() == 3:
        expV = torch.broadcast_to(fdm.exp_nV, (x.shape[0], fdm.Ltau, fdm.n_sites))
        fdm = dataclasses.replace(fdm, exp_nV=expV[:, None])
        if not fdm.static_hops:
            cb = fdm.cb
            fdm = dataclasses.replace(fdm, cb=dataclasses.replace(
                cb, C=cb.C[:, :, None], S=cb.S[:, :, None], S_im=None if cb.S_im is None else cb.S_im[:, :, None]))
    return fdm


def initialize_qmc(
    tbp: TightBindingParameters,
    elph: ElectronPhononParameters,
    symmetric: bool = True,
    tol: float = 1e-10,
    tol_force: Optional[float] = None,
    maxiter: int = 10_000,
    eta: float = 0.0,
    use_preconditioner: bool = True,
    preconditioner: Optional[str] = None,
    mixed_precision: bool = False,
    force_dtype: str = "float64",
    lanczos_v0: Optional[torch.Tensor] = None,
    refresh_precond_global: bool = False,
) -> tuple[QMCContext, QMCState]:
    """Context and initial state on the device of `elph` (preconditioner:
    'auto' by default, 'spectral', 'kpm', or None). A KPM preconditioner's
    Lanczos iteration starts from `lanczos_v0` (N,), or (2N,) for complex
    hoppings, which the JAX package draws from split(PRNGKey(seed))[1]."""
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    ctx = QMCContext(
        tbp=tbp,
        elph=elph,
        efa=FourierAccelerator.build(elph, eta=eta),
        structure=structure,
        plan=build_force_plan(elph, structure),
        symmetric=symmetric,
        tol=tol,
        tol_force=float(math.sqrt(tol)) if tol_force is None else tol_force,
        maxiter=maxiter,
        mixed_precision=mixed_precision,
        force_dtype=force_dtype,
        refresh_precond_global=refresh_precond_global,
    )
    x0 = elph.x.clone()
    precond = None
    if use_preconditioner:
        precond = build_preconditioner(preconditioner or "auto", make_fdm(ctx, x0), lanczos_v0)
    return ctx, QMCState(x=x0, precond=precond)
