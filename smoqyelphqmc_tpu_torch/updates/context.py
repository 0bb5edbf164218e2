"""Simulation context and Markov-chain state (port of
smoqyelphqmc_tpu/updates/context.py).

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

    @property
    def Ltau(self) -> int:
        return self.elph.Ltau

    @property
    def n_sites(self) -> int:
        return self.tbp.n_sites

    @property
    def device(self) -> torch.device:
        return self.elph.device


@dataclasses.dataclass
class QMCState:
    x: torch.Tensor  # (n_phonon, Ltau)
    precond: Optional[object]


def make_fdm(ctx: QMCContext, x: torch.Tensor, dtype: Optional[str] = None) -> FermionDetMatrix:
    """Propagator factors at field x; dtype='float32' casts (V, t) before
    exponentiation (the force path)."""
    fpi = build_path_integral(ctx.tbp, ctx.elph, x)
    if dtype is not None and _DTYPES[dtype] != fpi.V.dtype:
        fpi = fpi.to_dtype(_DTYPES[dtype])
    return FermionDetMatrix.from_path_integral(fpi, ctx.structure, symmetric=ctx.symmetric)


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
) -> tuple[QMCContext, QMCState]:
    """Context and initial state on the device of `elph` (preconditioner:
    'auto' by default, 'spectral', or None)."""
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
    )
    x0 = elph.x.clone()
    precond = None
    if use_preconditioner:
        precond = build_preconditioner(preconditioner or "auto", make_fdm(ctx, x0))
    return ctx, QMCState(x=x0, precond=precond)
