"""Matrix-free fermion determinant matrix M and its products.

Port of smoqyelphqmc_tpu/ops/fermion_det.py for real hoppings. M is the
block-bidiagonal space-time matrix (I on the diagonal, -B_l on the subdiagonal,
+B_0 in the corner) applied to (..., Ltau, N) fields. Propagators:

  symmetric  B_l = CB e^{-dtau V_l} CB^T, CB ~ e^{-dtau K / 2}
  asymmetric B_l = e^{-dtau V_l} CB,      CB ~ e^{-dtau K}

`mul_MtM` is the dispatcher of kernel K1 (ops/mtm.py) and `solve_MtM` the
dispatcher of kernel K2 (ops/pcg.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.fermion_path_integral import FermionPathIntegral
from .checkerboard import (
    CheckerboardOp,
    CheckerboardStructure,
    build_checkerboard_op,
    hop_factors,
)


def boundary_sign(Ltau: int, first: bool, dtype: torch.dtype, device) -> torch.Tensor:
    """(Ltau, 1) column of -1 with +1 in row 0 (first) or row Ltau-1 (last)."""
    s = torch.full((Ltau, 1), -1.0, dtype=dtype, device=device)
    s[0 if first else Ltau - 1, 0] = 1.0
    return s


@dataclasses.dataclass
class FermionDetMatrix:
    """Matrix-free M for the current field.

    exp_nV: (Ltau, N) exp(-dtau V); cb: checkerboard factors at dtau/2 (sym) or
    dtau (asym); cosh_hop / sinh_hop: (Ltau, n_hops) per-hop factors."""

    exp_nV: torch.Tensor
    cb: CheckerboardOp
    cosh_hop: torch.Tensor
    sinh_hop: torch.Tensor
    symmetric: bool
    structure: CheckerboardStructure
    Ltau: int
    n_sites: int
    static_hops: bool = True

    @staticmethod
    def from_path_integral(
        fpi: FermionPathIntegral, structure: CheckerboardStructure, symmetric: bool = True
    ) -> "FermionDetMatrix":
        dtau_eff = fpi.dtau / 2 if symmetric else fpi.dtau
        cosh_hop, sinh_hop = hop_factors(fpi.t, dtau_eff)
        return FermionDetMatrix(
            exp_nV=torch.exp(-fpi.dtau * fpi.V),
            cb=build_checkerboard_op(structure, cosh_hop, sinh_hop),
            cosh_hop=cosh_hop,
            sinh_hop=sinh_hop,
            symmetric=symmetric,
            structure=structure,
            Ltau=fpi.Ltau,
            n_sites=fpi.n_sites,
            static_hops=fpi.static_hops,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.exp_nV.dtype

    @property
    def device(self) -> torch.device:
        return self.exp_nV.device

    def apply_B(self, u: torch.Tensor) -> torch.Tensor:
        """u <- B u slice-wise (no time shift)."""
        if self.symmetric:
            u = self.cb.apply(u, transpose=True)
            u = self.exp_nV * u
            return self.cb.apply(u, transpose=False)
        u = self.cb.apply(u, transpose=False)
        return self.exp_nV * u

    def apply_Bt(self, u: torch.Tensor) -> torch.Tensor:
        """u <- B^T u slice-wise."""
        if self.symmetric:
            return self.apply_B(u)
        u = self.exp_nV * u
        return self.cb.apply(u, transpose=True)

    def mul_M(self, v: torch.Tensor) -> torch.Tensor:
        """v'[l] = v[l] - B_l v[l-1] (l >= 1); v'[0] = v[0] + B_0 v[Ltau-1]."""
        u = self.apply_B(torch.roll(v, 1, dims=-2))
        return v + boundary_sign(self.Ltau, True, v.dtype, v.device) * u

    def mul_Mt(self, v: torch.Tensor) -> torch.Tensor:
        """v'[l] = v[l] - B_{l+1}^T v[l+1] (l < Ltau-1); v'[Ltau-1] = v[Ltau-1] + B_0^T v[0]."""
        w = torch.roll(self.apply_Bt(v), -1, dims=-2)
        return v + boundary_sign(self.Ltau, False, v.dtype, v.device) * w

    def mul_MtM(self, v: torch.Tensor) -> torch.Tensor:
        """M^T M v through kernel K1 (CUDA tensors) or its plain version (CPU)."""
        from .mtm import mul_MtM

        return mul_MtM(self, v)

    def astype(self, dtype: torch.dtype) -> "FermionDetMatrix":
        """Cast the propagator factors (the f32 inner solves of mixed CG)."""
        return dataclasses.replace(
            self,
            exp_nV=self.exp_nV.to(dtype),
            cb=self.cb.to_dtype(dtype),
            cosh_hop=self.cosh_hop.to(dtype),
            sinh_hop=self.sinh_hop.to(dtype),
        )

    def to(self, device) -> "FermionDetMatrix":
        """Copy with every tensor on `device`."""
        return dataclasses.replace(
            self,
            exp_nV=self.exp_nV.to(device),
            cb=self.cb.to(device),
            cosh_hop=self.cosh_hop.to(device),
            sinh_hop=self.sinh_hop.to(device),
        )

    def averaged_factors(self):
        """tau-averaged (exp_nV, cosh_hop, sinh_hop): the Bbar ingredients."""
        return self.exp_nV.mean(dim=0), self.cosh_hop.mean(dim=0), self.sinh_hop.mean(dim=0)


def solve_MtM(
    fdm: FermionDetMatrix,
    rhs: torch.Tensor,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    mixed: bool = False,
    x0: Optional[torch.Tensor] = None,
):
    """[M^T M]^{-1} rhs (smoqyelphqmc_tpu/ops/fermion_det.py:solve_MtM).

    With the spectral preconditioner every f32 solve, and every f32 inner solve
    of the mixed-precision defect correction, runs through kernel K2
    (ops/pcg.py); the f64 residuals of the defect correction go through K1.
    Returns (x, CGStats)."""
    from .cg import cg_solve, cg_solve_mixed
    from .pcg import SpectralPCG
    from .spectral_precond import SpectralPreconditioner

    mixed = mixed and rhs.dtype == torch.float64
    if rhs.dtype == torch.float32 and not mixed and fdm.dtype != torch.float32:
        fdm = fdm.astype(torch.float32)
    pcg = None
    if (rhs.dtype == torch.float32 or mixed) and isinstance(precond, SpectralPreconditioner):
        pcg = SpectralPCG(fdm, precond)
    if pcg is not None and not mixed:
        return pcg(rhs, x0=x0, tol=tol, maxiter=maxiter)
    pre_op = precond.as_operator() if precond is not None else None
    if mixed:
        fdm32 = fdm.astype(torch.float32)
        inner = None
        if pcg is not None:
            inner = lambda r32, itol, mi: pcg(r32, tol=itol, maxiter=mi)  # noqa: E731
        return cg_solve_mixed(
            fdm.mul_MtM, fdm32.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter,
            inner_solver=inner, x0=x0,
        )
    return cg_solve(fdm.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter, x0=x0)
