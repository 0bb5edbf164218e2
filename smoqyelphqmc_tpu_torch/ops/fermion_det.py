"""Matrix-free fermion determinant matrix M and its products.

Port of the JAX package's ops/fermion_det.py. M is the block-bidiagonal
space-time matrix (I on the diagonal, -B_l on the subdiagonal, +B_0 in the
corner) applied to (..., Ltau, N) fields. Propagators:

  symmetric  B_l = CB e^{-dtau V_l} CB^T, CB ~ e^{-dtau K / 2}
  asymmetric B_l = e^{-dtau V_l} CB,      CB ~ e^{-dtau K}

With complex hoppings (`complex_hops`) M is complex: fields are (re, im)
channel pairs (..., 2, Ltau, N), the transposes are adjoints, and CG's inner
products run over the pair (`sys_ndim = 3`).

For real hoppings `mul_MtM` is the dispatcher of kernel K1 (ops/mtm.py) and
`solve_MtM` the dispatcher of kernel K2 (ops/pcg.py). Complex M^dag M is plain
PyTorch by design, as the JAX package leaves it to XLA (`build_fused_mtm`
declines complex hoppings, pallas_fused.py:335); `CPLX_MTM[dtype].plain_calls`
counts its calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.fermion_path_integral import FermionPathIntegral
from ..tracing import KernelCounter
from .checkerboard import (
    CheckerboardOp,
    CheckerboardStructure,
    build_checkerboard_op,
    hop_factors,
    hop_factors_complex,
)

# plain PyTorch by design: counts on plain_calls only, and stays out of the
# kernel counters that a path must launch
CPLX_MTM = {torch.float32: KernelCounter("cplx_mtm_f32"), torch.float64: KernelCounter("cplx_mtm_f64")}


def _maybe(t: Optional[torch.Tensor], fn) -> Optional[torch.Tensor]:
    return None if t is None else fn(t)


def boundary_sign(Ltau: int, first: bool, dtype: torch.dtype, device) -> torch.Tensor:
    """(Ltau, 1) column of -1 with +1 in row 0 (first) or row Ltau-1 (last)."""
    s = torch.full((Ltau, 1), -1.0, dtype=dtype, device=device)
    s[0 if first else Ltau - 1, 0] = 1.0
    return s


@dataclasses.dataclass
class FermionDetMatrix:
    """Matrix-free M for the current field.

    exp_nV: (Ltau, N) exp(-dtau V); cb: checkerboard factors at dtau/2 (sym) or
    dtau (asym); cosh_hop / sinh_hop: (Ltau, n_hops) per-hop factors, whose
    rows differ with SSH couplings (static_hops False); sinh_hop_im: their
    imaginary parts for complex hoppings (else None). A walker batch
    (updates.context.make_fdm) adds leading walker axes."""

    exp_nV: torch.Tensor
    cb: CheckerboardOp
    cosh_hop: torch.Tensor
    sinh_hop: torch.Tensor
    symmetric: bool
    structure: CheckerboardStructure
    Ltau: int
    n_sites: int
    static_hops: bool = True
    sinh_hop_im: Optional[torch.Tensor] = None

    @staticmethod
    def from_path_integral(
        fpi: FermionPathIntegral, structure: CheckerboardStructure, symmetric: bool = True
    ) -> "FermionDetMatrix":
        dtau_eff = fpi.dtau / 2 if symmetric else fpi.dtau
        if fpi.t_im is None:
            cosh_hop, sinh_hop = hop_factors(fpi.t, dtau_eff)
            sinh_hop_im = None
        else:
            cosh_hop, sinh_hop, sinh_hop_im = hop_factors_complex(fpi.t, fpi.t_im, dtau_eff)
        return FermionDetMatrix(
            exp_nV=torch.exp(-fpi.dtau * fpi.V),
            cb=build_checkerboard_op(structure, cosh_hop, sinh_hop, sinh_hop_im),
            cosh_hop=cosh_hop,
            sinh_hop=sinh_hop,
            symmetric=symmetric,
            structure=structure,
            Ltau=fpi.Ltau,
            n_sites=fpi.n_sites,
            static_hops=fpi.static_hops,
            sinh_hop_im=sinh_hop_im,
        )

    @property
    def complex_hops(self) -> bool:
        """True when M is complex (the channel pair at axis -3 mixes)."""
        return self.cb.S_im is not None

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
        """M^T M v through kernel K1 (CUDA tensors) or its plain version (CPU);
        M^dag M v in plain ops for complex hoppings."""
        if self.complex_hops:
            CPLX_MTM[v.dtype].plain_calls += 1
            return self.mul_Mt(self.mul_M(v))
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
            sinh_hop_im=_maybe(self.sinh_hop_im, lambda t: t.to(dtype)),
        )

    def to(self, device) -> "FermionDetMatrix":
        """Copy with every tensor on `device`."""
        return dataclasses.replace(
            self,
            exp_nV=self.exp_nV.to(device),
            cb=self.cb.to(device),
            cosh_hop=self.cosh_hop.to(device),
            sinh_hop=self.sinh_hop.to(device),
            sinh_hop_im=_maybe(self.sinh_hop_im, lambda t: t.to(device)),
        )

    def averaged_factors(self):
        """tau-averaged (exp_nV, cosh_hop, sinh_hop, sinh_hop_im): the Bbar
        ingredients (sinh_hop_im None for real hoppings). The mean runs over
        the tau axis alone (-2), so leading walker axes stay."""
        return (self.exp_nV.mean(dim=-2), self.cosh_hop.mean(dim=-2), self.sinh_hop.mean(dim=-2),
                _maybe(self.sinh_hop_im, lambda t: t.mean(dim=-2)))


def solve_MtM(
    fdm: FermionDetMatrix,
    rhs: torch.Tensor,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    mixed: bool = False,
    x0: Optional[torch.Tensor] = None,
):
    """[M^T M]^{-1} rhs (the JAX package's ops/fermion_det.py:solve_MtM).

    For real hoppings with the spectral preconditioner every f32 solve, and
    every f32 inner solve of the mixed-precision defect correction, runs
    through kernel K2 (ops/pcg.py); the f64 residuals of the defect correction
    go through K1. A complex fermion matrix, or the doubled-basis spectral
    preconditioner, never reaches K2 (pallas_fused.py:1092-1095): its solves
    run cg_solve over the channel pair (sys_ndim = 3). Returns (x, CGStats)."""
    from .cg import cg_solve, cg_solve_mixed
    from .pcg import SpectralPCG
    from .spectral_precond import SpectralPreconditioner

    mixed = mixed and rhs.dtype == torch.float64
    if rhs.dtype == torch.float32 and not mixed and fdm.dtype != torch.float32:
        fdm = fdm.astype(torch.float32)
    pcg = None
    if ((rhs.dtype == torch.float32 or mixed) and isinstance(precond, SpectralPreconditioner)
            and not precond.complex_pair and not fdm.complex_hops):
        pcg = SpectralPCG(fdm, precond)
    if pcg is not None and not mixed:
        return pcg(rhs, x0=x0, tol=tol, maxiter=maxiter)
    pre_op = precond.as_operator() if precond is not None else None
    sys_ndim = 3 if fdm.complex_hops else 2
    if mixed:
        fdm32 = fdm.astype(torch.float32)
        inner = None
        if pcg is not None:
            inner = lambda r32, itol, mi: pcg(r32, tol=itol, maxiter=mi)  # noqa: E731
        return cg_solve_mixed(
            fdm.mul_MtM, fdm32.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter,
            sys_ndim=sys_ndim, inner_solver=inner, x0=x0,
        )
    return cg_solve(fdm.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter, sys_ndim=sys_ndim, x0=x0)
