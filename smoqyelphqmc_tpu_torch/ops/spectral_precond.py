"""Spectral preconditioner: exact [Mbar^T Mbar]^{-1} via an eigendecomposition.

Port of smoqyelphqmc_tpu/ops/spectral_precond.py (symmetric factorization, real
hoppings). Bbar = CB Dbar CB^T = Q diag(lam) Q^T is diagonalised once per
refresh, and

    P^{-1} u = F^dag Q diag(1 / (lam^2 - 2 lam cos(phi_w) + 1)) Q^T F u

with F the antiperiodic tau transform. eigh is not unique (signs, and bases
inside degenerate eigenspaces), so Q differs from the JAX package's; the
action P^{-1} u does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .fourier import TauFourier
from .kpm import averaged_propagator

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class SpectralPreconditioner:
    """Eigenbasis of Bbar and the per-frequency inverse filters.

    `dtype` is the apply precision ('float32' by default, as in the JAX
    package); the eigendecomposition runs in it too."""

    Q: torch.Tensor  # (N, N)
    filt: torch.Tensor  # (Ltau, N)
    fft: TauFourier
    Ltau: int
    n_sites: int
    dtype: str = "float32"
    _pcg_operands: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def as_operator(self):
        return lambda r: spectral_apply(self, r)

    def pcg_operands(self):
        """Operands of kernel K2's preconditioner, built as
        `build_fused_pcg` builds them (smoqyelphqmc_tpu/ops/pallas_fused.py:
        1136-1148): W = [Wre; Wim] (2 Lh, Ltau) bf16, the first Lh rows of the
        antiperiodic DFT; Q in bf16; filt[:Lh] in f32 with the conjugate-pair
        factor 2 folded in. Lh = Ltau / 2 for even Ltau (half spectrum), else
        Ltau. Cached on the preconditioner."""
        if self._pcg_operands is None:
            Ltau = self.Ltau
            Lh = Ltau // 2 if Ltau % 2 == 0 else Ltau
            w = np.arange(Lh)[:, None]
            l = np.arange(Ltau)[None, :]
            ang = -(2.0 * np.pi * w + np.pi) * l / Ltau
            W = np.concatenate([np.cos(ang), np.sin(ang)]) / np.sqrt(Ltau)
            dev = self.Q.device
            W = torch.as_tensor(W.astype(np.float32), device=dev).to(torch.bfloat16).contiguous()
            pair = 2.0 if Lh < Ltau else 1.0
            Qb = self.Q.to(torch.float32).to(torch.bfloat16).contiguous()
            filt = (pair * self.filt[:Lh].to(torch.float32)).contiguous()
            self._pcg_operands = (W, Qb, filt, Lh)
        return self._pcg_operands


def build_spectral(fdm, dtype: str = "float32") -> SpectralPreconditioner:
    """Construct from the current fermion matrix (also the refresh path)."""
    if not fdm.symmetric:
        raise NotImplementedError(
            "the spectral preconditioner of the asymmetric factorization is not "
            "ported yet (ROADMAP Queue 1, item 13)"
        )
    dt = _DTYPES[dtype]
    bbar = averaged_propagator(fdm)
    N = fdm.n_sites
    eye = torch.eye(N, dtype=fdm.dtype, device=fdm.device)
    B = bbar.apply(eye).T
    B = 0.5 * (B + B.T)
    lam, Q = torch.linalg.eigh(B.to(dt))
    lam = lam.to(torch.float64)
    Ltau = fdm.Ltau
    phi = 2.0 * math.pi * (torch.arange(Ltau, dtype=torch.float64, device=fdm.device) + 0.5) / Ltau
    denom = lam[None, :] ** 2 - 2.0 * lam[None, :] * torch.cos(phi)[:, None] + 1.0
    filt = 1.0 / torch.clamp(denom, min=1e-12)
    return SpectralPreconditioner(
        Q=Q.to(dt).contiguous(),
        filt=filt.to(dt).contiguous(),
        fft=TauFourier(Ltau, dtype=dt, device=fdm.device),
        Ltau=Ltau,
        n_sites=N,
        dtype=dtype,
    )


def spectral_update(pre: SpectralPreconditioner, fdm) -> SpectralPreconditioner:
    """Refresh for a new field configuration."""
    return build_spectral(fdm, dtype=pre.dtype)


def spectral_apply(pre: SpectralPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """z = P^{-1} r for r (..., Ltau, N); batch axes broadcast."""
    in_dtype = r.dtype
    r = r.to(pre.Q.dtype)
    ur, ui = pre.fft.forward(r)
    ur = (ur @ pre.Q) * pre.filt
    ui = (ui @ pre.Q) * pre.filt
    zr, _ = pre.fft.inverse(ur @ pre.Q.T, ui @ pre.Q.T)
    return zr.to(in_dtype)
