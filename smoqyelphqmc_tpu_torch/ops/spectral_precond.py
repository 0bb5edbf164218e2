"""Spectral preconditioner: exact [Mbar^T Mbar]^{-1} via an eigendecomposition.

Port of the JAX package's ops/spectral_precond.py. Bbar = CB Dbar CB^T =
Q diag(lam) Q^T is diagonalised once per refresh, and

    P^{-1} u = F^dag Q diag(1 / (lam^2 - 2 lam cos(phi_w) + 1)) Q^T F u

with F the antiperiodic tau transform. The asymmetric factorization
diagonalises the half-angle symmetrized surrogate CB(dtau/2) Dbar
CB(dtau/2)^T built from the same averaged factors. With complex hoppings
Bbar is Hermitian and the real symmetric 2N x 2N embedding
[[B_re, -B_im], [B_im, B_re]] is diagonalised (`complex_pair`): the filter
acts on the doubled (re, im)-site vector of the channel pair. eigh is not
unique (signs, and bases inside degenerate eigenspaces), so Q differs from
the JAX package's; the action P^{-1} u does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .checkerboard import build_checkerboard_op
from .fourier import TauFourier
from .kpm import AveragedPropagator, averaged_propagator

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class PcgOperands(NamedTuple):
    """Kernel K2 / K3's preconditioner operands (`pcg_operands`)."""

    W: torch.Tensor  # (2 Lh, Ltau) bf16: [Wre; Wim]
    Wt: torch.Tensor  # (Ltau, 2 Lh) bf16: W transposed, contiguous
    Q: torch.Tensor  # (N, N) bf16
    Qt: torch.Tensor  # (N, N) bf16: Q transposed, contiguous
    filt: torch.Tensor  # (Lh, N) f32, pair factor folded in
    Lh: int


@dataclasses.dataclass
class SpectralPreconditioner:
    """Eigenbasis of Bbar and the per-frequency inverse filters.

    `dtype` is the apply precision ('float32' by default, as in the JAX
    package); the eigendecomposition runs in it too."""

    Q: torch.Tensor  # (N, N); (2N, 2N) when complex_pair
    filt: torch.Tensor  # (Ltau, N); (Ltau, 2N) when complex_pair
    fft: TauFourier
    Ltau: int
    n_sites: int
    dtype: str = "float32"
    complex_pair: bool = False
    _pcg_operands: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def as_operator(self):
        return lambda r: spectral_apply(self, r)

    def pcg_operands(self):
        """Operands of kernel K2's preconditioner, built as
        `build_fused_pcg` builds them (the JAX package's ops/pallas_fused.py:
        1136-1148): W = [Wre; Wim] (2 Lh, Ltau) bf16, the first Lh rows of the
        antiperiodic DFT; Q in bf16; filt[:Lh] in f32 with the conjugate-pair
        factor 2 folded in. Lh = Ltau / 2 for even Ltau (half spectrum), else
        Ltau. W and Q also come transposed and contiguous (Wt, Qt), so every
        product of the kernels reads its operands row by row. Cached on the
        preconditioner: a `PcgOperands`. K2 takes real hoppings only, so
        the doubled-basis preconditioner has none."""
        if self.complex_pair:
            raise ValueError("the doubled-basis spectral preconditioner (complex hoppings) has no K2 operands")
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
            self._pcg_operands = PcgOperands(W=W, Wt=W.T.contiguous(), Q=Qb, Qt=Qb.T.contiguous(), filt=filt, Lh=Lh)
        return self._pcg_operands


def build_spectral(fdm, dtype: str = "float32") -> SpectralPreconditioner:
    """Construct from the current fermion matrix (also the refresh path)."""
    dt = _DTYPES[dtype]
    bbar = averaged_propagator(fdm) if fdm.symmetric else _symmetrized_propagator(fdm)
    N = fdm.n_sites
    eye = torch.eye(N, dtype=fdm.dtype, device=fdm.device)
    if not fdm.complex_hops:
        B = bbar.apply(eye).T
    else:
        # row k of `out` is Bbar e_k as a channel pair (N, 2, 1, N)
        out = bbar.apply(torch.stack([eye, torch.zeros_like(eye)], dim=1)[:, :, None, :])
        B_re, B_im = out[:, 0, 0, :].T, out[:, 1, 0, :].T
        B = torch.cat([torch.cat([B_re, -B_im], dim=1), torch.cat([B_im, B_re], dim=1)])
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
        complex_pair=fdm.complex_hops,
    )


def _symmetrized_propagator(fdm) -> AveragedPropagator:
    """The asymmetric factorization's half-angle surrogate: per hop, the
    averaged cosh / sinh at dtau become cosh / sinh at dtau / 2 through the
    half-angle identities, giving CB(dtau/2) Dbar CB(dtau/2)^T (Hermitian
    with complex hoppings)."""
    expV_bar, cosh_bar, sinh_bar, sinh_bar_im = fdm.averaged_factors()
    ch2 = torch.sqrt((1.0 + cosh_bar) / 2.0)
    safe = 2.0 * torch.where(ch2 > 0, ch2, torch.ones_like(ch2))
    sinh_im = None if sinh_bar_im is None else sinh_bar_im / safe
    cb = build_checkerboard_op(fdm.structure, ch2, sinh_bar / safe, sinh_im)
    return AveragedPropagator(cb=cb, expV=expV_bar, symmetric=True)


def spectral_update(pre: SpectralPreconditioner, fdm) -> SpectralPreconditioner:
    """Refresh for a new field configuration."""
    return build_spectral(fdm, dtype=pre.dtype)


def spectral_apply(pre: SpectralPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """z = P^{-1} r for r (..., Ltau, N); batch axes broadcast. With
    complex_pair, r is the channel pair (..., 2, Ltau, N) and the filter acts
    on the doubled (re, im)-site rows of each frequency."""
    in_dtype = r.dtype
    r = r.to(pre.Q.dtype)
    if pre.complex_pair:
        N = pre.n_sites
        ur, ui = pre.fft.forward(r[..., 0, :, :], r[..., 1, :, :])
        w = ((torch.cat([ur, ui], dim=-1) @ pre.Q) * pre.filt) @ pre.Q.T
        zre, zim = pre.fft.inverse(w[..., :N], w[..., N:])
        return torch.stack([zre, zim], dim=-3).to(in_dtype)
    ur, ui = pre.fft.forward(r)
    ur = (ur @ pre.Q) * pre.filt
    ui = (ui @ pre.Q) * pre.filt
    zr, _ = pre.fft.inverse(ur @ pre.Q.T, ui @ pre.Q.T)
    return zr.to(in_dtype)
