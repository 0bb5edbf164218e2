"""Imaginary-time Fourier transforms on torch.fft (cuFFT on the GPU).

Port of the JAX package's ops/fourier.py, which applies the transforms as DFT
matmuls because the TPU had no FFT. Normalisations match it exactly:

- `TauFourier`: unitary antiperiodic transform along axis -2,
  u[w] = (1/sqrt(L)) sum_l exp(-i (2 pi w + pi) l / L) v[l], and its inverse;
- `AxisDFT`: plain periodic DFT along one axis, unnormalised forward and
  1/n-normalised inverse;
- `space_time_dft`: the Green's-function estimator's multi-axis DFT over the
  trailing (tau, *L) axes of a complex field, the counterpart of the JAX
  package's `FactoredDFT` / `PackedDFT` pair as `build_greens_estimator`
  chooses them (the tau axis of length Ltau, or 2 Ltau for the aperiodic
  extension, then the cell axes). One cuFFT / pocketfft call serves every
  size, so the JAX package's dense-versus-factored size thresholds have no
  counterpart here.

Complex fields cross these interfaces as (re, im) pairs of real tensors, the
JAX package's layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _complex(vre: torch.Tensor, vim: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    vre = vre.to(dtype)
    if vim is None:
        return vre.to(_COMPLEX[dtype])
    return torch.complex(vre, vim.to(dtype))


class TauFourier:
    """Unitary antiperiodic tau -> omega transform along axis -2 (and inverse)."""

    def __init__(self, Ltau: int, dtype: torch.dtype = torch.float64, device="cuda"):
        self.Ltau = Ltau
        self.dtype = dtype
        l = torch.arange(Ltau, dtype=torch.float64, device=device)
        # e^{-i pi l / L}: the antiperiodic twist folded into a plain FFT
        ang = -math.pi * l / Ltau
        self.twist = torch.polar(torch.ones_like(ang), ang).to(_COMPLEX[dtype])[:, None]

    def forward(self, vre: torch.Tensor, vim: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.fft.fft(_complex(vre, vim, self.dtype) * self.twist, dim=-2, norm="ortho")
        return u.real, u.imag

    def inverse(self, ure: torch.Tensor, uim: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        v = torch.fft.ifft(_complex(ure, uim, self.dtype), dim=-2, norm="ortho") * self.twist.conj()
        return v.real, v.imag


class AxisDFT:
    """Plain periodic DFT along one axis: forward unnormalised, inverse 1/n."""

    def __init__(self, n: int, inverse: bool = False, dtype: torch.dtype = torch.float64):
        self.n = n
        self.inverse_norm = inverse
        self.dtype = dtype

    def apply(self, vre: torch.Tensor, vim: Optional[torch.Tensor], axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
        v = _complex(vre, vim, self.dtype)
        u = torch.fft.ifft(v, dim=axis) if self.inverse_norm else torch.fft.fft(v, dim=axis)
        return u.real, u.imag


def space_time_dft(z: torch.Tensor, n_axes: int, inverse: bool) -> torch.Tensor:
    """DFT over the trailing `n_axes` axes of the complex tensor z: forward
    sum_l e^{-2 pi i k l / n} z[l] unnormalised, inverse e^{+2 pi i k l / n}
    with 1/n on each axis (the norms of the JAX package's estimator
    transforms, so that S = IDFT(DFT(a) . IDFT(b)) is the translational
    average (1/Nvol) sum_i a[i + r] b[i])."""
    dims = tuple(range(-n_axes, 0))
    return torch.fft.ifftn(z, dim=dims) if inverse else torch.fft.fftn(z, dim=dims)
