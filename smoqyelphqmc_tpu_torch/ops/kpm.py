"""The tau-averaged propagator Bbar (port of smoqyelphqmc_tpu/ops/kpm.py:68-104).

Only `AveragedPropagator` / `averaged_propagator` are ported: the spectral
preconditioner diagonalises Bbar. The KPM preconditioner itself (Lanczos
bounds, Chebyshev recurrences, N > 4000) waits (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

import dataclasses

import torch

from .checkerboard import CheckerboardOp, build_checkerboard_op


@dataclasses.dataclass
class AveragedPropagator:
    """Bbar from tau-averaged checkerboard and diagonal factors."""

    cb: CheckerboardOp  # single-slice factors (n_colors, N)
    expV: torch.Tensor  # (N,)
    symmetric: bool

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.symmetric:
            u = self.cb.apply(u, transpose=True)
            u = self.expV * u
            return self.cb.apply(u)
        u = self.cb.apply(u)
        return self.expV * u


def averaged_propagator(fdm) -> AveragedPropagator:
    expV_bar, cosh_bar, sinh_bar = fdm.averaged_factors()
    cb = build_checkerboard_op(fdm.structure, cosh_bar, sinh_bar)
    return AveragedPropagator(cb=cb, expV=expV_bar, symmetric=fdm.symmetric)
