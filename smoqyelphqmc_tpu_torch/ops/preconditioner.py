"""Preconditioner interface: build / refresh (port of
the JAX package's ops/preconditioner.py).

The KPM preconditioner's Lanczos iteration starts from a vector the caller
draws (`v0`, shape (N,), or (2N,) for complex hoppings); the spectral
preconditioner ignores it."""

from __future__ import annotations

from typing import Optional

import torch

from .kpm import KPMPreconditioner, kpm_update
from .spectral_precond import SpectralPreconditioner, build_spectral, spectral_update

# The JAX package's auto crossover (sites), kept for parity. It was measured
# on a TPU; re-measuring it on the H100 waits (ROADMAP Queue 1, item 16).
AUTO_SPECTRAL_MAX_SITES = 4000


def resolve_kind(kind: Optional[str], n_sites: int) -> Optional[str]:
    """'spectral', 'kpm' or None for a requested kind ('auto' picks spectral
    up to AUTO_SPECTRAL_MAX_SITES, KPM above)."""
    if kind is None or kind == "none":
        return None
    if kind == "auto":
        return "spectral" if n_sites <= AUTO_SPECTRAL_MAX_SITES else "kpm"
    if kind in ("spectral", "kpm"):
        return kind
    raise ValueError(f"unknown preconditioner kind {kind!r}")


def _start_vector(v0: Optional[torch.Tensor]) -> torch.Tensor:
    if v0 is None:
        raise ValueError("the KPM preconditioner needs the Lanczos start vector v0")
    return v0


def build_preconditioner(kind: Optional[str], fdm, v0: Optional[torch.Tensor] = None):
    """kind: 'auto', 'spectral', 'kpm', or None / 'none'; v0 starts the KPM
    preconditioner's Lanczos iteration."""
    kind = resolve_kind(kind, fdm.n_sites)
    if kind == "spectral":
        return build_spectral(fdm)
    if kind == "kpm":
        return KPMPreconditioner.build(fdm, _start_vector(v0))
    return None


def refresh_preconditioner(precond, fdm, v0: Optional[torch.Tensor] = None):
    if precond is None:
        return None
    if isinstance(precond, SpectralPreconditioner):
        return spectral_update(precond, fdm)
    if isinstance(precond, KPMPreconditioner):
        return kpm_update(precond, fdm, _start_vector(v0))
    raise TypeError(f"unknown preconditioner {type(precond).__name__}")
