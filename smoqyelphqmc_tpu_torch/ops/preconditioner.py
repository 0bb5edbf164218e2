"""Preconditioner interface: build / refresh (port of
smoqyelphqmc_tpu/ops/preconditioner.py). Only the spectral preconditioner is
ported; KPM waits (ROADMAP Queue 1, item 16)."""

from __future__ import annotations

from typing import Optional

from .spectral_precond import SpectralPreconditioner, build_spectral, spectral_update

# The JAX package's auto crossover (sites). It was measured on a TPU; here it
# only marks where `auto` would pick the unported KPM preconditioner.
AUTO_SPECTRAL_MAX_SITES = 4000

_KPM_TODO = "the KPM preconditioner is not ported yet (ROADMAP Queue 1, item 16)"


def build_preconditioner(kind: Optional[str], fdm):
    """kind: 'auto' (spectral up to AUTO_SPECTRAL_MAX_SITES), 'spectral',
    'kpm' (not ported), or None / 'none'."""
    if kind is None or kind == "none":
        return None
    if kind == "auto":
        if fdm.n_sites > AUTO_SPECTRAL_MAX_SITES:
            raise NotImplementedError(f"auto picks KPM at N = {fdm.n_sites}: {_KPM_TODO}")
        kind = "spectral"
    if kind == "spectral":
        return build_spectral(fdm)
    if kind == "kpm":
        raise NotImplementedError(_KPM_TODO)
    raise ValueError(f"unknown preconditioner kind {kind!r}")


def refresh_preconditioner(precond, fdm):
    if precond is None:
        return None
    if isinstance(precond, SpectralPreconditioner):
        return spectral_update(precond, fdm)
    raise TypeError(f"unknown preconditioner {type(precond).__name__}")
