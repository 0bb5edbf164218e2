"""Physical correlation functions as signed sums of Wick contractions.

Port of the JAX package's measure/correlations.py: each correlation composes
the three contraction topologies of measure/greens_estimator.py with the
spin-degeneracy factors of a spin-symmetric model (4 for parallel-spin
combinations, 2 for the exchange terms; the spin-resolved variants drop
them). Every function adds into a complex (Ltau+1, *L) accumulator C and
returns the new accumulator."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..lattice import Bond
from .greens_estimator import GreensEstimator, Weight, measure_G, measure_G0D_GD0, measure_GD0_GD0, measure_GDD_G00
from .scalar import measure_n


def _zero(est: GreensEstimator):
    return (0,) * est.D


def measure_greens_correlation(C: torch.Tensor, est: GreensEstimator, a: int, b: int, coef: float = 1.0,
                               cache=None) -> torch.Tensor:
    """Time-displaced single-particle Green's function G_ab(r, tau)."""
    return C + coef * measure_G(est, (a, b), cache=cache)


def measure_density_correlation(C: torch.Tensor, est: GreensEstimator, a: int, b: int, coef: float = 1.0,
                                spin_resolved: Optional[Tuple[int, int]] = None, cache=None) -> torch.Tensor:
    """Density-density correlation."""
    z = _zero(est)
    if spin_resolved is None:
        pref, exch, same_spin = 4.0, -2.0, True
    else:
        pref, exch, same_spin = 1.0, -1.0, spin_resolved[0] == spin_resolved[1]
    C = C + pref * coef * (measure_n(est, a) + measure_n(est, b) - 1.0)
    C = C + measure_GDD_G00(est, (a, a, b, b), z, z, z, z, pref * coef, cache=cache)
    if same_spin:
        C = C + measure_G0D_GD0(est, (b, a, a, b), z, z, z, z, exch * coef, cache=cache)
    return C


def measure_pair_correlation(C: torch.Tensor, est: GreensEstimator, b1: Bond, b2: Bond, coef: float = 1.0,
                             cache=None) -> torch.Tensor:
    """Local s-wave (bond) pair correlation: the bond's orbitals are (b, a)
    with displacement r'."""
    b, a = b1.orbitals
    d, c = b2.orbitals
    z = _zero(est)
    return C + measure_GD0_GD0(est, (a, c, b, d), b1.displacement, b2.displacement, z, z, coef, cache=cache)


def measure_spin_z_correlation(C: torch.Tensor, est: GreensEstimator, a: int, b: int, coef: float = 1.0,
                               cache=None) -> torch.Tensor:
    """S_z - S_z correlation; identical to S_x / S_y for spin-symmetric models."""
    z = _zero(est)
    return C + measure_G0D_GD0(est, (b, a, a, b), z, z, z, z, -0.5 * coef, cache=cache)


measure_spin_x_correlation = measure_spin_z_correlation


def measure_bond_correlation(C: torch.Tensor, est: GreensEstimator, b1: Bond, b2: Bond, coef: float = 1.0,
                             spin_resolved: Optional[Tuple[int, int]] = None, cache=None) -> torch.Tensor:
    """Bond-bond (kinetic-energy) correlation: 4 GDD.G00 + 4 G0D.GD0 terms."""
    b, a = b1.orbitals
    rp = b1.displacement
    d, c = b2.orbitals
    rpp = b2.displacement
    z = _zero(est)
    if spin_resolved is None:
        pref, exch, same_spin = 4.0, -2.0, True
    else:
        pref, exch, same_spin = 1.0, -1.0, spin_resolved[0] == spin_resolved[1]
    C = C + measure_GDD_G00(est, (a, b, c, d), rp, z, rpp, z, pref * coef, cache=cache)
    C = C + measure_GDD_G00(est, (a, b, d, c), rp, z, z, rpp, pref * coef, cache=cache)
    C = C + measure_GDD_G00(est, (b, a, c, d), z, rp, rpp, z, pref * coef, cache=cache)
    C = C + measure_GDD_G00(est, (b, a, d, c), z, rp, z, rpp, pref * coef, cache=cache)
    if same_spin:
        C = C + measure_G0D_GD0(est, (c, b, a, d), rpp, z, rp, z, exch * coef, cache=cache)
        C = C + measure_G0D_GD0(est, (d, b, a, c), z, z, rp, rpp, exch * coef, cache=cache)
        C = C + measure_G0D_GD0(est, (c, a, b, d), rpp, rp, z, z, exch * coef, cache=cache)
        C = C + measure_G0D_GD0(est, (d, a, b, c), z, rp, z, rpp, exch * coef, cache=cache)
    return C


def measure_current_correlation(C: torch.Tensor, est: GreensEstimator, b1: Bond, b2: Bond, t1: Weight,
                                t2: Weight, coef: float = 1.0, spin_resolved: Optional[Tuple[int, int]] = None,
                                cache=None) -> torch.Tensor:
    """Current-current correlation weighted by the time-dependent hopping
    fields t1, t2 of the two bonds, each an (re, im-or-None) pair of
    (Ltau, *L) tensors."""
    b, a = b1.orbitals
    rp = b1.displacement
    d, c = b2.orbitals
    rpp = b2.displacement
    z = _zero(est)
    if spin_resolved is None:
        pref, exch, same_spin = 4.0, 2.0, True
    else:
        pref, exch, same_spin = 1.0, 1.0, spin_resolved[0] == spin_resolved[1]
    C = C + measure_GDD_G00(est, (a, b, d, c), rp, z, z, rpp, +pref * coef, t1, t2, True, False)
    C = C + measure_GDD_G00(est, (a, b, c, d), rp, z, rpp, z, -pref * coef, t1, t2, True, True)
    C = C + measure_GDD_G00(est, (b, a, d, c), z, rp, z, rpp, -pref * coef, t1, t2, False, False)
    C = C + measure_GDD_G00(est, (b, a, c, d), z, rp, rpp, z, +pref * coef, t1, t2, False, True)
    if same_spin:
        C = C + measure_G0D_GD0(est, (b, a, c, d), z, z, rp, rpp, -exch * coef, t1, t2, True, False)
        C = C + measure_G0D_GD0(est, (b, a, d, c), rpp, z, rp, z, +exch * coef, t1, t2, True, True)
        C = C + measure_G0D_GD0(est, (d, a, b, c), z, rp, z, rpp, +exch * coef, t1, t2, False, False)
        C = C + measure_G0D_GD0(est, (c, a, b, d), rpp, rp, z, z, -exch * coef, t1, t2, False, True)
    return C
