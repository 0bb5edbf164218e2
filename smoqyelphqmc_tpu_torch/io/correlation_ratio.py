"""Correlation-ratio postprocessing (a copy of the JAX package's io/correlation_ratio.py,
which the port cannot import without importing jax).

Covers SmoQyDQMC's compute_correlation_ratio / compute_composite_correlation_ratio
as used by the reference tutorial (tutorials/holstein_honeycomb.jl:760-770):

    R(Q) = 1 - (1/n_dq) sum_dq S(Q + dq) / S(Q)

from the equal-time structure factor S(q), with jackknife error bars over bins.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import h5py
import numpy as np


def _jackknife_ratio(values: np.ndarray):
    """values: (n_bins,) complex per-bin ratios from bin-wise S; jackknife over bins."""
    nb = values.shape[0]
    if nb < 2:
        return values.mean(), 0.0
    total = values.sum()
    jack = (total - values) / (nb - 1)
    mean = jack.mean()
    err = np.sqrt((nb - 1) * np.mean(np.abs(jack - mean) ** 2))
    return mean, float(err)


def _ratio_from_bins(Sq: np.ndarray, q_point, q_neighbors):
    """Sq: (nb, [pairs], *L) per-bin equal-time structure factor; pairs summed."""
    if Sq.ndim > 1 + len(q_point):
        Sq = Sq.sum(axis=1)
    S0 = Sq[(slice(None),) + tuple(int(v) for v in q_point)]
    acc = np.zeros_like(S0)
    for dq in q_neighbors:
        acc += Sq[(slice(None),) + tuple(int(v) for v in dq)]
    ratios = 1.0 - (acc / len(q_neighbors)) / S0
    return _jackknife_ratio(ratios)


def compute_composite_correlation_ratio(
    datafolder: str,
    name: str,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    type: str = "equal-time",
    spec=None,
) -> Tuple[complex, float]:
    """Correlation ratio for a composite correlation measured during the run.
    Composite data is stored per id-pair; coefficients (and displacement phases
    when present and `spec` provides the reciprocal lattice) fold in here."""
    merged = os.path.join(datafolder, "binned_data.h5")
    with h5py.File(merged, "r") as f:
        ds = f["composite"][name]
        data = ds[()]  # (nb, n_pairs, Lt+1, *L)
        coefs = np.asarray(ds.attrs.get("coefficients", np.ones(data.shape[1])))
        disps = np.asarray(ds.attrs["pair_displacements"]) if "pair_displacements" in ds.attrs else None
    if type == "equal-time":
        Cr = data[:, :, 0]
    else:  # integrated (trapezoid weights, unit dtau scale cancels in the ratio)
        w = np.ones(data.shape[2])
        w[0] = w[-1] = 0.5
        Cr = np.tensordot(data, w, axes=([2], [0]))
    Sq_pairs = np.fft.fftn(Cr, axes=tuple(range(2, Cr.ndim)))  # (nb, n_pairs, *L)
    Lshape = Sq_pairs.shape[2:]
    phases = np.ones((len(coefs),) + tuple(Lshape), dtype=complex)
    if disps is not None and spec is not None:
        B = spec.geometry.unit_cell.reciprocal_vec_matrix
        grids = np.meshgrid(*[np.arange(l) for l in Lshape], indexing="ij")
        for k in range(len(coefs)):
            ang = np.zeros(tuple(Lshape))
            for d, g in enumerate(grids):
                ang = ang + (g / Lshape[d]) * float(B[d] @ disps[k])
            phases[k] = np.exp(-1j * ang)
    Sq = np.einsum("k,k...,bk...->b...", coefs, phases, Sq_pairs)
    return _ratio_from_bins(Sq, q_point, q_neighbors)


def compute_correlation_ratio(
    datafolder: str,
    correlation: str,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    pairs: Sequence[int] | None = None,
    type: str = "equal-time",
) -> Tuple[complex, float]:
    """Correlation ratio for a plain correlation (id pairs summed, or a subset)."""
    merged = os.path.join(datafolder, "binned_data.h5")
    with h5py.File(merged, "r") as f:
        data = f["correlations"][correlation][()]  # (nb, pairs, Lt+1, *L)
    if pairs is not None:
        data = data[:, list(pairs)]
    Cr = data[:, :, 0] if type == "equal-time" else data.mean(axis=2)
    Sq = np.fft.fftn(Cr, axes=tuple(range(2, Cr.ndim)))
    return _ratio_from_bins(Sq, q_point, q_neighbors)
