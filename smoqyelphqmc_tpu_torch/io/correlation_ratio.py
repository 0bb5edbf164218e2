"""Correlation-ratio postprocessing (a copy of the JAX package's io/correlation_ratio.py,
which the port cannot import without importing jax).

Covers SmoQyDQMC's compute_correlation_ratio / compute_composite_correlation_ratio
as used by the reference tutorial (tutorials/holstein_honeycomb.jl:760-770):

    R(Q) = 1 - (1/n_dq) sum_dq S(Q + dq) / S(Q)

from the equal-time structure factor S(q), with jackknife error bars over bins.
h5py is imported only by the functions that read a data folder:
`composite_ratio_from_bins` computes the ratio from `driver.simulate`'s
in-memory bins where h5py is absent.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

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


def composite_ratio(
    data: np.ndarray,
    coefficients,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    type: str = "equal-time",
    pair_displacements=None,
    spec=None,
) -> Tuple[complex, float]:
    """The correlation ratio of a composite correlation from its binned
    per-pair data (nb, n_pairs, Lt+1, *L): the coefficients (and the
    displacement phases, when given and `spec` provides the reciprocal
    lattice) fold in here, then the jackknife over bins."""
    coefs = np.asarray(coefficients)
    if type == "equal-time":
        Cr = data[:, :, 0]
    else:  # integrated (trapezoid weights, unit dtau scale cancels in the ratio)
        w = np.ones(data.shape[2])
        w[0] = w[-1] = 0.5
        Cr = np.tensordot(data, w, axes=([2], [0]))
    Sq_pairs = np.fft.fftn(Cr, axes=tuple(range(2, Cr.ndim)))  # (nb, n_pairs, *L)
    Lshape = Sq_pairs.shape[2:]
    phases = np.ones((len(coefs),) + tuple(Lshape), dtype=complex)
    if pair_displacements is not None and spec is not None:
        disps = np.asarray(pair_displacements)
        B = spec.geometry.unit_cell.reciprocal_vec_matrix
        grids = np.meshgrid(*[np.arange(l) for l in Lshape], indexing="ij")
        for k in range(len(coefs)):
            ang = np.zeros(tuple(Lshape))
            for d, g in enumerate(grids):
                ang = ang + (g / Lshape[d]) * float(B[d] @ disps[k])
            phases[k] = np.exp(-1j * ang)
    Sq = np.einsum("k,k...,bk...->b...", coefs, phases, Sq_pairs)
    return _ratio_from_bins(Sq, q_point, q_neighbors)


def composite_ratio_from_bins(
    bins: Dict,
    name: str,
    spec,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    type: str = "equal-time",
) -> Tuple[complex, float]:
    """`composite_ratio` of in-memory bins ({bin key: bin tree}, the trees
    `driver.simulate` yields, keyed by bin index at W = 1 and by (pID, bin
    index) at W >= 2), stacked in key order as `merge_bins` stacks the bin
    files, with the coefficients and displacements of spec's request."""
    data = np.stack([np.asarray(re, dtype=np.float64) + 1j * np.asarray(im, dtype=np.float64)
                     for re, im in (bins[k]["composite"][name] for k in sorted(bins))])
    req = spec.composites[name]
    return composite_ratio(data, np.asarray(req.coefficients, dtype=np.complex128), q_point, q_neighbors, type,
                           req.pair_displacements, spec)


def compute_composite_correlation_ratio(
    datafolder: str,
    name: str,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    type: str = "equal-time",
    spec=None,
) -> Tuple[complex, float]:
    """Correlation ratio for a composite correlation measured during the run,
    read from the data folder's binned_data.h5 (`composite_ratio`)."""
    import h5py

    merged = os.path.join(datafolder, "binned_data.h5")
    with h5py.File(merged, "r") as f:
        ds = f["composite"][name]
        data = ds[()]  # (nb, n_pairs, Lt+1, *L)
        coefs = np.asarray(ds.attrs.get("coefficients", np.ones(data.shape[1])))
        disps = np.asarray(ds.attrs["pair_displacements"]) if "pair_displacements" in ds.attrs else None
    return composite_ratio(data, coefs, q_point, q_neighbors, type, disps, spec)


def compute_correlation_ratio(
    datafolder: str,
    correlation: str,
    q_point: Sequence[int],
    q_neighbors: Sequence[Sequence[int]],
    pairs: Sequence[int] | None = None,
    type: str = "equal-time",
) -> Tuple[complex, float]:
    """Correlation ratio for a plain correlation (id pairs summed, or a subset)."""
    import h5py

    merged = os.path.join(datafolder, "binned_data.h5")
    with h5py.File(merged, "r") as f:
        data = f["correlations"][correlation][()]  # (nb, pairs, Lt+1, *L)
    if pairs is not None:
        data = data[:, list(pairs)]
    Cr = data[:, :, 0] if type == "equal-time" else data.mean(axis=2)
    Sq = np.fft.fftn(Cr, axes=tuple(range(2, Cr.ndim)))
    return _ratio_from_bins(Sq, q_point, q_neighbors)
