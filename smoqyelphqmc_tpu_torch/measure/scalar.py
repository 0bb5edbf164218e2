"""Scalar stochastic measurements: density, <N^2>, double occupancy.

Port of the JAX package's measure/scalar.py: batched reductions over the
random-vector block, with pair sums through
sum_{i != j} a_i b_j = (sum a)(sum b) - sum a_i b_i. Each result is a complex
0-dim tensor in the estimator's complex dtype (the JAX package returns an
(re, im) pair)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .greens_estimator import GreensEstimator


def _fields(est: GreensEstimator, orbital: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(GR, conj(R)) as complex (Nrv, Ltau, ...) fields of one orbital, or of
    every site when orbital is None."""
    if orbital is None:
        return torch.complex(est.GR[:, 0], est.GR[:, 1]), torch.complex(est.R[:, 0], -est.R[:, 1])
    return est.orbital_fields(orbital)


def measure_n(est: GreensEstimator, orbital: Optional[int] = None) -> torch.Tensor:
    """Single-spin density n = 1 - <conj(R) . GR> / V."""
    GR, Rc = _fields(est, orbital)
    return 1.0 - torch.sum(Rc * GR) / GR.numel()


def measure_Nsqrd(est: GreensEstimator) -> torch.Tensor:
    """<N^2> from pairs of independent random vectors; spin-degenerate,
    N = 2 sum_i n_i."""
    GR, Rc = _fields(est, None)
    Nrv, Ltau = est.Nrv, est.Ltau
    V = Ltau * est.n_sites
    Dm = torch.einsum("iln,jln->ij", Rc, GR)  # D[i, j] = <R_i, GR_j>
    trG = torch.diagonal(Dm)  # per-vector Tr[G] estimates
    npairs2 = Nrv * (Nrv - 1)  # ordered pairs
    # <N>^2 = 4 mean_{i != j} (V - TrG_i)(V - TrG_j) / Ltau^2
    a = V - trG
    s = a.sum()
    Nbar2 = 4.0 * (s * s - (a * a).sum()) / (npairs2 * Ltau**2)
    TrG = trG.sum() / (Nrv * Ltau)
    # Tr[G]^2 cross estimate: mean_{i != j} D[j, i] D[i, j] / Ltau^2
    TrG2 = ((Dm * Dm.T).sum() - (trG * trG).sum()) / (npairs2 * Ltau**2)
    return Nbar2 + 2.0 * TrG / Ltau - 2.0 * TrG2


def measure_double_occ(est: GreensEstimator, orbital: Optional[int] = None) -> torch.Tensor:
    """<n_up n_dn> = mean over vector pairs of
    (1/V) sum_r (1 - GR_i conj(R_i)) (1 - GR_j conj(R_j))."""
    GR, Rc = _fields(est, orbital)
    V = GR[0].numel()
    W = 1.0 - GR * Rc  # (Nrv, ...)
    s = W.sum(dim=0)
    return torch.sum(s * s - (W * W).sum(dim=0)) / (est.Nrv * (est.Nrv - 1) * V)
