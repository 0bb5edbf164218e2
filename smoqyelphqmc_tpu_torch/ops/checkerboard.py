"""Checkerboard propagator application as gather + elementwise passes.

Port of smoqyelphqmc_tpu/ops/checkerboard.py for real hoppings. One color is

    u <- C_c (.) u + S_c (.) u[..., partner_c]

with per-site planes C_c, S_c of shape (Ltau, N) (or (N,) for a single-slice
propagator) and the site gather `partner_c`. Each 2x2 hop block is real
symmetric with unit determinant, so the transpose is the colors in reverse
order and the inverse negates S and reverses the order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..lattice import checkerboard_decomposition


@dataclasses.dataclass(frozen=True)
class CheckerboardStructure:
    """Static gather structure of a checkerboard decomposition (host NumPy).

    neighbor_table (2, n_hops) in original hop order; perm (n_hops,) original hop
    of each color-sorted position; color_slices ranges into that order;
    site_hop / site_side / partner are (n_colors, n_sites)."""

    neighbor_table: np.ndarray
    perm: np.ndarray
    color_slices: Tuple[Tuple[int, int], ...]
    site_hop: np.ndarray
    site_side: np.ndarray
    partner: np.ndarray

    @property
    def n_colors(self) -> int:
        return len(self.color_slices)

    @property
    def n_sites(self) -> int:
        return self.partner.shape[1]

    @property
    def n_hops(self) -> int:
        return self.neighbor_table.shape[1]


def build_checkerboard_structure(neighbor_table: np.ndarray, n_sites: int) -> CheckerboardStructure:
    """Color the hopping graph and precompute per-color gather maps (the same
    greedy coloring as the JAX package, so the structures are identical)."""
    neighbor_table = np.asarray(neighbor_table, dtype=np.int32)
    perm, colors = checkerboard_decomposition(neighbor_table)
    n_colors = len(colors)
    site_hop = np.zeros((max(n_colors, 1), n_sites), dtype=np.int32)
    site_side = np.zeros((max(n_colors, 1), n_sites), dtype=np.int8)
    partner = np.tile(np.arange(n_sites, dtype=np.int32), (max(n_colors, 1), 1))
    color_slices: List[Tuple[int, int]] = []
    for c, members in enumerate(colors):
        color_slices.append((int(members[0]), int(members[-1]) + 1) if len(members) else (0, 0))
        for pos in members:
            h = int(perm[pos])
            i, j = int(neighbor_table[0, h]), int(neighbor_table[1, h])
            site_hop[c, i] = h
            site_hop[c, j] = h
            site_side[c, i] = 1
            site_side[c, j] = -1
            partner[c, i] = j
            partner[c, j] = i
    if n_colors == 0:
        site_hop, site_side, partner = site_hop[:0], site_side[:0], partner[:0]
    return CheckerboardStructure(
        neighbor_table=neighbor_table,
        perm=np.asarray(perm, dtype=np.int32),
        color_slices=tuple(color_slices),
        site_hop=site_hop,
        site_side=site_side,
        partner=partner,
    )


@dataclasses.dataclass
class CheckerboardOp:
    """Per-color coefficient planes and the gather maps, on one device.

    C, S: (n_colors, *time_dims, n_sites); partner: (n_colors, n_sites) long."""

    C: torch.Tensor
    S: torch.Tensor
    partner: torch.Tensor

    @property
    def n_colors(self) -> int:
        return self.C.shape[0]

    def apply(self, u: torch.Tensor, transpose: bool = False, inverse: bool = False) -> torch.Tensor:
        """Full checkerboard product (or transpose / inverse) on (..., [Ltau,] N)."""
        order = range(self.n_colors)
        if transpose != inverse:
            order = reversed(order)
        for c in order:
            u = self.apply_color(u, c, inverse=inverse)
        return u

    def apply_color(self, u: torch.Tensor, c: int, inverse: bool = False) -> torch.Tensor:
        Sc = -self.S[c] if inverse else self.S[c]
        return self.C[c] * u + Sc * u.index_select(-1, self.partner[c])

    def to(self, device) -> "CheckerboardOp":
        return CheckerboardOp(C=self.C.to(device), S=self.S.to(device), partner=self.partner.to(device))

    def to_dtype(self, dtype: torch.dtype) -> "CheckerboardOp":
        return CheckerboardOp(C=self.C.to(dtype), S=self.S.to(dtype), partner=self.partner)


def build_checkerboard_op(
    structure: CheckerboardStructure, cosh_hop: torch.Tensor, sinh_hop: torch.Tensor
) -> CheckerboardOp:
    """Expand per-hop (..., n_hops) cosh/sinh factors into per-color site planes."""
    device = cosh_hop.device
    partner = torch.as_tensor(structure.partner, dtype=torch.long, device=device)
    n_colors, n_sites = structure.n_colors, structure.n_sites
    lead = tuple(cosh_hop.shape[:-1])
    if n_colors == 0:
        z = torch.zeros((0,) + lead + (n_sites,), dtype=cosh_hop.dtype, device=device)
        return CheckerboardOp(C=z + 1.0, S=z, partner=partner)
    site_hop = torch.as_tensor(structure.site_hop, dtype=torch.long, device=device)
    covered = torch.as_tensor(structure.site_side != 0, device=device)
    bshape = (n_colors,) + (1,) * len(lead) + (n_sites,)
    cosh_site = torch.movedim(cosh_hop[..., site_hop], -2, 0)
    sinh_site = torch.movedim(sinh_hop[..., site_hop], -2, 0)
    covered_b = covered.reshape(bshape)
    C = torch.where(covered_b, cosh_site, torch.ones((), dtype=cosh_site.dtype, device=device))
    S = torch.where(covered_b, sinh_site, torch.zeros((), dtype=sinh_site.dtype, device=device))
    return CheckerboardOp(C=C.contiguous(), S=S.contiguous(), partner=partner)


def hop_factors(t: torch.Tensor, dtau_eff: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-hop (cosh, sinh) of dtau_eff * t for real hoppings."""
    return torch.cosh(dtau_eff * t), torch.sinh(dtau_eff * t)
