"""Measurement specification, the measurement pass and bin accumulation.

Port of the JAX package's measure/container.py:

- `MeasurementSpec` declares which correlations to measure (the same class
  and methods as the JAX package's);
- `make_measurements` is one measurement pass on (ctx, est, x), returning the
  JAX package's tree: `global` scalars, `local` per-type vectors,
  `correlations` and `composite` stacks of shape (n_pairs, Ltau+1, *L), each
  leaf an (re, im) pair of tensors on the estimator's device. The leaves
  carry the dtypes the JAX package's have: the density, its spin parts,
  double_occ and Nsqrd in the measurement dtype, every other leaf float64;
- `MeasurementAccumulator` keeps the bin sums on the device and turns them
  into NumPy once per bin.

Correlation kinds and their id semantics:
  greens, density, density_upup, density_updn, spin_z, spin_x: orbital-id pairs
  pair, bond, bond_upup, bond_updn: bond-id pairs
  current, current_upup, current_updn: hopping (t-bond) id pairs
  phonon_greens: phonon-mode-id pairs (pure boson, measured from x directly)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lattice import ModelGeometry
from ..models.fermion_path_integral import build_path_integral
from ..ops.bosonic import bosonic_action
from ..tree import tree_map
from ..updates.context import QMCContext
from .correlations import (
    measure_bond_correlation,
    measure_current_correlation,
    measure_density_correlation,
    measure_greens_correlation,
    measure_pair_correlation,
    measure_spin_z_correlation,
)
from .greens_estimator import GreensEstimator
from .local_measurements import (
    measure_bare_hopping_energy,
    measure_dispersion_energy,
    measure_holstein_energy,
    measure_hopping_amplitude,
    measure_hopping_energy,
    measure_hopping_inversion,
    measure_onsite_energy,
    measure_phonon_kinetic_energy,
    measure_phonon_position_moment,
    measure_phonon_potential_energy,
    measure_ssh_energy,
)
from .scalar import measure_double_occ, measure_n, measure_Nsqrd

ORBITAL_KINDS = (
    "greens", "greens_up", "greens_dn",
    "density", "density_upup", "density_updn", "density_dndn", "density_dnup",
    "spin_z", "spin_x",
)
BOND_KINDS = ("pair", "bond", "bond_upup", "bond_updn", "bond_dndn", "bond_dnup")
CURRENT_KINDS = ("current", "current_upup", "current_updn", "current_dndn", "current_dnup")
PHONON_KINDS = ("phonon_greens",)
ALL_KINDS = ORBITAL_KINDS + BOND_KINDS + CURRENT_KINDS + PHONON_KINDS

# spin-resolved channel per kind suffix; for spin-symmetric models dn-dn is the
# same contraction as up-up and dn-up the same as up-dn
_SPIN_CHANNEL = {
    "upup": (0, 0), "updn": (0, 1), "dndn": (1, 1), "dnup": (1, 0),
}


def _spin_channel(kind: str):
    """(spin_resolved tuple or None) for a correlation-kind name."""
    return _SPIN_CHANNEL.get(kind.rsplit("_", 1)[-1])


@dataclasses.dataclass(frozen=True)
class CorrelationRequest:
    kind: str
    id_pairs: Tuple[Tuple[int, int], ...]
    time_displaced: bool = False
    integrated: bool = False


@dataclasses.dataclass(frozen=True)
class CompositeRequest:
    name: str
    kind: str
    id_pairs: Tuple[Tuple[int, int], ...]
    coefficients: Tuple[complex, ...]  # one per id pair
    time_displaced: bool = False
    integrated: bool = False
    # per-PAIR displacement difference d_i - d_j (from the generating `ids` form);
    # folded into momentum-space phases at postprocessing (structure factors).
    pair_displacements: Optional[Tuple[Tuple[float, ...], ...]] = None


@dataclasses.dataclass
class MeasurementSpec:
    geometry: ModelGeometry
    correlations: Dict[str, CorrelationRequest] = dataclasses.field(default_factory=dict)
    composites: Dict[str, CompositeRequest] = dataclasses.field(default_factory=dict)

    def add_correlation(
        self,
        correlation: str,
        pairs: Sequence[Tuple[int, int]],
        time_displaced: bool = False,
        integrated: bool = False,
    ) -> None:
        """initialize_correlation_measurements! equivalent."""
        if correlation not in ALL_KINDS:
            raise ValueError(f"unknown correlation kind {correlation}")
        prev = self.correlations.get(correlation)
        new = tuple((int(a), int(b)) for a, b in pairs)
        all_pairs = tuple(prev.id_pairs) + new if prev else new
        self.correlations[correlation] = CorrelationRequest(
            kind=correlation,
            id_pairs=tuple(dict.fromkeys(all_pairs)),
            time_displaced=time_displaced or (prev.time_displaced if prev else False),
            integrated=integrated or (prev.integrated if prev else False),
        )

    def add_composite_correlation(
        self,
        name: str,
        correlation: str,
        coefficients: Sequence[complex],
        ids: Optional[Sequence[int]] = None,
        id_pairs: Optional[Sequence[Tuple[int, int]]] = None,
        displacement_vecs: Optional[Sequence[Sequence[float]]] = None,
        time_displaced: bool = False,
        integrated: bool = False,
    ) -> None:
        """initialize_composite_correlation_measurement! equivalent: with `ids`,
        all pairs (i, j) get coefficient c_i * conj(c_j); with `id_pairs`, the
        given pairs get the given coefficients directly."""
        if correlation not in ALL_KINDS:
            raise ValueError(f"unknown correlation kind {correlation}")
        pair_disps = None
        if ids is not None:
            pairs, coefs, disps = [], [], []
            for ki, (i, ci) in enumerate(zip(ids, coefficients)):
                for kj, (j, cj) in enumerate(zip(ids, coefficients)):
                    pairs.append((int(i), int(j)))
                    coefs.append(complex(ci) * np.conj(complex(cj)))
                    if displacement_vecs is not None:
                        di = np.asarray(displacement_vecs[ki], dtype=float)
                        dj = np.asarray(displacement_vecs[kj], dtype=float)
                        disps.append(tuple(di - dj))
            id_pairs = tuple(pairs)
            coefficients = tuple(coefs)
            pair_disps = tuple(disps) if disps else None
        else:
            if id_pairs is None:
                raise ValueError("a composite correlation needs ids or id_pairs")
            id_pairs = tuple((int(a), int(b)) for a, b in id_pairs)
            coefficients = tuple(complex(c) for c in coefficients)
        self.composites[name] = CompositeRequest(
            name=name,
            kind=correlation,
            id_pairs=id_pairs,
            coefficients=coefficients,
            time_displaced=time_displaced,
            integrated=integrated,
            pair_displacements=pair_disps,
        )


# ----------------------------------------------------------------------
# The measurement pass
# ----------------------------------------------------------------------


def _bond_t_field(est: GreensEstimator, ctx: QMCContext, fpi, bond_id: int):
    """Hopping field t(l, cell) of one t-bond as an (re, im-or-None) pair (Ltau, *L)."""
    if bond_id not in ctx.tbp.bond_ids:
        raise ValueError(
            f"current correlation requested for bond id {bond_id}, which is not a "
            f"hopping (t) bond of the tight-binding model (t-bond ids: {ctx.tbp.bond_ids})"
        )
    start, stop = ctx.tbp.bond_slices[ctx.tbp.bond_ids.index(bond_id)]
    t = fpi.t[:, start:stop].reshape((est.Ltau,) + est.L)
    t_im = None if fpi.t_im is None else fpi.t_im[:, start:stop].reshape((est.Ltau,) + est.L)
    return (t, t_im)


def _measure_one_correlation(
    ctx: QMCContext,
    spec: MeasurementSpec,
    est: GreensEstimator,
    x: torch.Tensor,
    fpi,
    req: CorrelationRequest,
    cache=None,
) -> torch.Tensor:
    """Complex128 (n_pairs, Ltau+1, *L) stack for one correlation kind (the
    accumulators are float64, as the JAX package's zeros are). `cache` is the
    pass-wide transform cache shared across all kinds and composites."""
    geo = spec.geometry
    outs = []
    for (ia, ib) in req.id_pairs:
        C = torch.zeros((est.Ltau + 1,) + est.L, dtype=torch.complex128, device=est.GR.device)
        if req.kind in ("greens", "greens_up", "greens_dn"):
            C = measure_greens_correlation(C, est, ia, ib, cache=cache)
        elif req.kind.startswith("density"):
            C = measure_density_correlation(C, est, ia, ib, spin_resolved=_spin_channel(req.kind), cache=cache)
        elif req.kind in ("spin_z", "spin_x"):
            C = measure_spin_z_correlation(C, est, ia, ib, cache=cache)
        elif req.kind == "pair":
            C = measure_pair_correlation(C, est, geo.bond(ia), geo.bond(ib), cache=cache)
        elif req.kind.startswith("bond"):
            C = measure_bond_correlation(C, est, geo.bond(ia), geo.bond(ib),
                                         spin_resolved=_spin_channel(req.kind), cache=cache)
        elif req.kind in CURRENT_KINDS:
            t1 = _bond_t_field(est, ctx, fpi, ia)
            t2 = _bond_t_field(est, ctx, fpi, ib)
            C = measure_current_correlation(C, est, geo.bond(ia), geo.bond(ib), t1, t2,
                                            spin_resolved=_spin_channel(req.kind))
        elif req.kind == "phonon_greens":
            C = _phonon_greens(C, ctx, est, x, ia, ib)
        else:  # pragma: no cover
            raise ValueError(req.kind)
        outs.append(C)
    return torch.stack(outs)


def _phonon_greens(C: torch.Tensor, ctx: QMCContext, est: GreensEstimator, x: torch.Tensor, pa: int,
                   pb: int) -> torch.Tensor:
    """Pure-boson displacement correlation <x_a(i+r, tau) x_b(i, 0)> with
    periodic tau. The float64 field is cast to the estimator's dtype, as the
    JAX package casts it (container.py:255)."""
    elph = ctx.elph
    nc = elph.n_cells
    dt = est.complex_dtype
    xa = x[pa * nc:(pa + 1) * nc, :].T.reshape((elph.Ltau,) + est.L).to(dt)
    xb = x[pb * nc:(pb + 1) * nc, :].T.reshape((elph.Ltau,) + est.L).to(dt)
    S = est.xcorr_accumulate(xa, xb)
    return C + torch.cat([S, S[:1]], dim=0)


def _pair(z: torch.Tensor, dtype=torch.float64):
    """An (re, im) pair of a complex (or real) tensor, each in `dtype`."""
    if not z.is_complex():
        return z.to(dtype), torch.zeros_like(z, dtype=dtype)
    return z.real.to(dtype), z.imag.to(dtype)


def make_measurements(ctx: QMCContext, spec: MeasurementSpec, est: GreensEstimator, x: torch.Tensor) -> Dict:
    """One full measurement pass (make_measurements, container.py:265-384).
    The estimator must already reflect the current x (the driver refreshes it
    first and records its solve's iteration count)."""
    elph, tbp = ctx.elph, ctx.tbp
    dev = est.GR.device
    fpi = build_path_integral(tbp, elph, x)
    f64 = torch.float64
    mdt = torch.float32 if est.dtype == "float32" else f64

    def scalar(v: float):
        return _pair(torch.tensor(v, dtype=f64, device=dev))

    n = measure_n(est)
    nan = scalar(float("nan"))
    glob = {
        "sgn": scalar(1.0),
        # DQMC-only entries the PFF formulation never computes; recorded as NaN
        "sgndetGup": nan,
        "sgndetGdn": nan,
        "logdetGup": nan,
        "logdetGdn": nan,
        "action_fermionic": nan,
        "action_total": nan,
        "density": _pair(2.0 * n, mdt),
        "density_up": _pair(n, mdt),
        "density_dn": _pair(n, mdt),
        "double_occ": _pair(measure_double_occ(est), mdt),
        "Nsqrd": _pair(measure_Nsqrd(est), mdt),
        "chemical_potential": _pair(tbp.mu),
        "action_bosonic": _pair(bosonic_action(elph, x)),
    }

    def stack(vals):
        return _pair(torch.stack(vals))

    local: Dict[str, object] = {}
    up = stack([measure_onsite_energy(est, tbp, o) for o in range(spec.geometry.n_orbitals)])
    local["onsite_energy_up"] = up
    local["onsite_energy_dn"] = up
    local["onsite_energy"] = (2 * up[0], 2 * up[1])
    nbond = len(tbp.bond_ids)
    if nbond:
        for name, fn in [
            ("bare_hopping_energy", lambda h: measure_bare_hopping_energy(est, tbp, h)),
            ("hopping_energy", lambda h: measure_hopping_energy(est, tbp, fpi, h)),
            ("hopping_amplitude", lambda h: measure_hopping_amplitude(tbp, fpi, h)),
            ("hopping_inversion", lambda h: measure_hopping_inversion(tbp, fpi, h)),
        ]:
            re, im = stack([fn(h) for h in range(nbond)])
            local[name + "_up"] = (re, im)
            local[name + "_dn"] = (re, im)
            local[name] = (re, im) if name in ("hopping_amplitude", "hopping_inversion") else (2 * re, 2 * im)
    if elph.nphonon:
        types = range(elph.nphonon)
        local["phonon_kin_energy"] = stack([measure_phonon_kinetic_energy(elph, x, p) for p in types])
        local["phonon_pot_energy"] = stack([measure_phonon_potential_energy(elph, x, p) for p in types])
        for mom, name in [(1, "X"), (2, "X2"), (3, "X3"), (4, "X4")]:
            local[name] = stack([measure_phonon_position_moment(elph, x, p, mom) for p in types])
    nholstein = elph.n_holstein // elph.n_cells if elph.n_cells else 0
    if nholstein:
        re, im = stack([measure_holstein_energy(est, elph, x, h) for h in range(nholstein)])
        local["holstein_energy_up"] = (re, im)
        local["holstein_energy_dn"] = (re, im)
        local["holstein_energy"] = (2 * re, 2 * im)
    nssh = elph.n_ssh // elph.n_cells if elph.n_cells else 0
    if nssh:
        re, im = stack([measure_ssh_energy(est, elph, tbp, x, s) for s in range(nssh)])
        local["ssh_energy_up"] = (re, im)
        local["ssh_energy_dn"] = (re, im)
        local["ssh_energy"] = (2 * re, 2 * im)
    ndisp = elph.n_dispersion // elph.n_cells if elph.n_cells else 0
    if ndisp:
        local["dispersion_energy"] = stack([measure_dispersion_energy(elph, x, d) for d in range(ndisp)])

    cache: Dict = {}  # pass-wide transform cache
    corr = {name: _pair(_measure_one_correlation(ctx, spec, est, x, fpi, req, cache=cache))
            for name, req in spec.correlations.items()}
    # composites are stored per pair, so postprocessing can fold coefficients
    # (r-space) and coefficient x displacement phases (structure factors) exactly
    comp = {}
    for name, creq in spec.composites.items():
        base = CorrelationRequest(kind=creq.kind, id_pairs=creq.id_pairs)
        comp[name] = _pair(_measure_one_correlation(ctx, spec, est, x, fpi, base, cache=cache))
    return {"global": glob, "local": local, "correlations": corr, "composite": comp}


def compose_composite(coefficients, stack: np.ndarray, pairs_axis: int) -> np.ndarray:
    """sum_k c_k stack[..., k, ...] along pairs_axis (complex coefficients)."""
    coefs = np.asarray(coefficients)
    return np.moveaxis(stack, pairs_axis, -1) @ coefs


# ----------------------------------------------------------------------
# Bin accumulation
# ----------------------------------------------------------------------


class MeasurementAccumulator:
    """Sums measurement trees into bin averages. The sums stay on the
    measurement's device (one add per leaf a sweep); `finalize_bin` moves
    them to the host once per bin."""

    def __init__(self, spec: MeasurementSpec):
        self.spec = spec
        self.count = 0
        self.sums: Optional[dict] = None

    def accumulate(self, result) -> None:
        self.sums = result if self.sums is None else tree_map(torch.add, self.sums, result)
        self.count += 1

    def finalize_bin(self):
        """Return the bin-averaged tree (NumPy, host) and reset."""
        if self.count <= 0:
            raise ValueError("empty bin")
        avg = tree_map(lambda s: s.cpu().numpy() / self.count, self.sums)
        self.sums = None
        self.count = 0
        return avg
