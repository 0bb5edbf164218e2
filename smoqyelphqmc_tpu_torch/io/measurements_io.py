"""Binned measurement output: HDF5 bins, merging, and final statistics (a copy
of the JAX package's io/measurements_io.py, which the port cannot import
without importing jax; bin trees arrive as NumPy).

Covers SmoQyDQMC's write_measurements! / merge_bins / process_measurements
capability as driven by the reference tutorials
(tutorials/holstein_honeycomb.jl:676-736): bin averages are
written per bin (and per walker pID), merged into one archive, then re-binned and
reduced to mean +- stderr, with optional CSV export in position and momentum
space and integrated (susceptibility) columns."""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import h5py
import numpy as np

from .simulation_info import SimulationInfo


def _to_complex(pair) -> np.ndarray:
    re_, im_ = pair
    return np.asarray(re_) + 1j * np.asarray(im_)


def write_measurement_bin(
    sim_info: SimulationInfo,
    bin_index: int,
    bin_avg: Dict,
    spec=None,
    dtau: Optional[float] = None,
) -> str:
    """Write one bin-averaged measurement pytree to bins/bin-<k>_pID-<p>.h5."""
    path = os.path.join(sim_info.bins_folder, f"bin-{bin_index}_pID-{sim_info.pID}.h5")
    with h5py.File(path, "w") as f:
        if dtau is not None:
            f.attrs["dtau"] = dtau
        for category in ("global", "local", "correlations", "composite"):
            grp = f.create_group(category)
            for name, val in bin_avg.get(category, {}).items():
                data = _to_complex(val)
                ds = grp.create_dataset(name, data=data)
                if spec is not None and category == "correlations" and name in spec.correlations:
                    req = spec.correlations[name]
                    ds.attrs["time_displaced"] = req.time_displaced
                    ds.attrs["integrated"] = req.integrated
                    ds.attrs["id_pairs"] = np.asarray(req.id_pairs, dtype=np.int64)
                if spec is not None and category == "composite" and name in spec.composites:
                    req = spec.composites[name]
                    ds.attrs["time_displaced"] = req.time_displaced
                    ds.attrs["integrated"] = req.integrated
                    ds.attrs["coefficients"] = np.asarray(req.coefficients, dtype=np.complex128)
                    if req.pair_displacements is not None:
                        ds.attrs["pair_displacements"] = np.asarray(req.pair_displacements)
    return path


def merge_bins(sim_info: SimulationInfo, delete_bins: bool = False) -> str:
    """Merge per-bin files of ALL walkers into binned_data.h5 with a leading bin
    axis (merge_bins equivalent)."""
    files = sorted(
        glob.glob(os.path.join(sim_info.bins_folder, "bin-*_pID-*.h5")),
        key=lambda p: (
            int(re.search(r"pID-(\d+)", p).group(1)),
            int(re.search(r"bin-(\d+)", p).group(1)),
        ),
    )
    out_path = os.path.join(sim_info.datafolder, "binned_data.h5")
    with h5py.File(out_path, "w") as out:
        first = True
        for k, path in enumerate(files):
            with h5py.File(path, "r") as f:
                if first:
                    out.attrs["n_bins"] = len(files)
                    if "dtau" in f.attrs:
                        out.attrs["dtau"] = f.attrs["dtau"]
                for category in ("global", "local", "correlations", "composite"):
                    if category not in f:
                        continue
                    grp = out.require_group(category)
                    for name, ds in f[category].items():
                        data = ds[()]
                        if first:
                            full = grp.create_dataset(
                                name, shape=(len(files),) + np.shape(data), dtype=np.complex128
                            )
                            for attr, v in ds.attrs.items():
                                full.attrs[attr] = v
                        grp[name][k] = data
                first = False
    if delete_bins:
        for path in files:
            os.remove(path)
    return out_path


def _rebin(data: np.ndarray, n_bins: int) -> np.ndarray:
    """Average consecutive bins down to n_bins along axis 0."""
    nb = data.shape[0]
    n_bins = min(n_bins, nb)
    use = (nb // n_bins) * n_bins
    return data[:use].reshape(n_bins, nb // n_bins, *data.shape[1:]).mean(axis=1)


def _stats(data: np.ndarray):
    """(mean, stderr) over the bin axis."""
    nb = data.shape[0]
    mean = data.mean(axis=0)
    if nb > 1:
        err = (
            np.std(data.real, axis=0, ddof=1) + 1j * np.std(data.imag, axis=0, ddof=1)
        ) / np.sqrt(nb)
    else:
        err = np.zeros_like(mean)
    return mean, err


def _orbital_pair_phase(geometry, id_pair, kind: str, Lshape) -> Optional[np.ndarray]:
    """Momentum-space basis phase exp(-i q . (d_a - d_b)) over the q grid for an
    orbital-pair correlation (JDQMCMeasurements.fourier_transform! capability:
    basis-vector phase factors in the r -> k transform). Bond/current kinds use
    the final orbital of each bond; returns None when no phase applies."""
    from ..measure.container import BOND_KINDS, CURRENT_KINDS, ORBITAL_KINDS

    if geometry is None:
        return None
    a, b = id_pair
    if kind in ORBITAL_KINDS:
        da = np.asarray(geometry.unit_cell.basis_vecs[a])
        db = np.asarray(geometry.unit_cell.basis_vecs[b])
    elif kind in BOND_KINDS + CURRENT_KINDS:
        ba, bb = geometry.bond(a), geometry.bond(b)
        da = np.asarray(geometry.unit_cell.basis_vecs[ba.orbitals[1]])
        db = np.asarray(geometry.unit_cell.basis_vecs[bb.orbitals[1]])
    else:
        return None
    dd = da - db
    if not np.any(dd):
        return None
    B = geometry.unit_cell.reciprocal_vec_matrix  # rows b_d
    grids = np.meshgrid(*[np.arange(l) for l in Lshape], indexing="ij")
    phase = np.zeros(tuple(Lshape))
    for d, g in enumerate(grids):
        phase = phase + (g / Lshape[d]) * float(B[d] @ dd)
    return np.exp(-1j * phase)


def process_measurements(
    datafolder: str,
    n_bins: Optional[int] = None,
    export_to_csv: bool = True,
    decimals: int = 7,
    delimiter: str = " ",
    scientific_notation: bool = False,
    spec=None,
) -> str:
    """Re-bin, reduce to mean +- stderr, write stats.h5 (+ CSV files).

    CSV layout mirrors the reference's exports: global / local tables, and per
    correlation a position-space and momentum-space table including equal-time,
    time-displaced and integrated (Simpson/trapezoid susceptibility) variants.
    """
    merged = os.path.join(datafolder, "binned_data.h5")
    assert os.path.exists(merged), "run merge_bins first"
    stats_path = os.path.join(datafolder, "stats.h5")
    fmt = (
        (lambda x: f"%.{decimals}e" % x)
        if scientific_notation
        else (lambda x: f"%.{decimals}f" % x)
    )

    def write_csv(name, header, rows):
        if not export_to_csv:
            return
        with open(os.path.join(datafolder, name), "w") as f:
            f.write(delimiter.join(header) + "\n")
            for row in rows:
                f.write(delimiter.join(str(v) if isinstance(v, (str, int)) else fmt(v) for v in row) + "\n")

    with h5py.File(merged, "r") as f, h5py.File(stats_path, "w") as out:
        dtau = float(f.attrs.get("dtau", 0.0))
        nb_raw = int(f.attrs["n_bins"])
        nb = n_bins or nb_raw

        # ---- global / local scalars ----
        rows_g = []
        for category in ("global", "local"):
            if category not in f:
                continue
            grp_out = out.require_group(category)
            for name, ds in f[category].items():
                data = _rebin(ds[()], nb)
                mean, err = _stats(data)
                g = grp_out.create_group(name)
                g.create_dataset("mean", data=mean)
                g.create_dataset("std", data=err)
                if np.ndim(mean) == 0:
                    rows_g.append((category, name, "0", mean.real, mean.imag, np.abs(err)))
                else:
                    for i, (m, e) in enumerate(zip(np.atleast_1d(mean), np.atleast_1d(err))):
                        rows_g.append((category, name, str(i), m.real, m.imag, np.abs(e)))
        write_csv(
            "global_stats.csv",
            ["category", "name", "id", "mean_real", "mean_imag", "std"],
            rows_g,
        )

        # ---- correlations ----
        for category in ("correlations", "composite"):
            if category not in f:
                continue
            grp_out = out.require_group(category)
            for name, ds in f[category].items():
                data = _rebin(ds[()], nb)  # (nb, pairs, Lt+1, *L)
                time_displaced = bool(ds.attrs.get("time_displaced", False))
                integrated = bool(ds.attrs.get("integrated", False))
                lat_axes = tuple(range(3, data.ndim))
                Lshape = data.shape[3:]
                data_q = np.fft.fftn(data, axes=lat_axes)
                if category == "composite":
                    # compose per-pair stacks: plain coefficients in r-space,
                    # coefficient x displacement phase in momentum space
                    coefs = np.asarray(ds.attrs.get("coefficients", np.ones(data.shape[1])))
                    data = np.einsum("k,bk...->b...", coefs, data)
                    phases = np.ones((len(coefs),) + tuple(Lshape), dtype=complex)
                    if "pair_displacements" in ds.attrs and spec is not None:
                        B = spec.geometry.unit_cell.reciprocal_vec_matrix
                        disps = np.asarray(ds.attrs["pair_displacements"])
                        grids = np.meshgrid(*[np.arange(l) for l in Lshape], indexing="ij")
                        for k in range(len(coefs)):
                            ang = np.zeros(tuple(Lshape))
                            for d, g in enumerate(grids):
                                ang = ang + (g / Lshape[d]) * float(B[d] @ disps[k])
                            phases[k] = np.exp(-1j * ang)
                    data_q = np.einsum("k,k...,bk...->b...", coefs, phases, data_q)
                elif category == "correlations" and spec is not None and name in spec.correlations:
                    # orbital basis-vector phases in momentum space
                    req = spec.correlations[name]
                    for k, pair in enumerate(req.id_pairs):
                        ph = _orbital_pair_phase(spec.geometry, pair, req.kind, Lshape)
                        if ph is not None:
                            data_q[:, k] = data_q[:, k] * ph[None, None]
                mean, err = _stats(data)
                g = grp_out.create_group(name)
                g.create_dataset("mean_r", data=mean)
                g.create_dataset("std_r", data=err)
                mean_q, err_q = _stats(data_q)
                g.create_dataset("mean_q", data=mean_q)
                g.create_dataset("std_q", data=err_q)
                g.attrs["time_displaced"] = time_displaced
                g.attrs["integrated"] = integrated
                if "id_pairs" in ds.attrs:
                    g.attrs["id_pairs"] = ds.attrs["id_pairs"]

                # equal-time row and integrated susceptibility
                def tau_reduce(arr):
                    # arr: (nb, pairs, Lt+1, *L) or composed (nb, Lt+1, *L)
                    tau_ax = 1 if category == "composite" else 2
                    eq = np.take(arr, 0, axis=tau_ax)
                    if dtau > 0:
                        w = np.ones(arr.shape[tau_ax])
                        w[0] = w[-1] = 0.5
                        shape = [1] * arr.ndim
                        shape[tau_ax] = -1
                        chi = dtau * np.sum(arr * w.reshape(shape), axis=tau_ax)
                    else:
                        chi = eq
                    return eq, chi

                eq_r, chi_r = tau_reduce(data)
                eq_q, chi_q = tau_reduce(data_q)
                for tag, arr in [
                    ("equal_time_r", eq_r),
                    ("equal_time_q", eq_q),
                    ("integrated_r", chi_r),
                    ("integrated_q", chi_q),
                ]:
                    m, e = _stats(arr)
                    g.create_dataset(tag + "_mean", data=m)
                    g.create_dataset(tag + "_std", data=e)

                if export_to_csv:
                    def export(tag, arr):
                        m, e = _stats(arr)
                        rows = [
                            (name, "|".join(map(str, idx)), m[idx].real, m[idx].imag, np.abs(e[idx]))
                            for idx in np.ndindex(m.shape)
                        ]
                        write_csv(
                            f"{category}_{name}_{tag}.csv",
                            ["name", "index", "mean_real", "mean_imag", "std"],
                            rows,
                        )

                    # the reference's CSV output set: equal-time always, plus
                    # time-displaced and integrated tables when requested, each
                    # in position and momentum space
                    export("equal_time", eq_r)
                    export("equal_time_momentum", eq_q)
                    if time_displaced:
                        export("time_displaced", data)
                        export("time_displaced_momentum", data_q)
                    if integrated:
                        export("integrated", chi_r)
                        export("integrated_momentum", chi_q)
    return stats_path
