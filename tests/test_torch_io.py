"""The port's io modules against the JAX package's on the same inputs: TOML
text (model summary, simulation info), the density-tuning profile, the HDF5
datasets and attributes of bins, merged bins and statistics, the CSV exports
and the correlation ratios must be equal; checkpoints round-trip tensors as
NumPy and keep the JAX package's file names and gates."""

import glob
import os

import h5py
import numpy as np
import torch

from _models import honeycomb_model
from _torch_common import port_honeycomb_model

from smoqyelphqmc_tpu.io import checkpoint as jcheckpoint
from smoqyelphqmc_tpu.io import correlation_ratio as jratio
from smoqyelphqmc_tpu.io import measurements_io as jmio
from smoqyelphqmc_tpu.io import simulation_info as jsi
from smoqyelphqmc_tpu.measure import container as jcontainer
from smoqyelphqmc_tpu_torch.io import checkpoint as pcheckpoint
from smoqyelphqmc_tpu_torch.io import correlation_ratio as pratio
from smoqyelphqmc_tpu_torch.io import measurements_io as pmio
from smoqyelphqmc_tpu_torch.io import simulation_info as psi
from smoqyelphqmc_tpu_torch.measure import container as pcontainer

torch.set_num_threads(2)


def _spec(module, geo):
    spec = module.MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0), (1, 1), (0, 1)], time_displaced=True)
    spec.add_correlation("density", [(0, 0), (1, 1)], integrated=True)
    spec.add_correlation("bond", [(2, 2)], integrated=True)
    spec.add_composite_correlation("cdw", "density", ids=[0, 1], coefficients=[1.0, -1.0],
                                   displacement_vecs=[[0.0, 0.0], [1.0, 0.0]], integrated=True)
    spec.add_composite_correlation("tr_greens", "greens", id_pairs=[(0, 0), (1, 1)], coefficients=[1.0, 1.0],
                                   time_displaced=True)
    return spec


def _bin(rng, Ltau, L):
    """A bin tree as finalize_bin returns it: (re, im) NumPy pairs, f32
    globals beside f64 ones, a NaN global."""
    def pair(shape, dt=np.float64):
        return tuple(rng.standard_normal(shape).astype(dt) for _ in range(2))

    corr = (Ltau + 1,) + L
    return {
        "global": {"density": pair((), np.float32), "sgn": (np.float64(1.0), np.float64(0.0)),
                   "action_total": (np.float64(np.nan), np.float64(0.0)), "Nsqrd": pair((), np.float32)},
        "local": {"onsite_energy": pair((2,)), "X2": pair((2,))},
        "correlations": {"greens": pair((3,) + corr), "density": pair((2,) + corr), "bond": pair((1,) + corr)},
        "composite": {"cdw": pair((4,) + corr), "tr_greens": pair((2,) + corr)},
    }


def _h5_contents(path):
    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
        out[name] = (obj[()] if isinstance(obj, h5py.Dataset) else None, attrs)

    with h5py.File(path, "r") as f:
        out["/"] = (None, {k: np.asarray(v) for k, v in f.attrs.items()})
        f.visititems(visit)
    return out


def _assert_same_h5(a, b):
    ca, cb = _h5_contents(a), _h5_contents(b)
    assert list(ca) == list(cb), (a, b)
    for name in ca:
        (da, aa), (db, ab) = ca[name], cb[name]
        assert list(aa) == list(ab), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name} attr {k}")
        if da is not None:
            assert np.asarray(da).dtype == np.asarray(db).dtype, name
            np.testing.assert_array_equal(da, db, err_msg=name)


def _files(folder):
    return sorted(os.path.relpath(p, folder) for p in glob.glob(os.path.join(folder, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def test_output_set_matches_jax_io(tmp_path):
    """The same bins through both packages' write / merge / process and the
    same models and metadata through their TOML writers: every file equal."""
    jg, jtbm, _, jem, _ = honeycomb_model(L=2, beta=0.4)
    pg, ptbm, _, pem, _ = port_honeycomb_model(L=2, beta=0.4)
    jspec, pspec = _spec(jcontainer, jg), _spec(pcontainer, pg)
    metadata = {"N_therm": 2, "hmc_acceptance_rate": 0.75, "all_converged": True, "name": "x",
                "t_refresh_s": 0.125}
    infos = {}
    for tag, si, mio, spec, tbm, em in (("jax", jsi, jmio, jspec, jtbm, jem), ("port", psi, pmio, pspec, ptbm, pem)):
        info = si.SimulationInfo(filepath=str(tmp_path / tag), datafolder_prefix="run", sID=1)
        si.initialize_datafolder(info)
        si.model_summary(info, 0.4, 0.1, spec.geometry, tbm, (em,))
        rng = np.random.default_rng(7)
        for k in range(4):
            mio.write_measurement_bin(info, k, _bin(rng, 4, (2, 2)), spec, dtau=0.1)
        mio.merge_bins(info)
        si.save_simulation_info(info, metadata)
        si.save_density_tuning_profile(info, [(0.1, 1.0, 2.0), (0.2, 0.9, 1.9)])
        mio.process_measurements(info.datafolder, n_bins=2, spec=spec)
        infos[tag] = info
    jdir, pdir = infos["jax"].datafolder, infos["port"].datafolder
    files = _files(jdir)
    assert files == _files(pdir)
    assert {"model_summary.toml", "simulation_info_pID-0.toml", "binned_data.h5", "stats.h5",
            "bins/bin-0_pID-0.h5", "global_stats.csv", "composite_cdw_integrated_momentum.csv",
            "correlations_greens_time_displaced.csv"} <= set(files)
    for name in files:
        a, b = os.path.join(jdir, name), os.path.join(pdir, name)
        if name.endswith(".h5"):
            _assert_same_h5(a, b)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
    q, nbrs = (0, 0), [(1, 0), (0, 1)]
    assert (pratio.compute_composite_correlation_ratio(pdir, "cdw", q, nbrs, spec=pspec)
            == jratio.compute_composite_correlation_ratio(jdir, "cdw", q, nbrs, spec=jspec))
    assert (pratio.compute_correlation_ratio(pdir, "density", q, nbrs, pairs=[0])
            == jratio.compute_correlation_ratio(jdir, "density", q, nbrs, pairs=[0]))
    target = psi.rename_complete_simulation(infos["port"])
    assert os.path.isdir(target) and target.endswith("-complete")


def test_checkpoint_round_trip_and_gates(tmp_path):
    """Tensors (the generator's state among them) come back as NumPy, other
    leaves as they were; the frequency gate keeps the old timestamp; the file
    names and the gates are the JAX package's."""
    gen = torch.Generator().manual_seed(3)
    tree = {"x": torch.randn((3, 4), generator=gen, dtype=torch.float64), "generator": gen.get_state(),
            "meas_done": 5, "metadata": {"a": 1.5}, "acc_sums": None,
            "sums": {"g": (torch.ones(2, dtype=torch.float32), torch.zeros(2, dtype=torch.float32))},
            "precond": [1, "opaque"]}
    expect = torch.rand(4, generator=gen)  # the draws after the saved state
    folder = str(tmp_path)
    stamp = pcheckpoint.write_checkpoint(folder, tree, pID=2, checkpoint_freq_hours=1.0)
    assert pcheckpoint.checkpoint_path(folder, 2, int(stamp) % 2) == jcheckpoint.checkpoint_path(folder, 2,
                                                                                                int(stamp) % 2)
    assert pcheckpoint.write_checkpoint(folder, tree, pID=2, checkpoint_timestamp=stamp,
                                        checkpoint_freq_hours=1.0) == stamp
    assert not pcheckpoint.checkpoint_due(stamp, 1.0) and pcheckpoint.checkpoint_due(None, 1.0)
    assert pcheckpoint.runtime_exceeded(stamp, 0.0) and not pcheckpoint.runtime_exceeded(stamp, np.inf)
    for reader in (pcheckpoint.read_checkpoint, jcheckpoint.read_checkpoint):
        cp = reader(folder, pID=2)
        s = cp["state"]
        assert cp["pID"] == 2 and cp["timestamp"] == stamp
        assert isinstance(s["x"], np.ndarray) and s["x"].dtype == np.float64
        np.testing.assert_array_equal(s["x"], tree["x"].numpy())
        restored = torch.Generator()
        restored.set_state(torch.as_tensor(s["generator"]))
        assert torch.equal(torch.rand(4, generator=restored), expect)
        assert s["sums"]["g"][0].dtype == np.float32 and isinstance(s["sums"]["g"], tuple)
        assert s["meas_done"] == 5 and s["metadata"] == {"a": 1.5} and s["acc_sums"] is None
        assert s["precond"] == [1, "opaque"]
    assert pcheckpoint.read_checkpoint(folder, pID=0) is None
    pcheckpoint.delete_checkpoints(folder, 2)
    assert pcheckpoint.read_checkpoint(folder, pID=2) is None
