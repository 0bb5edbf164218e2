"""The output set of the port's holstein_honeycomb twin against the JAX
package's examples/holstein_honeycomb.py at tests/test_examples.py's tiny
sizes: the same files, the same HDF5 groups and datasets (names, shapes,
dtypes) in binned_data.h5 and stats.h5, the same CSV headers, the same
model_summary.toml key for key and value for value, and every metadata key
of the JAX run. Values differ: the packages draw their noise from different
generators. (A file of its own: the JAX run compiles for ~40 s.)"""

import os
import tomllib

import h5py
import torch

from _torch_examples import jax_script, tiny, twin

torch.set_num_threads(2)


def _files(folder) -> set:
    return {os.path.relpath(os.path.join(d, f), folder) for d, _, fs in os.walk(folder) for f in fs}


def _layout(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, (v.shape, v.dtype.str) if isinstance(v, h5py.Dataset)
                                                  else "group"))
    return out


def _header(path) -> str:
    with open(path) as f:
        return f.readline()


def test_holstein_honeycomb_output_set_matches_jax(tmp_path):
    name = "holstein_honeycomb"
    jmd = jax_script(name).run(**tiny(name, tmp_path / "jax"))
    pmd = twin(name).run(**tiny(name, tmp_path / "port"), device="cpu")
    (jdir,), (pdir,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert pdir == jdir
    jdir, pdir = tmp_path / "jax" / jdir, tmp_path / "port" / pdir
    files = _files(jdir)
    assert _files(pdir) == files
    for f in ("binned_data.h5", "stats.h5"):
        assert _layout(pdir / f) == _layout(jdir / f), f
    csvs = sorted(f for f in files if f.endswith(".csv"))
    assert csvs and [_header(pdir / f) for f in csvs] == [_header(jdir / f) for f in csvs]
    with open(pdir / "model_summary.toml", "rb") as fp, open(jdir / "model_summary.toml", "rb") as fj:
        assert tomllib.load(fp) == tomllib.load(fj)
    assert set(jmd) <= set(pmd), set(jmd) - set(pmd)
