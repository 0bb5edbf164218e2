"""Shared helpers of the example-twin tests (tests/test_torch_examples*.py):
the tiny arguments of tests/test_examples.py for each script, and the JAX
scripts of examples/ beside their twins in smoqyelphqmc_tpu_torch.examples."""

import importlib
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples"))

from test_examples import TINY  # noqa: E402

from smoqyelphqmc_tpu_torch.examples import TWINS  # noqa: E402

# what tests/test_examples.py adds to TINY for each script (its L, and the
# script's own arguments)
OVER = {
    "holstein_honeycomb": dict(L=3),
    "holstein_honeycomb_checkpoint": dict(L=3, checkpoint_freq_hours=0.0, runtime_limit_hours=np.inf),
    "holstein_honeycomb_density_tuning": dict(L=3, n_target=1.0),
    "holstein_honeycomb_multiwalker": dict(L=2, n_walkers=2),
    "bssh_chain": dict(L=4),
    "bssh_square": dict(L=2),
    "ossh_chain": dict(L=4),
    "ossh_square": dict(L=2),
    "ossh_honeycomb": dict(L=2),
    "holstein_flux_chain": dict(L=4, flux=0.5, mu=0.0),
}


def tiny(name, filepath=None, **over):
    """tests/test_examples.py's keywords for script `name` (its TINY, its L,
    its own arguments), with `filepath`."""
    kw = dict(TINY)
    if name == "holstein_honeycomb_density_tuning":
        kw.pop("mu")
    kw.update(OVER[name], **over)
    if filepath is not None:
        kw["filepath"] = str(filepath)
    return kw


def jax_script(name):
    """The JAX package's script examples/<name>.py as a module."""
    return importlib.import_module(name)


def h5_datasets(path) -> dict:
    """{dataset path: values} of an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(v, h5py.Dataset) else None)
    return out


def twin(name):
    """The port's twin smoqyelphqmc_tpu_torch.examples.<name>."""
    return importlib.import_module(f"smoqyelphqmc_tpu_torch.examples.{name}")


assert sorted(OVER) == sorted(TWINS)
