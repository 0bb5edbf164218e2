"""Delta H of one HMC trajectory of the optical-SSH honeycomb at the SSH
example's timestep (examples/ossh_honeycomb.py: Nt=24, dtau=0.05, alpha=0.5,
mixed precision, 'auto' preconditioner), in the port and in the JAX package
from the same expanded parameters (numpy seed 1) and the same draws: at the
example's default size (L=3, beta=4), where Delta H is small, and at L=8,
beta=12, where it is already above 1 in both packages, so that the
acceptance near 0 of the full size (L=12, beta=12) is the model's at this
timestep and not the port's.

Tolerances: with f64 forces solved to 1e-11 the two packages' Delta H agree
to 1e-6 relative (measured 7e-8 at L=8: the tol-1e-10 action solves of an
action of ~1e5). With the example's f32 forces (tol 1e-5, the two packages'
preconditioner arithmetic differing) the trajectories part slightly and
Delta H is held to 5e-3 absolute (measured 6e-5 at L=3, 1.1e-3 at L=8).
Run with -s to print the values.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_hmc import _hmc_draws

import smoqyelphqmc_tpu as J
from smoqyelphqmc_tpu.updates import context as jctx_mod
from smoqyelphqmc_tpu.updates import hmc as jhmc
from smoqyelphqmc_tpu_torch import convert
from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc
from smoqyelphqmc_tpu_torch.updates.hmc import HMCParams, hmc_update

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import _common as jexamples  # noqa: E402

torch.set_num_threads(2)

NT, DTAU = 24, 0.05


@pytest.mark.parametrize("L, beta, force_dtype", [(3, 4.0, "float32"), (8, 12.0, "float32"), (8, 12.0, "float64")])
def test_ssh_example_delta_h_matches_jax(L, beta, force_dtype):
    """One leapfrog trajectory at Nt=24 from the same state and draws: both
    solves converge, the accept decisions are equal, Delta H agrees (to
    1e-6 relative with f64 forces, 5e-3 absolute with f32 ones), and it is
    below 0.2 at the example's size and above 1 at L=8, beta=12."""
    geo, tbm, em = jexamples.ossh_honeycomb_model(L, 1.0, 0.5, 0.0)
    rng = np.random.default_rng(1)
    jtbp = J.TightBindingParameters.from_model(tbm, rng)
    jelph = J.ElectronPhononParameters.from_model(beta, DTAU, em, jtbp, rng)
    opts = dict(mixed_precision=True, force_dtype=force_dtype, preconditioner="auto")
    if force_dtype == "float64":
        opts["tol_force"] = 1e-11
    jctx, jstate = jctx_mod.initialize_qmc(jtbp, jelph, seed=1, **opts)
    pctx, pstate = initialize_qmc(convert.tight_binding_parameters(jtbp, device="cpu"),
                                  convert.electron_phonon_parameters(jelph, device="cpu"), **opts)
    hd, _ = _hmc_draws(jstate.key, jctx.elph.n_phonon, jctx.Ltau, jctx.n_sites)
    _, jst = jax.jit(lambda s: jhmc.hmc_update(jctx, s, jhmc.HMCParams(Nt=NT)))(jstate)
    _, pst = hmc_update(pctx, pstate, HMCParams(Nt=NT), hd)
    jdH = float(jst.delta_H)
    print(f"ossh honeycomb L={L} beta={beta} Nt={NT} {force_dtype} forces: Delta H port {pst.delta_H:.9f} "
          f"JAX {jdH:.9f}, difference {pst.delta_H - jdH:.3e}")
    assert bool(jst.converged) and pst.converged
    assert pst.accepted == bool(jst.accepted)
    if force_dtype == "float64":
        assert abs(pst.delta_H - jdH) <= 1e-6 * abs(jdH)
    else:
        assert abs(pst.delta_H - jdH) <= 5e-3
    if L == 3:
        assert abs(jdH) < 0.2 and abs(pst.delta_H) < 0.2
    else:
        assert jdH > 1 and pst.delta_H > 1
