"""Carry the JAX package's parameters and chain state into the port.

Each function takes the JAX package's object (or any object with its field
names) and reads every array with `np.asarray`, so this module needs neither
jax nor the JAX package. Float arrays become float64 tensors on `device`;
index tables stay host NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .ops.fourier import TauFourier
from .ops.spectral_precond import SpectralPreconditioner


def _t(a, device, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)


def tight_binding_parameters(tbp, device="cpu") -> TightBindingParameters:
    if getattr(tbp, "t0_im", None) is not None:
        raise NotImplementedError("complex hoppings are not ported yet (ROADMAP Queue 1, item 14)")
    return TightBindingParameters(
        t0=_t(tbp.t0, device),
        eps=_t(tbp.eps, device),
        mu=_t(tbp.mu, device),
        neighbor_table=np.asarray(tbp.neighbor_table, dtype=np.int32),
        bond_ids=tuple(tbp.bond_ids),
        bond_slices=tuple(tuple(s) for s in tbp.bond_slices),
        n_sites=int(tbp.n_sites),
        n_orbitals=int(tbp.n_orbitals),
    )


def electron_phonon_parameters(elph, device="cpu", x=None) -> ElectronPhononParameters:
    """Holstein-model parameters; `x` (default elph.x) becomes the field."""
    if elph.n_ssh or elph.n_dispersion:
        raise NotImplementedError("SSH and dispersion couplings are not ported yet (ROADMAP Queue 1, item 15)")
    return ElectronPhononParameters(
        x=phonon_field(elph.x if x is None else x, device),
        Omega=_t(elph.Omega, device),
        Omega4=_t(elph.Omega4, device),
        mass=_t(elph.mass, device),
        hol_alpha=_t(elph.hol_alpha, device),
        hol_alpha2=_t(elph.hol_alpha2, device),
        hol_alpha3=_t(elph.hol_alpha3, device),
        hol_alpha4=_t(elph.hol_alpha4, device),
        beta=float(elph.beta),
        dtau=float(elph.dtau),
        Ltau=int(elph.Ltau),
        n_cells=int(elph.n_cells),
        nphonon=int(elph.nphonon),
        hol_to_phonon=np.asarray(elph.hol_to_phonon, dtype=np.int32),
        hol_to_site=np.asarray(elph.hol_to_site, dtype=np.int32),
        hol_ph_sym=np.asarray(elph.hol_ph_sym, dtype=bool),
        frozen_mask=np.asarray(elph.frozen_mask, dtype=bool),
    )


def phonon_field(x, device="cpu") -> torch.Tensor:
    """The phonon field (n_phonon, Ltau) as float64."""
    return _t(x, device)


def spectral_preconditioner(Q, filt, Ltau: int, dtype: str = "float32", device="cpu") -> SpectralPreconditioner:
    """A spectral preconditioner from given Q (N, N) and filt (Ltau, N)."""
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    Q = _t(Q, device, dt)
    return SpectralPreconditioner(
        Q=Q, filt=_t(filt, device, dt), fft=TauFourier(Ltau, dtype=dt, device=device),
        Ltau=int(Ltau), n_sites=Q.shape[0], dtype=dtype,
    )
