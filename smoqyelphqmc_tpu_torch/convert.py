"""Carry the JAX package's parameters and chain state into the port.

Each function takes the JAX package's object (or any object with its field
names) and reads every array with `np.asarray`, so this module needs neither
jax nor the JAX package. Float arrays become float64 tensors on `device`;
index tables stay host NumPy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .measure.greens_estimator import GreensEstimator
from .models.electron_phonon import ElectronPhononParameters
from .models.fermion_path_integral import FermionPathIntegral
from .models.tight_binding import TightBindingParameters
from .ops.checkerboard import CheckerboardOp, CheckerboardStructure
from .ops.fermion_det import FermionDetMatrix
from .ops.fourier import TauFourier
from .ops import kpm
from .ops.kpm import AveragedPropagator, KPMPreconditioner
from .ops.spectral_precond import SpectralPreconditioner
from .parallel.walkers import PrecondFallbackController, WalkerStates


def _t(a, device, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)


def _t_opt(a, device, dtype=torch.float64):
    return None if a is None else _t(a, device, dtype)


def tight_binding_parameters(tbp, device="cuda") -> TightBindingParameters:
    """Tight-binding parameters, complex hoppings (t0_im) included."""
    return TightBindingParameters(
        t0=_t(tbp.t0, device),
        eps=_t(tbp.eps, device),
        mu=_t(tbp.mu, device),
        neighbor_table=np.asarray(tbp.neighbor_table, dtype=np.int32),
        bond_ids=tuple(tbp.bond_ids),
        bond_slices=tuple(tuple(s) for s in tbp.bond_slices),
        n_sites=int(tbp.n_sites),
        n_orbitals=int(tbp.n_orbitals),
        t0_im=_t_opt(getattr(tbp, "t0_im", None), device),
    )


def path_integral(fpi, device="cuda") -> FermionPathIntegral:
    """A fermion path integral: V, t (tau-dependent with SSH couplings,
    static_hops False) and, for complex hoppings, t_im."""
    return FermionPathIntegral(V=_t(fpi.V, device), t=_t(fpi.t, device), dtau=float(fpi.dtau), Ltau=int(fpi.Ltau),
                               n_sites=int(fpi.n_sites), static_hops=bool(fpi.static_hops),
                               t_im=_t_opt(fpi.t_im, device))


def checkerboard_op(cb, device="cuda", dtype=torch.float64) -> CheckerboardOp:
    """Checkerboard planes C, S, S_im (None for real hoppings) and the partners."""
    return CheckerboardOp(C=_t(cb.C, device, dtype), S=_t(cb.S, device, dtype),
                          partner=torch.as_tensor(np.asarray(cb.partner), dtype=torch.long, device=device),
                          S_im=_t_opt(cb.S_im, device, dtype))


def fermion_det_matrix(fdm, device="cuda") -> FermionDetMatrix:
    """A fermion matrix with its propagator factors (sinh_hop_im and cb.S_im
    for complex hoppings) and its checkerboard structure."""
    st = fdm.structure
    structure = CheckerboardStructure(**{f.name: np.asarray(getattr(st, f.name))
                                         for f in dataclasses.fields(CheckerboardStructure)
                                         if f.name != "color_slices"},
                                      color_slices=tuple(tuple(int(i) for i in c) for c in st.color_slices))
    return FermionDetMatrix(exp_nV=_t(fdm.exp_nV, device), cb=checkerboard_op(fdm.cb, device),
                            cosh_hop=_t(fdm.cosh_hop, device), sinh_hop=_t(fdm.sinh_hop, device),
                            symmetric=bool(fdm.symmetric), structure=structure, Ltau=int(fdm.Ltau),
                            n_sites=int(fdm.n_sites), static_hops=bool(fdm.static_hops),
                            sinh_hop_im=_t_opt(fdm.sinh_hop_im, device))


def electron_phonon_parameters(elph, device="cuda", x=None) -> ElectronPhononParameters:
    """Electron-phonon parameters: Holstein, SSH (complex constants' `*_im`
    parts included) and dispersion couplings; `x` (default elph.x) becomes
    the field."""
    def idx(a, shape=(0,)):
        a = np.asarray(a, dtype=np.int32)
        return a if a.size else np.zeros(shape, dtype=np.int32)

    return ElectronPhononParameters(
        x=phonon_field(elph.x if x is None else x, device),
        Omega=_t(elph.Omega, device),
        Omega4=_t(elph.Omega4, device),
        mass=_t(elph.mass, device),
        hol_alpha=_t(elph.hol_alpha, device),
        hol_alpha2=_t(elph.hol_alpha2, device),
        hol_alpha3=_t(elph.hol_alpha3, device),
        hol_alpha4=_t(elph.hol_alpha4, device),
        ssh_alpha=_t(elph.ssh_alpha, device),
        ssh_alpha2=_t(elph.ssh_alpha2, device),
        ssh_alpha3=_t(elph.ssh_alpha3, device),
        ssh_alpha4=_t(elph.ssh_alpha4, device),
        ssh_alpha_im=_t_opt(elph.ssh_alpha_im, device),
        ssh_alpha2_im=_t_opt(elph.ssh_alpha2_im, device),
        ssh_alpha3_im=_t_opt(elph.ssh_alpha3_im, device),
        ssh_alpha4_im=_t_opt(elph.ssh_alpha4_im, device),
        disp_Omega=_t(elph.disp_Omega, device),
        disp_Omega4=_t(elph.disp_Omega4, device),
        beta=float(elph.beta),
        dtau=float(elph.dtau),
        Ltau=int(elph.Ltau),
        n_cells=int(elph.n_cells),
        nphonon=int(elph.nphonon),
        hol_to_phonon=idx(elph.hol_to_phonon),
        hol_to_site=idx(elph.hol_to_site),
        hol_ph_sym=np.asarray(elph.hol_ph_sym, dtype=bool),
        ssh_to_phonon=idx(elph.ssh_to_phonon, (2, 0)),
        ssh_to_hop=idx(elph.ssh_to_hop),
        disp_to_phonon=idx(elph.disp_to_phonon, (2, 0)),
        frozen_mask=np.asarray(elph.frozen_mask, dtype=bool),
    )


def phonon_field(x, device="cuda") -> torch.Tensor:
    """The phonon field (n_phonon, Ltau) as float64."""
    return _t(x, device)


def spectral_preconditioner(Q, filt, Ltau: int, dtype: str = "float32", device="cuda",
                            complex_pair: bool = False) -> SpectralPreconditioner:
    """A spectral preconditioner from given Q (N, N) and filt (Ltau, N); with
    complex_pair, the doubled-basis Q (2N, 2N) and filt (Ltau, 2N) of complex
    hoppings."""
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    Q = _t(Q, device, dt)
    return SpectralPreconditioner(
        Q=Q, filt=_t(filt, device, dt), fft=TauFourier(Ltau, dtype=dt, device=device),
        Ltau=int(Ltau), n_sites=Q.shape[0] // (2 if complex_pair else 1), dtype=dtype, complex_pair=complex_pair,
    )


def kpm_preconditioner(pre, device="cuda") -> KPMPreconditioner:
    """The port's KPMPreconditioner carrying a JAX KPMPreconditioner's state:
    Bbar's tables, the buffered bounds, the activation flag, the coefficient
    planes (one bucket), order_clip_count, the dense matrices of a dense
    preconditioner (2N x 2N for complex hoppings) and the static plan; the
    live orders follow from the bounds."""
    consts = {"rbuf": kpm.RBUF, "n_lanczos": kpm.N_LANCZOS, "a2": kpm.A2,
              "a1": 2.0 * kpm.A1 if pre.symmetric else kpm.A1, "dtype": "float32"}
    differ = {k: getattr(pre, k) for k, v in consts.items() if getattr(pre, k) != v}
    if differ:
        raise ValueError(f"the port's KPM preconditioner keeps the JAX defaults {consts}; this state has {differ}")
    dt = kpm.APPLY_DTYPE
    bbar = AveragedPropagator(cb=checkerboard_op(pre.bbar.cb, device), expV=_t(pre.bbar.expV, device),
                              symmetric=bool(pre.symmetric))
    lo, hi = float(pre.lo), float(pre.hi)
    caps = np.asarray(pre.caps)
    phi = np.asarray(pre.phi)
    orders, _ = kpm.live_orders(lo, hi, phi, pre.a1, pre.a2, caps)
    return KPMPreconditioner(
        bbar=bbar, lo=lo, hi=hi, active=bool(pre.active),
        coefs_re=_t(pre.coefs_re[0], device, dt), coefs_im=_t(pre.coefs_im[0], device, dt),
        orders=orders, order_clip_count=int(pre.order_clip_count),
        fft=TauFourier(int(pre.Ltau), dtype=dt, device=device),
        BpT=None if pre.matrix_free else _t(pre.BpT, device, dt),
        TsT=None if pre.matrix_free else _t(pre.TsT, device, dt),
        symmetric=bool(pre.symmetric), Ltau=int(pre.Ltau), n_sites=int(pre.n_sites), phi=phi, caps=caps,
        block_size=int(pre.block_size), n_blocks=int(pre.n_blocks), matrix_free=bool(pre.matrix_free),
    )


def walker_states(x, precond=None, device="cuda") -> WalkerStates:
    """A walker batch from the JAX package's walker state: x (W, n_phonon,
    Ltau) and one preconditioner shared by every walker (for a JAX state,
    `spectral_preconditioner(state.precond.Q[0], state.precond.filt[0], Ltau)`
    after a shared refresh, or None)."""
    xw = phonon_field(x, device)
    return WalkerStates(x=xw, precond=[precond] * xw.shape[0])


def fallback_controller(state: dict, ratio: float = 1.5, retry_every: int = 32,
                        enabled: bool = True) -> PrecondFallbackController:
    """A PrecondFallbackController restored from the JAX package's state_dict()."""
    c = PrecondFallbackController(ratio=ratio, retry_every=retry_every, enabled=enabled)
    c.load_state(state)
    return c


def greens_estimator(est, device="cuda") -> GreensEstimator:
    """A Green's-function estimator carrying R and GR (Nrv, 2, Ltau, N) in
    the estimator's dtype, so that both packages measure the same fields."""
    dt = {"float32": torch.float32, "float64": torch.float64}[str(est.dtype)]
    return GreensEstimator(R=_t(est.R, device, dt), GR=_t(est.GR, device, dt), Nrv=int(est.Nrv),
                           Ltau=int(est.Ltau), n_orb=int(est.n_orb), L=tuple(int(v) for v in est.L),
                           dtype=str(est.dtype))
