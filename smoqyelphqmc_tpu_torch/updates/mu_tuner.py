"""Chemical-potential tuning toward a target density (port of the JAX
package's updates/mu_tuner.py).

After each measurement of the density n and of <N^2> the chemical potential
moves toward the target filling with a running compressibility estimate,

    mu_{t+1} = mu_bar_t + (n_target - n_bar_t) * V / kappa_t,
    kappa_t  = max( beta (<N^2> - <N>^2)_bar,  kappa_min sqrt(V / t) ),

over forgetful (exponentially decaying) running means. Every leaf is
float64: a Python float for one chain, a (W,) float64 CPU tensor for W
walkers (one tuner each, updated together). The operations come in the JAX
package's order, so the same (n, N^2) sequence gives the same mu, and a
checkpoint round trip (floats pickle exactly, tensors through NumPy
float64) changes no bit."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import torch

Leaf = Union[float, torch.Tensor]

_LEAVES = ("mu", "t", "mu_sum", "n_sum", "N_sum", "Nsq_sum", "weight")


@dataclasses.dataclass
class MuTunerState:
    mu: Leaf  # current chemical potential
    t: Leaf  # update counter
    mu_sum: Leaf
    n_sum: Leaf
    N_sum: Leaf
    Nsq_sum: Leaf
    weight: Leaf  # running total weight of the forgetful window
    target_density: float
    beta: float
    n_sites: int
    memory: float  # forgetting factor in (0, 1]; 1 = plain mean
    kappa_min: float

    def leaves(self) -> dict:
        """The running state (what a checkpoint holds)."""
        return {k: getattr(self, k) for k in _LEAVES}

    def with_leaves(self, leaves: dict) -> "MuTunerState":
        """This tuner with its running state replaced (a checkpoint's), each
        leaf a float or a float64 CPU tensor as this tuner's."""
        conv = (lambda v: torch.as_tensor(v, dtype=torch.float64).clone()) if isinstance(self.mu, torch.Tensor) \
            else float
        return dataclasses.replace(self, **{k: conv(leaves[k]) for k in _LEAVES})


def init_mu_tuner(target_density: float, beta: float, n_sites: int, initial_mu: float, memory: float = 0.99,
                  kappa_min: float = 0.1, n_walkers: int = 0) -> MuTunerState:
    """One tuner (n_walkers = 0: float leaves) or n_walkers tuners in (W,)
    float64 tensors, all starting from initial_mu."""
    if n_walkers:
        leaf = lambda v: torch.full((n_walkers,), float(v), dtype=torch.float64)  # noqa: E731
    else:
        leaf = float
    return MuTunerState(mu=leaf(initial_mu), t=leaf(0.0), mu_sum=leaf(0.0), n_sum=leaf(0.0), N_sum=leaf(0.0),
                        Nsq_sum=leaf(0.0), weight=leaf(0.0), target_density=float(target_density),
                        beta=float(beta), n_sites=int(n_sites), memory=float(memory), kappa_min=float(kappa_min))


def _f64(v, like: Leaf) -> Leaf:
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(v, dtype=torch.float64).reshape(like.shape).clone()
    return float(v)


def _maximum(a: Leaf, b: Leaf) -> Leaf:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64))
    return max(a, b)


def _sqrt(v: Leaf) -> Leaf:
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def mu_tuner_update(tuner: MuTunerState, n, Nsqrd, sgn=1.0) -> MuTunerState:
    """Record one (n, <N^2>) measurement (a float each, or (W,) values for W
    tuners; any float dtype, read as float64) and return the state with the
    new mu (MuTuner.update!, the JAX package's mu_tuner_update)."""
    V = tuner.n_sites
    lam = tuner.memory
    n = _f64(n, tuner.mu)
    Nsqrd = _f64(Nsqrd, tuner.mu)
    w = lam * tuner.weight + 1.0
    mu_sum = lam * tuner.mu_sum + tuner.mu
    n_sum = lam * tuner.n_sum + n
    N_sum = lam * tuner.N_sum + n * V
    Nsq_sum = lam * tuner.Nsq_sum + Nsqrd
    mu_bar = mu_sum / w
    n_bar = n_sum / w
    N_bar = N_sum / w
    Nsq_bar = Nsq_sum / w
    t = tuner.t + 1.0
    var_N = _maximum(Nsq_bar - N_bar**2, 0.0)
    kappa_fluc = tuner.beta * var_N
    kappa = _maximum(kappa_fluc, tuner.kappa_min * _sqrt(V / t))
    mu_new = mu_bar + (tuner.target_density - n_bar) * V / kappa
    return dataclasses.replace(tuner, mu=mu_new, t=t, mu_sum=mu_sum, n_sum=n_sum, N_sum=N_sum, Nsq_sum=Nsq_sum,
                               weight=w)


class MuUpdateResult(NamedTuple):
    tuner: MuTunerState
    mu: Leaf


def update_chemical_potential(tuner: MuTunerState, n, Nsqrd, sgn=1.0) -> MuUpdateResult:
    """The functional update_chemical_potential!: the caller measures (n,
    <N^2>) with the Green's-function estimator, then sets the context's mu to
    the returned value (`updates.context.with_mu`; V is a function of mu, so
    nothing else needs a refresh)."""
    tuner = mu_tuner_update(tuner, n, Nsqrd, sgn)
    return MuUpdateResult(tuner=tuner, mu=tuner.mu)
