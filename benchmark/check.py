"""The comparison that decides `correct`.

After the window the program runs one more measured sweep, resumed from the
checkpoint it wrote when the window stopped it (the sweep an uninterrupted
run makes next: the program resumes bit for bit). The plain reference
replays that sweep from the same state, the fields and the walkers'
generator states of the checkpoint, with the same draws, and two numbers
are compared:

- `field_gap`: max over walkers of max|x_program - x_reference| / max|x_reference|
  after the sweep. The reference's field is its own trajectory's end when
  it accepts, the field after its reflection, swap and (with radial
  updates) radial moves when it rejects. Where its Delta H lies within `dH_band` of the acceptance
  threshold (-log u), rounding legitimately decides, and the program's own
  choice (whether it moved the field) stands. This covers M^T M (with SSH
  couplings, its per-slice hoppings), the solves, the action, the forces and
  Delta H of the trajectory, and the global moves' Metropolis decisions.
- `measure_gap`: max over walkers of the larger of max|G_program - G_reference|
  / max|G_reference| over the time-displaced Green's function pairs and
  |n_program - n_reference| / |n_reference| of the density, the reference
  solving M^{-1} R for the program's field and the replayed random phases.
  This covers the estimator refresh's solve and the measurement pass's
  contractions.
"""

from __future__ import annotations

import importlib
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import Reference, draw, measurements


def reference_model(config: dict):
    """The reference's model and its Green's-function pairs, by the
    configuration's `model` name (`references/<model>.py`)."""
    mod = importlib.import_module(f"benchmark.references.{config['model']}")
    return mod.build(config), mod.GREENS_PAIRS


def decided(sw, moved: torch.Tensor, band: float) -> torch.Tensor:
    """(W,) whether the reference takes the trajectory's end: its own
    Metropolis decision, or, within `band` of the threshold, `moved`."""
    margin = sw.dH + sw.log_u
    return torch.where(margin.abs() <= band, moved, margin < 0)


def field_gaps(sw, x: torch.Tensor, band: float) -> torch.Tensor:
    """(W,) field gap of the fields x after the sweep against the replay sw."""
    moved = torch.tensor([not torch.equal(a, b) for a, b in zip(x, sw.x_moved)], device=x.device)
    x_ref = torch.where(decided(sw, moved, band)[:, None, None], sw.x_prop, sw.x_moved)
    return (x - x_ref).abs().amax(dim=(1, 2)) / x_ref.abs().amax(dim=(1, 2))


def measure_gaps(G: torch.Tensor, n: torch.Tensor, ref: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(W,) measurement gap of Green's functions G (W, pairs, Ltau+1, *L) and
    densities n (W,) against the reference's."""
    W = G.shape[0]
    Gr = ref["greens"].reshape(W, -1)
    g = (G.reshape(W, -1) - Gr).abs().amax(dim=1) / Gr.abs().amax(dim=1)
    d = (n - ref["density"].real).abs() / ref["density"].real.abs()
    return torch.maximum(g, d)


def program_measurements(trees: Sequence[dict], device):
    """The Green's functions and densities of the program's bins (one a walker)."""
    G = np.stack([tr["correlations"]["greens"][0] + 1j * tr["correlations"]["greens"][1] for tr in trees])
    n = np.array([float(np.asarray(tr["global"]["density"][0])) for tr in trees])
    return torch.as_tensor(G, device=device), torch.as_tensor(n, device=device)


class Judge:
    """The plain reference's replay of the checked sweep, from the fields x0
    (W, n_phonon, Ltau) and the walkers' `gen_states` before it, at full
    precision, and the one judgement of a candidate's fields and
    measurements after it: the program's, or in `control` the reference's
    at a lower precision. Computes the `numbers` among field_gap and
    measure_gap."""

    def __init__(self, config: dict, settings, device, x0, gen_states, band: float,
                 numbers=("field_gap", "measure_gap")):
        self.model, self.pairs = reference_model(config)
        self.settings, self.device, self.x0, self.band, self.numbers = settings, device, x0, band, numbers
        self.exact = Reference(self.model, settings, device, "exact")
        self.draws = [draw(g, self.model, settings) for g in gen_states]
        self.thetas = torch.stack([d.theta for d in self.draws])
        self.sw = self.exact.sweep(x0, self.draws) if "field_gap" in numbers else None

    @property
    def dH(self):
        """The exact reference's Delta H a walker, where it replays the sweep."""
        return None if self.sw is None else self.sw.dH.tolist()

    def __call__(self, x1, G, n) -> Dict[str, float]:
        """The numbers of fields x1 (W, n_phonon, Ltau), Green's functions G
        and densities n after the sweep."""
        out = {}
        if "field_gap" in self.numbers:
            out["field_gap"] = float(field_gaps(self.sw, x1, self.band).max())
        if "measure_gap" in self.numbers:
            R, GR = self.exact.green(x1, self.thetas)
            out["measure_gap"] = float(measure_gaps(G, n, measurements(self.model, R, GR, self.pairs)).max())
        return out


def control(judge: Judge, precisions=("control", "config")) -> dict:
    """The numbers of the reference at each of `precisions` put in the
    program's place, from the judge's state and draws, judged as the program
    is: "control" (one step below the configuration's precisions) must fail,
    "config" (the configuration's own precisions) shows the spread a sound
    program may have; each with its Delta H, the readings `dH_band` is set
    from beside the exact reference's."""
    out = {}
    for p in precisions:
        low = Reference(judge.model, judge.settings, judge.device, p)
        x1, dH = judge.x0, None  # without the sweep, both measure at its starting fields
        if judge.sw is not None:
            swl = low.sweep(judge.x0, judge.draws)
            x1 = torch.where((swl.dH + swl.log_u < 0)[:, None, None], swl.x_prop, swl.x_moved)
            dH = swl.dH.tolist()
        R, GR = low.green(x1, judge.thetas)
        lowm = measurements(judge.model, R, GR, judge.pairs)
        out[p] = dict(judge(x1, lowm["greens"], lowm["density"].real), dH=dH)
    return out
