"""The port's spans and kernel counters.

Tracing is on exactly while a torch profiler runs
(`torch.autograd._profiler_enabled()`); there is no other switch.

`span(name, **ids)` times a stretch of host code. It always measures its
duration on the host clock (`time.perf_counter`, `.seconds` once closed),
which callers sum into `simulate`'s metadata. While tracing is on it also
keeps itself in the process's span list (`spans()`): its name, its start and
end in `time.time_ns()` nanoseconds (Unix-epoch time, the base of the
profiler's kineto events on Linux, so a span can be laid over a trace), the
index of the enclosing recorded span in that list (-1 at the top), its
identifiers and its seconds. A span inherits its parent's identifiers: the
`sweep` spans give the phase ('therm' or 'measure') and the index of the
sweep in that phase. Only the `radial` spans are one walker's (their
`walker` id, the index in this process's block of walkers); every other
span covers every walker of its sweep or kick. Whether a span is recorded
is decided when it opens. Spans are host ranges only: unlike
`torch.profiler.record_function`, they leave no copy on the device's
timeline.

The spans of a sweep of `driver.simulate` and `driver.run_sweeps`, as a
tree:

- `sweep`: one batch of the sweep loop, from the fallback controller's
  choice to the end of its accumulation and tuning (one sweep at
  `sweeps_per_dispatch` 1), closed before the bin's yield and the
  checkpoint decision;
  - `update`: the update sweep of every walker (`driver.sweep` with the
    sync after it in `measured_sweep`; `parallel.walkers.walker_sweep`
    with the shared preconditioner refresh);
    - `radial`: one walker's radial move (`updates.global_updates.
      radial_update`, with `use_radial_updates`), id `walker`;
    - `force`: one trajectory force evaluation (a kick) of every walker the
      trajectory runs (`updates.hmc.hmc_update`: the kick's fermion
      matrix, any per-kick preconditioner refresh, the solve and the
      force), ids `route` ('k3', 'k4' or 'plain', as `FORCE_ROUTES` counts
      it) and `walkers` (how many it covers: W on a shared sweep, 1
      walker by walker);
  - `refresh`: the Green's-estimator refresh of every walker, synchronised;
  - `measure`: the measurement pass of every walker, synchronised.

The `radial` and `force` spans are not synchronised: they time the host's
side of the work, which waits on the device only where it reads a value
from it (the radial move's Metropolis decision does; a kick's solve leaves
its flags on the device).

`KernelCounter` counts a kernel's launches and its plain version's calls.
While tracing is on, the whole-solve kernels K2 and K3 also keep one record
of each launch or plain call (`Launch`: its systems, sizes and the solve's
iteration counts as the tensor the launch returned, read only by whoever
reads the records after the run). `clear()` empties the span list and every
counter's records. `FORCE_ROUTES` counts the trajectory force evaluations by
route, a plain integer a kick.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import torch


def enabled() -> bool:
    """Tracing is on: a torch profiler is running."""
    return torch.autograd._profiler_enabled()


class span:
    """A timed stretch of host code (see the module docstring); use as a
    context manager. Fields: name, ids, start_ns, end_ns, parent, seconds."""

    __slots__ = ("name", "ids", "start_ns", "end_ns", "parent", "seconds", "_t0", "_index")

    def __init__(self, name: str, **ids):
        self.name = name
        self.ids = ids
        self.start_ns = self.end_ns = None
        self.parent = -1
        self.seconds = 0.0
        self._index: Optional[int] = None

    def __enter__(self) -> "span":
        if enabled():
            self.parent = _OPEN[-1] if _OPEN else -1
            if self.parent >= 0:
                self.ids = {**_SPANS[self.parent].ids, **self.ids}
            self._index = len(_SPANS)
            _SPANS.append(self)
            _OPEN.append(self._index)
            self.start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._index is not None:
            self.end_ns = time.time_ns()
            _OPEN.pop()

    def __repr__(self) -> str:
        return f"span({self.name!r}, {self.ids}, parent={self.parent}, seconds={self.seconds!r})"


_SPANS: List[span] = []  # the recorded spans, in the order they opened
_OPEN: List[int] = []  # indices of the recorded spans still open, innermost last


def spans() -> List[span]:
    """The spans recorded while tracing was on, in the order they opened (a
    span still open has no end_ns yet)."""
    return list(_SPANS)


class Launch(NamedTuple):
    """One launch (or plain call) of a whole-solve kernel: `n_systems`
    (Ltau, N) right-hand sides and `iters`, the solve's iteration counts as
    the launch returned them: one count for K2, one a walker (its two
    channel systems) for K3."""

    kernel: str
    n_systems: int
    Ltau: int
    N: int
    iters: torch.Tensor


class KernelCounter:
    """Launches of one kernel and calls of its plain version (plain ints),
    and, for the kernels that keep them, the records of the launches and
    calls made while tracing was on (`records`)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.records: List[Launch] = []
        _COUNTERS.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.records.clear()

    def record(self, n_systems: int, Ltau: int, N: int, iters: torch.Tensor) -> None:
        """Keep a launch's record while tracing is on; `iters` is kept as
        the tensor it is (no copy, no host read)."""
        if enabled():
            self.records.append(Launch(self.name, n_systems, Ltau, N, iters))


_COUNTERS: List[KernelCounter] = []

# The trajectory force evaluations by route (`updates.hmc.force_route`), one
# a walker a kick, whether tracing is on or off: 'k3' (kernel K3, solve and
# planes), 'k4' (the K2 solve, then kernel K4's planes), 'plain' (the solve,
# then the eager derivative chain). `driver.simulate` reports its own run's
# as `force_routes`.
FORCE_ROUTES: Dict[str, int] = {"k3": 0, "k4": 0, "plain": 0}


def force_routes_since(start: Dict[str, int]) -> Dict[str, int]:
    """The evaluations by route since `start`, a copy of FORCE_ROUTES."""
    return {k: n - start[k] for k, n in FORCE_ROUTES.items()}


def clear() -> None:
    """Empty the span list and every kernel counter's records (between
    runs: not while a recorded span is open)."""
    if _OPEN:
        raise RuntimeError(f"tracing.clear() inside the open span {_SPANS[_OPEN[-1]]!r}")
    _SPANS.clear()
    for c in _COUNTERS:
        c.records.clear()
