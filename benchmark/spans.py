"""The program's spans in a traced run (`smoqyelphqmc_tpu_torch.tracing`),
laid on the trace's clock and clipped to the profiled sweeps' windows.

The program records spans only while a profiler runs, so its list holds
the profiled sweeps' spans. Their times are Unix-epoch nanoseconds, the
base of kineto's events on Linux: ns / 1e3 is the trace's microseconds. A
program without the tracing module, or one that recorded no span inside
the windows, reads as None.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

from benchmark.trace import clip, union_us

PARTS = ("update", "refresh", "measure")  # the children of a `sweep` span


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the list, -1 at the top
    parts: List[Tuple[float, float]]  # the span clipped to the windows (us)


def read(run) -> Optional[List[Span]]:
    """The program's spans of the traced run, clipped to the windows."""
    t = run.trace
    if t is None or not t.windows:
        return None
    try:
        from smoqyelphqmc_tpu_torch import tracing
    except ImportError:
        return None
    out = [Span(s.name, s.parent, clip([(s.start_ns / 1e3, s.end_ns / 1e3)], t.windows))
           for s in tracing.spans() if s.end_ns is not None]
    return out if any(s.parts for s in out) else None


def intervals(spans: Sequence[Span], names: Sequence[str]) -> List[Tuple[float, float]]:
    return [iv for s in spans if s.name in names for iv in s.parts]


def ms_per_sweep(run, names: Sequence[str]) -> Optional[float]:
    """Summed time of the named spans inside the windows, per profiled sweep."""
    spans = read(run)
    if spans is None or not run.trace.n_sweeps:
        return None
    us = sum(e - s for s, e in intervals(spans, names))
    return us / 1e3 / run.trace.n_sweeps if us > 0 else None


def idle_share(run, names: Sequence[str]) -> Optional[float]:
    """Per cent of the union of the named spans (inside the windows) in which
    no kernel, copy or set ran on the device."""
    spans = read(run)
    if spans is None or not run.trace.device:
        return None
    cover = intervals(spans, names)
    span_us = union_us(cover)
    if span_us <= 0:
        return None
    return 100.0 * (1.0 - union_us(clip(run.trace.device, cover)) / span_us)


def self_ms_per_sweep(run, name: str = "sweep", parts: Sequence[str] = PARTS) -> Optional[float]:
    """Self time of the `name` spans per profiled sweep: each span's time
    inside the windows less the part its children named in `parts` cover."""
    spans = read(run)
    if spans is None or not run.trace.n_sweeps:
        return None
    total, found = 0.0, False
    for i, s in enumerate(spans):
        if s.name != name or not s.parts:
            continue
        found = True
        children = [iv for c in spans if c.parent == i and c.name in parts for iv in c.parts]
        total += union_us(s.parts) - union_us(clip(children, s.parts))
    return total / 1e3 / run.trace.n_sweeps if found else None
