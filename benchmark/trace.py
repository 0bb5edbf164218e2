"""Reading a profiler trace of the window's profiled sweeps.

The benchmark wraps each step of the simulation generator in a range named
`bench.sweep`; the profiled window is the union of those ranges. The trace
is read from the profiler's kineto events in memory: device kernels
("kernel"), copies and sets, the host's operator events ("cpu_op", with
their input shapes) and the runtime's launch calls ("cuda_runtime"), linked
to their kernels by correlation id. The union and clipping of intervals are
copies of `profile_sweeps`' (`_union_us`, `_clip`) in the port.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

RANGE = "bench.sweep"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def clip(intervals, windows):
    return [(max(s, ws), min(e, we)) for s, e in intervals for ws, we in windows if s < we and e > ws]


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # us
    dur: float  # us
    dims: Optional[list] = None  # shape of the launch's output buffer, where the host allocated one just before
    dtype: Optional[str] = None


@dataclasses.dataclass
class Trace:
    """The profiled sweeps' device activity (us, the trace's clock)."""

    windows: List[Tuple[float, float]]
    kernels: List[Kernel]
    device: List[Tuple[float, float]]  # every kernel, copy and set
    host_ops: List[Tuple[float, float, str]]  # the host thread's operators
    n_sweeps: int
    read_s: float = 0.0  # seconds the reading took

    @property
    def window_us(self) -> float:
        return union_us(self.windows)

    @property
    def busy_us(self) -> float:
        return union_us(clip(self.device, self.windows))

    def family_us(self, key: str) -> float:
        """Device time of the kernels whose name holds `key`, inside the window."""
        return sum(e - s for k in self.kernels if key in k.name
                   for s, e in clip([(k.start, k.start + k.dur)], self.windows))

    def top_ops(self, n: int = 10) -> List[list]:
        per: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            for s, e in clip([(k.start, k.start + k.dur)], self.windows):
                per[k.name] += e - s
        return [[name[:120], us / 1e6] for name, us in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between device activity inside the window,
        each named by the innermost host operator running at its middle."""
        gaps = []
        for ws, we in self.windows:
            busy = sorted(clip(self.device, [(ws, we)]))
            t = ws
            for s, e in busy + [(we, we)]:
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host_ops]
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            name = "host: no operator"
            # the latest-starting operator that still runs at mid is the innermost
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                hs, he, hn = self.host_ops[i]
                if he >= mid:
                    name = hn
                    break
                if mid - hs > 5e6:
                    break
            out.append([name[:120], (e - s) / 1e6])
        return out


def category(ev, name: str) -> str:
    """The event's activity type ("kernel", "gpu_memcpy", "gpu_memset",
    "gpu_user_annotation", "cuda_runtime", "user_annotation", "cpu_op"),
    from its device and its name."""
    if ev.device_type() != DeviceType.CPU:
        if name == RANGE:  # the range's copy on the device's timeline
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    if name == RANGE:
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def read(prof, n_sweeps: int) -> Trace:
    """The trace of a stopped `torch.profiler.profile`, from its kineto
    events (no export to disk)."""
    windows, kernels, device, ops, launches = [], [], [], [], {}
    allocs: Dict[int, List[Tuple[float, list, str]]] = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        cat = category(ev, name)
        ts = ev.start_ns() / 1e3
        dur = ev.duration_ns() / 1e3
        if cat == "user_annotation" and name == RANGE:
            windows.append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((Kernel(name, ts, dur), ev.correlation_id()))
        elif cat == "cuda_runtime":
            launches[ev.correlation_id()] = (ts, ev.start_thread_id())
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, name))
            if name == "aten::empty_like":
                shapes, types = ev.shapes() or [[]], ev.dtypes() or [""]
                allocs[ev.start_thread_id()].append((ts, list(shapes[0]), types[0]))
    for lst in allocs.values():
        lst.sort(key=lambda a: a[0])
    keys = {tid: [a[0] for a in lst] for tid, lst in allocs.items()}
    out = []
    for k, corr in kernels:
        launch = launches.get(corr)
        if launch is not None and launch[1] in allocs:
            i = bisect.bisect_left(keys[launch[1]], launch[0]) - 1
            if i >= 0:
                _, k.dims, k.dtype = allocs[launch[1]][i]
        out.append(k)
    ops.sort()
    return Trace(windows=windows, kernels=out, device=device, host_ops=ops, n_sweeps=n_sweeps)
