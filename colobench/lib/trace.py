"""The traced stretch: ``torch.profiler`` over a short steady run, reduced
to device records, busy time (a union of intervals), ranges and the
breakdown the result line carries."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from colobench.lib import kernels
from colobench.lib.stats import gaps, union_length

#: the harness's own span around the whole stretch
STRETCH = "colobench.stretch"


@dataclasses.dataclass
class Trace:
    #: device records: (name, start s, end s) in the profiler's clock
    records: List[Tuple[str, float, float]]
    #: the stretch's span in the profiler's clock
    window: Tuple[float, float]
    #: device seconds under each named CPU range, summed over its
    #: occurrences
    ranges: Dict[str, float]
    #: CPU spans: (name, start s, end s), for the idle gaps' attribution
    host: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return union_length((max(s, lo), min(e, hi))
                            for _, s, e in self.records)

    def spans(self, name: str) -> List[Tuple[float, float]]:
        """The host spans named ``name`` inside the stretch."""
        lo, hi = self.window
        return [(s, e) for n, s, e in self.host
                if n == name and s >= lo and e <= hi]

    def busy_within(self, spans: List[Tuple[float, float]]) -> float:
        """Seconds of ``spans`` in which an operation ran on the device
        (a union of the records clipped to each span)."""
        total = 0.0
        for lo, hi in spans:
            total += union_length((max(s, lo), min(e, hi))
                                  for _, s, e in self.records
                                  if e > lo and s < hi)
        return total

    def seconds_by_family(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.records:
            f = kernels.family(name)
            out[f] = out.get(f, 0.0) + (e - s)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by the host span that was innermost at each gap's
        middle."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.records:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        idle = sorted(gaps([(s, e) for _, s, e in self.records], lo, hi),
                      key=lambda g: g[0] - g[1])[:200]
        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        names = [n for n, _, _ in self.host]
        by_host: Dict[str, float] = {}
        for s, e in idle:
            mid = 0.5 * (s + e)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(inside):
                name = names[inside[np.argmax(starts[inside])]]
            else:
                name = "(no host span)"
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        idle_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle_top]}


def span(name: str):
    """A named host range that the trace records (nothing untraced)."""
    return torch.profiler.record_function(name)


def traced(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler, inside the stretch's span, with a
    synchronize before and after, and reduce the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with span(STRETCH):
            fn()
            sync()
    return reduce(prof)


def reduce(prof) -> Trace:
    records: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    ranges: Dict[str, float] = {}
    window: Optional[Tuple[float, float]] = None
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        s, e = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == cuda:
            # a record_function range also shows on the device as an
            # annotation spanning its kernels: not an operation
            if not getattr(evt, "is_user_annotation", False):
                records.append((evt.name, s, e))
            continue
        if evt.name == STRETCH:
            window = (s, e)
            continue
        host.append((evt.name, s, e))
        if getattr(evt, "is_user_annotation", False) or \
                evt.name.startswith("colobench."):
            ranges[evt.name] = ranges.get(evt.name, 0.0) + \
                evt.device_time_total / 1e6
    if window is None:
        raise RuntimeError("the profile lost the stretch's own span")
    return Trace(records, window, ranges, host)


#: the harness's span around each prefill call
CALL = "colobench.call"


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader is given: the trace, the
    configuration's dict and its family's adapter
    (``colobench/families/``), the traced calls as (batch, length), and
    the cell's kind (``prefill``)."""
    trace: Trace
    config: Dict
    family: Any
    calls: List[Tuple[int, int]]
    kind: str
