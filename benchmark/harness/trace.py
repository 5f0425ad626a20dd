"""The reduction of a traced sub-window to the numbers the per-layer
metrics and the result's ``breakdown`` read."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals: List[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union's pieces, (start, end)."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


@dataclass
class TraceSummary:
    window_s: float                       # host wall of the sub-window
    busy_s: float                         # union of device intervals
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, substring: str) -> float:
        return sum(t for n, t in self.kernel_s.items() if substring in n)

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name, t] for name, t in top],
                "idle_gaps": [[label, t] for label, t in self.gaps[:n]]}


def summarize(tracer, spans) -> TraceSummary:
    """Device kernels (and copies) of the traced sub-window: their time by
    name, the union of their intervals, and the longest idle gaps, each
    named by the benchmark span open at its middle on the host's clock
    ("between spans" where none is).  The tracer's fill marker ties the
    two clocks and is left out."""
    from torch.autograd import DeviceType

    events = [e for e in tracer.prof.events()
              if e.device_type == DeviceType.CUDA]
    fills = [e for e in events if "FillFunctor" in e.name]
    marker = min(fills, key=lambda e: e.time_range.start) if fills else None
    device = []
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e is marker:
            continue
        tr = e.time_range
        device.append((tr.start, tr.end))
        by_name[e.name] += (tr.end - tr.start) * 1e-6

    def to_trace(h: float) -> float:            # host s -> trace us
        return marker.time_range.start + (h - tracer.t_mark) * 1e6

    host = []
    if marker is not None:
        host = sorted([(to_trace(s.t0), to_trace(s.t1), "segment")
                       for s in spans.segments if s.traced]
                      + [(to_trace(p.t0), to_trace(p.t1), "prefill")
                         for p in spans.prefills if p.traced])
    starts = [h[0] for h in host]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and host[i][0] <= t < host[i][1]:
            return f"during {host[i][2]}"
        return "between spans (admission, host reads)"

    gaps = sorted(idle_gaps(device), key=lambda g: g[0] - g[1])
    return TraceSummary(
        window_s=tracer.t_stop - tracer.t_start,
        busy_s=union_length(device) * 1e-6,
        kernel_s=dict(by_name),
        gaps=[(label((s + e) / 2), (e - s) * 1e-6) for s, e in gaps[:10]])
