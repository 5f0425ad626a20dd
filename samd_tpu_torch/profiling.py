"""Step-level profiling for the decode loop (counterpart of
``samd_tpu/profiling.py``).

``PhaseTimer``, set as ``SamdEngine.profiler``, sums the wall time of each
step's phases (the host draft lookup, the device step, the host update);
the draft-source and accept-length counters are ``engine.StepStats``.
``torch_trace`` writes a ``torch.profiler`` trace of a block of work, the
counterpart of the reference's ``xla_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


class PhaseTimer:
    """Accumulates wall time per phase; attach as ``engine.profiler``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def lap(self, name: str, t0: float) -> float:
        """Record the time since ``t0`` under ``name``; returns now, the
        next phase's start."""
        now = time.perf_counter()
        self.record(name, now - t0)
        return now

    def report(self, normalize_by: Optional[str] = None) -> List[dict]:
        """Rows of {phase, total_s, calls, mean_ms, frac}, the largest
        first; ``frac`` is relative to the phase ``normalize_by``."""
        base = self.totals.get(normalize_by, None) if normalize_by else None
        rows = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            rows.append({
                "phase": name,
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * total / max(self.counts[name], 1), 3),
                "frac": round(total / base, 4) if base else None,
            })
        return rows

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def torch_trace(log_dir: str) -> Iterator[object]:
    """Profile the block's host and (where a card is present) device work
    with ``torch.profiler``; its Chrome trace goes to
    ``log_dir/trace.json``.  Yields the profiler, for ``key_averages()``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
