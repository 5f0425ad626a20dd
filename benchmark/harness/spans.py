"""Spans that the benchmark records around its host calls into the port,
in a ``--trace 1`` run only, and the device trace of a short sub-window.

``instrument(engine, tracer)`` wraps two methods of the engine instance:

    _segment       one segment of decode steps, ending in its one host read
                   of the control matrix: start, end, the steps run, each
                   slot's committed length before and after, its live steps
                   and its steps drafted from the corpus
    _prefill_slot  one request's prefill; the wrapper waits for the device
                   (the engine reads the first token right after it anyway)

The tracer starts ``torch.profiler`` (CUDA activity) at the first segment
boundary after ``start_at`` and stops it at the first segment end
``seconds`` later, so the traced sub-window holds whole segments and the
prefills between them; an idle gap of the device is named by the span
open around it on the host's clock.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

clock = time.perf_counter


@dataclass
class SegmentSpan:
    t0: float
    t1: float
    steps: int                 # decode steps the segment ran
    hist0: np.ndarray          # [B] committed lengths before
    hist1: np.ndarray          # [B] committed lengths after
    actives: np.ndarray        # [B] bool: slots holding a request
    live: np.ndarray           # [B] live steps of each slot
    corpus: np.ndarray         # [B] live steps drafted from the corpus
    traced: bool = False


@dataclass
class PrefillSpan:
    t0: float
    t1: float
    tokens: int                # the prompt's length
    traced: bool = False


class Tracer:
    """Starts and stops the profiler at segment boundaries.

    Kineto serves only the thread that registered it, so the main thread
    owns the profiler: at a segment boundary the serving thread asks for a
    start or a stop and waits while the main thread (``serve_until``) does
    it.  After the start the main thread times one fill kernel on an idle
    device, which ties the trace's clock to the host's."""

    def __init__(self, start_at: float, seconds: float):
        self.start_at = start_at
        self.seconds = seconds
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.t_mark: Optional[float] = None
        self._asks: "queue.Queue[str]" = queue.Queue()
        self._done = threading.Event()
        self._closed = False

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def _ask(self, what: str) -> None:
        if self._closed:
            return
        self._done.clear()
        self._asks.put(what)
        self._done.wait(timeout=60)

    def before_segment(self, now: float) -> None:
        if self.prof is None and now >= self.start_at:
            self._ask("start")

    def after_segment(self, now: float) -> None:
        if self.active and now - self.t_start >= self.seconds:
            self._ask("stop")

    def _do(self, what: str) -> None:
        import torch

        if what == "start" and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            cuda = torch.cuda.is_available()
            self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                            else ProfilerActivity.CPU])
            self.prof.start()
            self.t_start = clock()
            if cuda:
                torch.cuda.synchronize()
                self.t_mark = clock()
                torch.empty(1, device="cuda").fill_(1.0)
                torch.cuda.synchronize()
        elif what == "stop":
            self.stop()
        self._done.set()

    def serve_until(self, t_end: float) -> None:
        """The main thread: serve the serving thread's asks until ``t_end``."""
        while True:
            left = t_end - clock()
            if left <= 0:
                return
            try:
                what = self._asks.get(timeout=left)
            except queue.Empty:
                return
            self._do(what)

    def close(self) -> None:
        """No more asks; answer one that may be waiting."""
        self._closed = True
        try:
            while True:
                self._do(self._asks.get_nowait())
        except queue.Empty:
            pass
        self._done.set()

    def stop(self) -> None:
        if self.active:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t_stop = clock()
            self.prof.stop()


class Spans:
    def __init__(self):
        self.segments: List[SegmentSpan] = []
        self.prefills: List[PrefillSpan] = []


def instrument(engine, tracer: Optional[Tracer]) -> Spans:
    import torch

    spans = Spans()
    segment, prefill = engine._segment, engine._prefill_slot

    def _segment(hist_lens, starts, budgets, actives, *rest):
        if tracer is not None:
            tracer.before_segment(clock())
        traced = tracer is not None and tracer.active
        t0 = clock()
        ctrl, steps, replays = segment(hist_lens, starts, budgets, actives,
                                       *rest)
        t1 = clock()
        if steps:
            spans.segments.append(SegmentSpan(
                t0, t1, steps, np.array(hist_lens), ctrl[0].copy(),
                np.array(actives, bool), ctrl[4].copy(), ctrl[5].copy(),
                traced))
        if tracer is not None:
            tracer.after_segment(t1)
        return ctrl, steps, replays

    def _prefill_slot(slot, ids):
        traced = tracer is not None and tracer.active
        t0 = clock()
        out = prefill(slot, ids)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        spans.prefills.append(PrefillSpan(t0, clock(), len(ids), traced))
        return out

    engine._segment = _segment
    engine._prefill_slot = _prefill_slot
    return spans
