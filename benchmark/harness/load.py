"""The closed loop: ``clients`` requests always in flight through
``Scheduler.submit_stream``; each client sends its next request as soon as
its previous one has finished.

One load thread plays every client, so the harness adds one thread, not
sixteen, to the interpreter the serving thread runs in.  After each
submit it puts its own progress listener in the stream queue's place
(under the scheduler's lock, before the serving thread can emit: an
admission and a segment lie between), and chains
``engine.finish_listener``: both run in the serving thread, stamp the
time and post to the load thread's inbox.  A
record holds the submit time, each chunk's arrival (the port streams one
chunk per segment) and the request's ``Outputs``.  When the window closes
no client sends again, and the requests still in flight are abandoned:
every progress listener is swapped for one that raises ``WindowClosed``
(a ``BaseException``, which the engine's listener guard does not catch),
so the serving batch ends at its next segment, its slots and pages
released by ``run``'s own failure path, and the serving thread ends with
it.  The window counts nothing of what follows its close.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from .traffic import Request

clock = time.perf_counter


class WindowClosed(BaseException):
    """Raised in the serving thread to end the batch after the window."""


def _raise_closed(_chunk):
    raise WindowClosed()


@dataclass
class Record:
    """One request as its client saw it."""
    request: Request
    t_submit: float = 0.0
    rid: int = -1
    chunks: List[tuple] = field(default_factory=list)   # (time, n tokens)
    served: List[int] = field(default_factory=list)
    output: Optional[List[int]] = None    # Outputs' generated tokens
    finished: bool = False
    error: Optional[str] = None

    @property
    def t_first(self) -> Optional[float]:
        return self.chunks[0][0] if self.chunks else None

    @property
    def t_last(self) -> Optional[float]:
        return self.chunks[-1][0] if self.chunks else None


class ClosedLoop:
    def __init__(self, scheduler, requests: Iterator[Request], clients: int,
                 gen_config):
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.requests = requests
        self.clients = clients
        self.gen_config = gen_config      # Request -> GenerationConfig
        self.records: List[Record] = []
        self._by_rid: Dict[int, Record] = {}
        self._inbox: "queue.Queue[tuple]" = queue.Queue()
        self._closed = False
        self.t0 = self.t_end = 0.0

    # -- the serving thread's side --------------------------------------
    def _listener(self, rec: Record):
        inbox = self._inbox

        def on_chunk(chunk):
            inbox.put(("tokens", rec, chunk, clock()))
        return on_chunk

    def _chain_finish(self) -> None:
        scheduler_wake = self.engine.finish_listener
        inbox = self._inbox

        def on_finish(rid=None):
            inbox.put(("done", rid, None, clock()))
            scheduler_wake(rid)
        self.engine.finish_listener = on_finish

    # -- the load thread -----------------------------------------------
    def _submit(self) -> None:
        rec = Record(next(self.requests))
        self.records.append(rec)
        req = rec.request
        rec.t_submit = clock()
        try:
            rec.rid, _ = self.scheduler.submit_stream(
                req.ids, self.gen_config(req))
        except ValueError as e:
            rec.error = repr(e)
            self._inbox.put(("next", None, None, clock()))
            return
        with self.scheduler._lock:
            self.engine.progress_listeners[rec.rid] = self._listener(rec)
        self._by_rid[rec.rid] = rec

    def _finish(self, rec: Record) -> None:
        out = self.scheduler.try_result(rec.rid)
        if isinstance(out, Exception) or out is None:
            rec.error = repr(out)
        else:
            rec.output = list(out.output_ids[len(rec.request.ids):])
            rec.finished = True

    def _load(self) -> None:
        for _ in range(self.clients):
            self._submit()
        while True:
            kind, key, chunk, t = self._inbox.get()
            if kind == "stop":
                return
            if kind == "tokens":
                key.chunks.append((t, len(chunk)))
                key.served.extend(chunk)
                continue
            if kind == "done":
                rec = self._by_rid.get(key)
                if rec is None or rec.finished or rec.error is not None \
                        or (self._closed and t > self.t_end):
                    continue        # unknown, or abandoned at the close
                self._finish(rec)
            if not self._closed:
                self._submit()

    def run(self, seconds: float, tracer=None) -> None:
        """Serve for ``seconds``, then abandon what is in flight.  With a
        ``spans.Tracer`` the main thread serves its asks meanwhile."""
        self._chain_finish()
        loader = threading.Thread(target=self._load, daemon=True)
        self.t0 = clock()
        loader.start()
        if tracer is not None:
            tracer.serve_until(self.t0 + seconds)
        time.sleep(max(0.0, self.t0 + seconds - clock()))
        self.t_end = clock()
        self._closed = True
        if tracer is not None:
            tracer.close()
        self._end_batch()
        self._inbox.put(("stop", None, None, clock()))
        loader.join(timeout=60)
        if loader.is_alive():
            raise RuntimeError("the load thread did not end")

    def _end_batch(self) -> None:
        sched, engine = self.scheduler, self.engine
        prev_hook = threading.excepthook

        def hook(args):
            if not issubclass(args.exc_type, WindowClosed):
                prev_hook(args)

        threading.excepthook = hook
        try:
            with sched._lock:
                for rid in list(engine.progress_listeners):
                    engine.progress_listeners[rid] = _raise_closed
            sched.close()           # joins the serving thread (30 s at most)
            sched._driver.join(timeout=300)
            if sched._driver.is_alive():
                raise RuntimeError("the scheduler's thread did not end")
        finally:
            threading.excepthook = prev_hook
        engine.queue.clear()
