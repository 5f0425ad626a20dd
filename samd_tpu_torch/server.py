"""Serving front end: a thread-safe scheduler and an HTTP API over the
port's batched engines (counterpart of ``samd_tpu/server.py``).

The batched engines (the fused ones and ``batching.BatchedSamdEngine``,
``--engine batched``) already do continuous batching: ``run()`` admits from
``engine.queue`` between segments and retires finished slots as it goes.
So serving needs (a) a thread-safe way to submit and (b) one driver thread
that owns the engine.  The driver thread does every piece of torch device
work; HTTP threads only append to ``engine.queue`` under the lock and read
results.

    Scheduler(engine)        submit() / result() from any thread
    serve(engine, port=8089) stdlib ThreadingHTTPServer:
        POST /generate  {"input_ids": [...], "max_new_tokens": 64,
                         "temperature": 0.0, ...}
                        -> {"request_id", "output_ids", "new_tokens",
                            "decode_steps", "wall_ms"}
        POST /generate  {"stream": true, ...} (or /generate?stream=1)
                        -> Server-Sent Events: one ``data: {"tokens":
                           [...]}`` event per committed chunk (segment
                           granularity, ``streaming.ProgressStreamMixin``),
                           then ``data: {"done": true, ...summary}``
        GET  /health    -> {"status": "ok", ...queue and slot counters}

Sampled requests in flight at once must share one sampling signature (the
engines raise on a batch of two); the HTTP layer answers a request whose
signature conflicts with those in flight with 400 instead of failing the
batch.  So it does a body the engine cannot serve — a token id outside the
vocabulary, a prompt past the largest prefill bucket (or the page pool), a
knob of the wrong type or range — before it reaches the driver thread.  A
batch that fails in the engine is reported to every waiting request (500
over HTTP, with the error), never dropped.

    python -m samd_tpu_torch.server --random-model --tiny --cpu

serves a tiny random model on the CPU; without ``--cpu`` the engine runs on
the CUDA card and raises if there is none.  ``--engine batched`` serves the
host-automaton engine, and ``--sam corpus.npz`` adds a static corpus SAM.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from .config import GenerationConfig

log = logging.getLogger(__name__)


class Scheduler:
    """Thread-safe request scheduler over one batched engine.

    One driver thread calls ``engine.run()`` whenever work is pending;
    ``run`` admits queued requests between segments, so a request submitted
    mid-run joins the batch without waiting for it to drain.  A waiter
    sleeps on a condition that the engine's ``finish_listener`` and the
    driver signal; it does not poll, so waiting threads take no
    interpreter time from the driver's host loop."""

    def __init__(self, engine):
        self.engine = engine
        self._done = threading.Condition()
        engine.finish_listener = self._wake
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._submitted = 0
        self._outstanding: set = set()
        self._results: dict = {}
        self._stream_queues: dict = {}   # rid -> queue.Queue of events
        self._active_sig: Optional[tuple] = None
        self._driver = threading.Thread(target=self._drive, daemon=True)
        self._driver.start()

    # -- client surface (any thread) -----------------------------------
    def _claim_signature(self, gen: GenerationConfig) -> None:
        """Under the lock: a sampled request takes the batch's signature,
        or raises ValueError when another one is in flight."""
        if gen.greedy:
            return
        sig = gen.sampling_signature
        if self._active_sig is not None and sig != self._active_sig:
            raise ValueError("concurrent sampling requests must share one "
                             "sampling signature")
        self._active_sig = sig

    def submit(self, input_ids: Sequence[int],
               gen: Optional[GenerationConfig] = None) -> int:
        """Enqueue a request; returns its id.  Raises ValueError if a
        sampled request's signature conflicts with those in flight."""
        gen = gen or GenerationConfig()
        with self._lock:
            prev = self._active_sig
            self._claim_signature(gen)
            try:
                # the engine rejects what it cannot serve (bad ids, a
                # prompt past its buckets) before the queue
                rid = self.engine.add_request(list(input_ids), gen)
            except ValueError:
                self._active_sig = prev
                raise
            self._submitted += 1
            self._outstanding.add(rid)
        self._work.set()
        return rid

    def submit_stream(self, input_ids: Sequence[int],
                      gen: Optional[GenerationConfig] = None):
        """Enqueue a request with progress streaming; returns ``(rid,
        events)``, ``events`` a ``queue.Queue`` of ``("tokens", [ids])`` per
        committed chunk and a last ``("done", Outputs)`` or ``("error",
        Exception)``."""
        if not hasattr(self.engine, "progress_listeners"):
            raise ValueError("engine does not support progress streaming")
        gen = gen or GenerationConfig()
        events: queue.Queue = queue.Queue()
        with self._lock:
            prev = self._active_sig
            self._claim_signature(gen)
            # the listener exists before the driver can admit the request;
            # every add_request goes through this lock, so the engine's
            # next id is the one it will assign
            rid = self.engine._next_id
            self.engine.progress_listeners[rid] = (
                lambda chunk: events.put(("tokens", chunk)))
            try:
                got = self.engine.add_request(list(input_ids), gen)
            except ValueError:
                self.engine.progress_listeners.pop(rid, None)
                self._active_sig = prev
                raise
            if got != rid:
                raise RuntimeError("request ids changed outside the "
                                   "scheduler's lock")
            self._stream_queues[rid] = events
            self._submitted += 1
            self._outstanding.add(rid)
        self._work.set()
        return rid, events

    def try_result(self, rid: int):
        """The request's Outputs (or the Exception of its failed batch), or
        None while it runs.  Finished slots show in ``engine.results``
        during a run, so an early finisher does not wait for the batch."""
        out = self._results.get(rid)
        if out is None:
            out = self.engine.results.get(rid)
        return out

    def result(self, rid: int, timeout: Optional[float] = None):
        """Block until request ``rid`` finishes; returns its Outputs (or
        the Exception its batch failed with)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done:
            while True:
                out = self.try_result(rid)
                if out is not None:
                    return out
                if self._stop:
                    raise RuntimeError("scheduler closed")
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(f"request {rid} not done in "
                                       f"{timeout}s")
                self._done.wait(left)

    def _wake(self, rid: Optional[int] = None) -> None:
        """Wake every waiter to look for its result (the engine calls it
        as each request finishes, the driver after each run)."""
        with self._done:
            self._done.notify_all()

    def generate(self, input_ids: Sequence[int],
                 gen: Optional[GenerationConfig] = None,
                 timeout: Optional[float] = None):
        return self.result(self.submit(input_ids, gen), timeout=timeout)

    def stats(self) -> dict:
        return {
            "submitted": self._submitted,
            "queued": len(self.engine.queue),
            "completed": len(self._results) + len(self.engine.results),
            "batch_size": getattr(self.engine, "B", 1),
            # the signature sampled requests in flight share, or None
            "sampling_signature": (None if self._active_sig is None
                                   else list(self._active_sig)),
        }

    def close(self):
        self._stop = True
        self._work.set()
        self._wake()
        self._driver.join(timeout=30)

    # -- driver thread (owns the engine and every device call) ----------
    def _drive(self):
        while not self._stop:
            self._work.wait()
            if self._stop:
                return
            self._work.clear()
            while self.engine.queue:
                try:
                    # drains the queue and the slots in flight; returns
                    # (and clears) the engine's results
                    self._results.update(self.engine.run())
                except Exception as e:
                    # the batch failed: every waiter, queued or in flight,
                    # gets the error instead of an answer
                    log.exception("serving batch failed")
                    self.engine.queue.clear()
                    self._results.update(self.engine.results)
                    self.engine.results.clear()
                    with self._lock:
                        for rid in self._outstanding:
                            self._results.setdefault(rid, e)
                self._wake()
                self._notify_streams()
            with self._lock:
                self._outstanding -= set(self._results)
                if not self.engine.queue and not self._outstanding:
                    self._active_sig = None

    def _notify_streams(self):
        """The last event of each finished streaming request, and its
        listener's removal (token chunks were pushed during the run)."""
        with self._lock:
            done = [rid for rid in self._stream_queues
                    if rid in self._results]
            for rid in done:
                events = self._stream_queues.pop(rid)
                self.engine.progress_listeners.pop(rid, None)
                out = self._results[rid]
                events.put(("error", out) if isinstance(out, Exception)
                           else ("done", out))


_INT_KEYS = ("max_new_tokens", "max_steps", "max_cache_len", "top_k",
             "seed")
_FLOAT_KEYS = ("temperature", "top_p", "posterior_threshold",
               "posterior_alpha")
_ACCEPT_MODES = ("rejection", "typical", "nucleus")


def _gen_from_json(d: dict) -> GenerationConfig:
    """A request body's GenerationConfig: temperature > 0 samples.  Raises
    ValueError for a knob of the wrong type or range, so that a malformed
    body gets 400 and never reaches the driver thread."""
    kw = {}
    for k in _INT_KEYS:
        if k in d:
            v = d[k]
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"{k} must be an integer")
            kw[k] = v
    for k in _FLOAT_KEYS:
        if k in d:
            v = d[k]
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not math.isfinite(v):
                raise ValueError(f"{k} must be a finite number")
            kw[k] = float(v)
    if "accept_mode" in d:
        if d["accept_mode"] not in _ACCEPT_MODES:
            raise ValueError(f"accept_mode must be one of {_ACCEPT_MODES}")
        kw["accept_mode"] = d["accept_mode"]
    if kw.get("max_new_tokens", 1) < 1:
        raise ValueError("max_new_tokens must be at least 1")
    if kw.get("top_k", 0) < 0 or not 0.0 <= kw.get("top_p", 0.0) <= 1.0:
        raise ValueError("top_k must be >= 0 and top_p within [0, 1]")
    if not 0 <= kw.get("seed", 0) < 2 ** 63:
        raise ValueError("seed must lie in [0, 2^63)")
    if kw.get("temperature", 0.0) > 0:
        kw["greedy"] = False
    return GenerationConfig(**kw)


def _summary(rid: int, out, t0: float) -> dict:
    return {"request_id": rid, "output_ids": list(out.output_ids),
            "new_tokens": out.decode_tokens,
            "decode_steps": out.decode_steps,
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}


class _Handler(BaseHTTPRequestHandler):
    scheduler: Scheduler = None  # set by serve()

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):
        if self.path in ("/health", "/stats"):
            self._reply(200, {"status": "ok", **self.scheduler.stats()})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            ids = req["input_ids"]
            if (not isinstance(ids, list) or not ids
                    or not all(isinstance(t, int) and not isinstance(t, bool)
                               for t in ids)):
                raise ValueError("input_ids must be a non-empty int list")
            gen = _gen_from_json(req)
            timeout = req.get("timeout_s", 600)
            if isinstance(timeout, bool) or not isinstance(
                    timeout, (int, float)) or not timeout > 0:
                raise ValueError("timeout_s must be a positive number")
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        t0 = time.perf_counter()
        if bool(req.get("stream")) or "stream=1" in query:
            self._stream_generate(ids, gen, timeout, t0)
            return
        try:
            rid = self.scheduler.submit(ids, gen)
        except ValueError as e:   # a signature conflict, or a request
            self._reply(400, {"error": str(e)})   # the engine cannot serve
            return
        try:
            out = self.scheduler.result(rid, timeout=timeout)
        except TimeoutError as e:
            self._reply(504, {"error": str(e), "request_id": rid})
            return
        if isinstance(out, Exception):
            self._reply(500, {"error": repr(out), "request_id": rid})
            return
        self._reply(200, _summary(rid, out, t0))

    def _stream_generate(self, ids, gen, timeout, t0):
        """Server-Sent Events: one ``data:`` JSON event per committed chunk,
        then a last ``{"done": true, ...}`` event (HTTP/1.0 framing: the
        connection closes at the end)."""
        try:
            rid, events = self.scheduler.submit_stream(ids, gen)
        except ValueError as e:
            self._reply(400, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def emit(obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    kind, payload = events.get(timeout=0.05)
                except queue.Empty:
                    # an early finisher shows in engine.results before the
                    # driver's last event; its chunks are all queued by
                    # then (the driver pushes them first)
                    out = self.scheduler.try_result(rid)
                    if out is None:
                        if time.monotonic() > deadline:
                            emit({"error": f"timeout for request {rid}"})
                            return
                        continue
                    while True:   # the remaining chunks, in order
                        try:
                            kind, payload = events.get_nowait()
                        except queue.Empty:
                            break
                        if kind == "tokens":
                            emit({"tokens": payload})
                    kind, payload = (("error", out)
                                     if isinstance(out, Exception)
                                     else ("done", out))
                if kind == "tokens":
                    emit({"tokens": payload})
                    continue
                if kind == "error":
                    emit({"error": repr(payload), "request_id": rid})
                    return
                emit({"done": True, **_summary(rid, payload, t0)})
                return
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away; the batch keeps running


def serve(engine, *, host: str = "127.0.0.1", port: int = 8089,
          block: bool = True):
    """Start the HTTP front end over ``engine``; returns (server,
    scheduler).  With ``block=False`` the server runs on a daemon thread,
    and the caller stops it with ``server.shutdown()`` and
    ``scheduler.close()``."""
    scheduler = Scheduler(engine)
    handler = type("Handler", (_Handler,), {"scheduler": scheduler})
    server = ThreadingHTTPServer((host, port), handler)
    if block:
        try:
            server.serve_forever()
        finally:
            scheduler.close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, scheduler


def build_server_engine(args):
    """A batched serving engine from the command line's arguments:
    ``--model DIR`` or ``--random-model`` (``--tiny``, ``--family``) with
    optional int8/fp8/int4 weights through ``models.loader.build_params``,
    the CLI's way to a model, on the card or with ``--cpu`` on the CPU.
    ``--engine batched`` serves ``batching.BatchedSamdEngine`` with the
    ``sam_only`` host drafters; ``fused_hybrid_batched`` and
    ``paged_fused_hybrid`` the SAM[Token Recycle] engines of
    ``fused_hybrid`` with the batch-tuned block (M 24, a 23-node tree,
    chains of 20, 16 steps per segment), and ``eagle2_hybrid_batched`` the
    SAM[EAGLE-2] engine with the same block (an EAGLE-2 tree of 23 nodes,
    depth 4, top-4; a random draft net from a generator seeded 7);
    ``--sam FILE`` loads a static
    corpus SAM (``sam.load_sam(FILE, topk=8)``), which the host drafters
    share through one ``sam.SamCursor`` per request and whose text is the
    fused engines' corpus."""
    from .fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                            PagedBatchedFusedSamEngine)
    from .models.loader import build_params

    static_sam = None
    if getattr(args, "sam", None):
        from .sam import load_sam

        static_sam = load_sam(args.sam, topk=8)
    device = "cpu" if getattr(args, "cpu", False) else "cuda"
    cfg, params, eos, _ = build_params(args, device)
    kw = dict(batch_size=args.batch_size, max_cache_len=args.max_cache_len,
              eos_token_id=eos, device=device)
    if args.engine == "batched":
        from .batching import BatchedSamdEngine
        from .config import SamdConfig
        from .drafters import make_drafter
        from .sam import SamCursor

        scfg = SamdConfig(draft_source="sam_only")

        def drafter():
            return make_drafter(
                scfg, cfg.vocab_size,
                static_sam=None if static_sam is None
                else SamCursor(static_sam))
        return BatchedSamdEngine(cfg, params, scfg, drafter, **kw)
    corpus = static_sam.text if static_sam is not None else None
    inline = getattr(args, "inline_prefill", False)
    if args.engine in ("fused_hybrid_batched", "paged_fused_hybrid"):
        from .fused_hybrid import (BatchedFusedHybridEngine,
                                   FusedHybridConfig,
                                   PagedBatchedFusedHybridEngine)

        # the reference's batch-tuned hybrid block (B = 12: M 24, tree 23)
        hy_cfg = FusedHybridConfig(steps_per_call=16, tree_nodes=23,
                                   n_predicts=20, max_block=24)
        ctor = (PagedBatchedFusedHybridEngine
                if args.engine == "paged_fused_hybrid"
                else BatchedFusedHybridEngine)
        return ctor(cfg, params, hy_cfg, corpus=corpus,
                    inline_prefill=inline, **kw)
    if args.engine == "eagle2_hybrid_batched":
        from .fused_hybrid import (BatchedFusedHybridEagleEngine,
                                   FusedHybridEagleConfig)

        hy_cfg = FusedHybridEagleConfig(
            steps_per_call=16, eagle_depth=4, eagle_topk=4, eagle_total=23,
            max_block=24, n_predicts=20)
        return BatchedFusedHybridEagleEngine(cfg, params, hy_cfg,
                                             corpus=corpus,
                                             inline_prefill=inline, **kw)
    # the batch-tuned block M = 16; steps_per_call sets admission latency
    fs_cfg = FusedSamConfig(steps_per_call=16, n_predicts=15)
    if args.engine == "paged_fused_sam":
        return PagedBatchedFusedSamEngine(cfg, params, fs_cfg, corpus=corpus,
                                          **kw)
    return BatchedFusedSamEngine(cfg, params, fs_cfg, corpus=corpus,
                                 inline_prefill=inline, **kw)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="samd_tpu_torch serving front "
                                "end")
    p.add_argument("--model", help="local HF model directory")
    p.add_argument("--random-model", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="with --random-model: a tiny config (smoke tests)")
    p.add_argument("--family", default="llama",
                   choices=("llama", "qwen2", "moe"),
                   help="with --random-model: the model family (a "
                        "checkpoint's follows its config.json)")
    p.add_argument("--engine", default="fused_sam_batched",
                   choices=["fused_sam_batched", "paged_fused_sam",
                            "fused_hybrid_batched", "paged_fused_hybrid",
                            "eagle2_hybrid_batched", "batched"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--quantize", choices=["int8", "fp8", "int4"])
    p.add_argument("--max-cache-len", type=int, default=1024)
    p.add_argument("--sam", help="static corpus SAM .npz (sam.save_sam's "
                   "format, either package's)")
    p.add_argument("--inline-prefill", action="store_true",
                   help="greedy prompts stream through the decode steps "
                        "as forced-accept chains (fused_sam_batched, "
                        "the SAM[Token Recycle] hybrid engines)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8089)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.random_model and not args.model:
        p.error("--model required (or --random-model)")
    engine = build_server_engine(args)
    print(f"serving {args.engine} on http://{args.host}:{args.port}",
          flush=True)
    serve(engine, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
