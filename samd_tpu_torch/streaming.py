"""Per-request progress streaming for the batched serving engines
(counterpart of ``samd_tpu/streaming.py``; the port keeps its own copy).

A listener registered under a request id receives each newly COMMITTED
chunk of generated token ids (prompt excluded, budget/EOS-clamped exactly
like the final ``Outputs``) as soon as the segment that produced it
returns to the host.  Chunk granularity is the fused engines' segment (up
to ``steps_per_call`` steps, replayed from a CUDA graph on the card and
read once, ``device_loop``; one step on their per-step route), and one
step for the host-history engines (``batching.BatchedSamdEngine``).
Joined, a request's chunks equal its ``Outputs``' generated tokens.
Listeners run on the thread that runs the engine and must be
cheap and non-blocking; an exception from one is logged with its
traceback and dropped, so a dead client does not kill the batch.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

log = logging.getLogger(__name__)


class ProgressStreamMixin:
    """Opt-in per-request token streaming for batched engines.

    ``engine.progress_listeners[rid] = fn`` registers a callback; the engine
    calls ``fn(chunk_ids)`` with each new list of generated tokens.  Two
    bookkeeping styles serve the two engine families:

      * the fused engines (device-resident histories) call
        ``_emit_stream_progress`` once per segment: it reads the history
        matrix from the device only when a streaming listener is active and
        emits the UNSEEN span of each streamed slot;
      * the host-history engines (``batching.BatchedSamdEngine``) call
        ``_emit_stream_chunk`` with each step's accepted chunk (no extra
        device traffic).

    ``_stream_done(rid)`` drops the per-request bookkeeping when it
    finishes (the listener itself is owned, and removed, by whoever
    registered it), and calls ``finish_listener(rid)`` when one is set:
    the serving scheduler wakes the request's waiter with it instead of
    polling for the result.
    """

    finish_listener: Optional[Callable[[int], None]] = None

    @property
    def progress_listeners(self) -> dict:
        d = getattr(self, "_progress_listeners", None)
        if d is None:
            d = {}
            self._progress_listeners = d
            self._stream_pos = {}       # rid -> absolute history index
            self._stream_count = {}     # rid -> generated tokens emitted
        return d

    def _emit_stream_progress(self, actives, hist_lens) -> None:
        """Per-segment hook: emit each streamed slot's newly committed span.

        Clamping matches the finish path bit for bit: tokens beyond
        ``prompt + max_new`` never stream (the device can overshoot by up
        to one block), and nothing streams after an EOS."""
        listeners = getattr(self, "_progress_listeners", None)
        if not listeners:
            return
        todo = [i for i in range(self.B)
                if actives[i] and self._slot_req[i] in listeners]
        if not todo:
            return
        hist_np = self.histories.cpu().numpy()
        for i in todo:
            rid = self._slot_req[i]
            plen = self._slot_prompt[i]
            limit = plen + self._slot_max_new[i]
            start = self._stream_pos.setdefault(rid, plen)
            end = min(int(hist_lens[i]), limit)
            if end <= start:
                continue
            chunk = hist_np[i, start:end].tolist()
            if self.eos_token_id in chunk:
                chunk = chunk[:chunk.index(self.eos_token_id) + 1]
                end = limit  # suppress anything the device wrote after EOS
            self._stream_pos[rid] = end
            try:
                listeners[rid](chunk)
            except Exception:       # a dead client must not stop the batch
                log.exception("progress listener of request %s raised", rid)

    def _emit_stream_chunk(self, rid, chunk, max_new: int) -> None:
        """Per-step hook of the host-history engines: emit the accepted
        chunk, clamped to the request's budget."""
        listeners = getattr(self, "_progress_listeners", None)
        if not listeners or rid not in listeners:
            return
        emitted = self._stream_count.setdefault(rid, 0)
        chunk = list(chunk)[:max(0, max_new - emitted)]
        if not chunk:
            return
        self._stream_count[rid] = emitted + len(chunk)
        try:
            listeners[rid](chunk)
        except Exception:       # a dead client must not stop the batch
            log.exception("progress listener of request %s raised", rid)

    def _stream_done(self, rid) -> None:
        if getattr(self, "_progress_listeners", None):
            self._stream_pos.pop(rid, None)
            self._stream_count.pop(rid, None)
        if self.finish_listener is not None:
            self.finish_listener(rid)
