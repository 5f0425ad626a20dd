"""The device-resident decode loop (counterpart of the reference's
``lax.while_loop`` over ``steps_per_call`` steps:
``samd_tpu/fused_sam.py:315-376`` and ``:626-738``,
``samd_tpu/pld.py:134-188``, ``samd_tpu/token_recycle_fused.py:166-206``,
``samd_tpu/fused_hybrid.py:292``, ``:759``, ``:1226``, ``:1621`` and
``samd_tpu/eagle_fused.py:304``).

The reference runs up to ``steps_per_call`` steps inside one compiled
loop and reads one control vector when it ends.  Here the host runs a
*segment* of k steps and reads the control state once, at its end:

- ``StepGraphs`` holds one ``torch.cuda.CUDAGraph`` per shape key of an
  engine's step (one stream: the cache bucket W and the sampling signature,
  as the reference builds one program per ``(sig, Wn)``; the batched
  engines: one ``[B, M]`` step per sampling signature).  A step is a
  closure that reads and writes only static buffers (the KV cache, the
  history, the control scalars, and for a sampled step each request's seed
  and draw counter, from which ``ops.request_noise`` draws its noise on
  the device), so replaying its graph k times runs k steps with no host
  work between them, greedy or sampled.
  The first step of a key runs eagerly (a real step, the warm-up), then the
  key is captured, then replayed.  A capture that fails raises.
- ``segment_length`` picks k from what the host knows: the number of steps
  that the requests deciding the segment's end are certain to stay live
  for.  A step that is not live (after an EOS inside the segment) does
  nothing, as the engines' ``_step``s guarantee.

A graph records its kernels without running them, so the wrappers' launch
counters (``ops.int4_matmul.int4_matmul.launches``,
``ops.flash_attention.flash_block_attention.launches[_int8]``,
``ops.paged_attention.paged_block_attention.launches[_int8]``,
``ops.request_noise.request_uniforms.launches``) move at
capture and not at replay.  ``StepGraphs`` takes the capture's increments
back and adds each key's launches per step, times k, on every replay, so
the counters still count the kernels that ran.

On a CPU device ``StepGraphs.run`` calls the step k times, eagerly: the
same step function, as a kernel's plain version is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from .ops.flash_attention import flash_block_attention
from .ops.int4_matmul import int4_matmul
from .ops.paged_attention import paged_block_attention
from .ops.request_noise import request_uniforms

# (wrapper, counter attribute): every launch counter of the port's kernels
LAUNCH_COUNTERS = ((flash_block_attention, "launches"),
                   (flash_block_attention, "launches_int8"),
                   (int4_matmul, "launches"),
                   (paged_block_attention, "launches"),
                   (paged_block_attention, "launches_int8"),
                   (request_uniforms, "launches"))


def _read_counters() -> List[int]:
    return [getattr(fn, name) for fn, name in LAUNCH_COUNTERS]


def _add_counters(deltas: Sequence[int], times: int = 1) -> None:
    for (fn, name), d in zip(LAUNCH_COUNTERS, deltas):
        setattr(fn, name, getattr(fn, name) + d * times)


@dataclass
class LoopStats:
    """One request's loop: ``segments`` host reads of the control state,
    ``steps`` steps run, ``replays`` of them as graph replays, and
    ``noop_steps`` of them after the request had stopped (an EOS inside a
    segment; for a batch slot, also steps it waited out while other slots
    ran).  ``steps - noop_steps`` is the request's ``decode_steps``."""
    segments: int = 0
    steps: int = 0
    replays: int = 0
    noop_steps: int = 0


class StepGraphs:
    """An engine's captured steps, one per shape key, and what they ran.

    ``run(key, step, k)`` runs ``step`` k times: on the card, the first
    step of a new key eagerly, then the key's graph replayed for the rest;
    on the CPU, k eager calls.  ``step()`` must read and write only
    buffers that outlive the graph, and hold no host sync.  All graphs of
    one holder share one memory pool and one capture stream: each step's
    temporaries die inside it, and the holder's graphs never run at once."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph,
                                           List[int]]] = {}
        self._pool = None
        self._stream = None
        self.replays = 0        # graph replays, over the holder's life
        self.captures = 0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def launches_per_step(self, key) -> List[int]:
        """The captured key's launches per step, in ``LAUNCH_COUNTERS``
        order."""
        return list(self._graphs[key][1])

    def run(self, key: Hashable, step: Callable[[], None], k: int) -> int:
        """Run ``step`` k >= 1 times; returns how many of them were graph
        replays."""
        if k < 1:
            raise ValueError(f"a segment runs at least one step, got {k}")
        if self.device.type != "cuda":
            for _ in range(k):
                step()
            return 0
        if key not in self._graphs:
            step()              # the warm-up: a real step, run eagerly
            k -= 1
            if k == 0:
                return 0
            self._graphs[key] = self._capture(step)
        graph, per_step = self._graphs[key]
        for _ in range(k):
            graph.replay()
        _add_counters(per_step, k)
        self.replays += k
        return k

    def _capture(self, step):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        # thread_local: a server's other threads may use the card meanwhile
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            step()
        after = _read_counters()
        # the capture recorded the kernels without running them
        _add_counters([b - a for a, b in zip(after, before)])
        self.captures += 1
        return graph, [a - b for a, b in zip(after, before)]


def sure_steps(hist_len: int, left: int, limit: int, block: int,
               max_accept: int, prompt_rest: int = 0) -> int:
    """The steps a live request is certain to stay live for.

    A step is live while the budget is positive and the committed length
    is at most ``limit - block``.  A decode step commits at most
    ``max_accept`` tokens (M for a chain, the tree's depth + 1 for a
    tree); under inline prefill the first ``ceil(prompt_rest / block)``
    steps commit the rest of the prompt, ``block`` tokens a step, and
    spend no budget.  So, with no prompt left, the count is
    ``min(ceil(left / A), ceil((limit - block - hl + 1) / A))``."""
    last = limit - block
    p = -(-max(prompt_rest, 0) // block)
    by_budget = p + -(-max(left, 0) // max_accept)
    if hist_len > last:
        return 0
    in_prompt = min(p, (last - hist_len) // block + 1)
    by_cache = in_prompt
    if in_prompt == p and hist_len + max(prompt_rest, 0) <= last:
        by_cache += (last - hist_len - max(prompt_rest, 0)) \
            // max_accept + 1
    return min(by_budget, by_cache)


def segment_length(hist_lens, budgets, limits, block: int, max_accept: int,
                   steps_per_call: int, refill: bool = False,
                   prompt_rest=None) -> int:
    """k, the steps of the next segment, from the host state of the live
    requests (sequences over the live slots): ``sure_steps`` of each.
    With ``refill`` (a queued request waits) k is the minimum over them,
    so no slot frees inside the segment except by an EOS; otherwise the
    maximum.  k is capped at ``steps_per_call`` and is at least 1."""
    rest = [0] * len(hist_lens) if prompt_rest is None else prompt_rest
    sure = [sure_steps(int(h), int(b), int(l), block, max_accept, int(r))
            for h, b, l, r in zip(hist_lens, budgets, limits, rest)]
    if not sure:
        return 1
    k = min(sure) if refill else max(sure)
    return max(1, min(k, steps_per_call))
