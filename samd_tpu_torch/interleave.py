"""Host-loop request interleaving for the exact-automaton engines
(counterpart of ``samd_tpu/interleave.py``).

The host SAM engine (``engine.SamdEngine``) waits for one device→host copy
per decode step by construction: the automaton must see the accepted
tokens before it can draft the next block.  ``InterleavedSamdEngine``
serves N independent single-stream requests in lanes, each with its own KV
cache, drafter and automaton, so those waits overlap:

  * each lane's step result goes host-ward with a ``non_blocking`` copy
    into pinned memory and a CUDA event the moment the step is dispatched
    (``engine.HostCopy``);
  * the lanes are visited round-robin, so while lane i waits on its
    (already travelling) result, the other lanes' dispatched steps run on
    the device.

Each lane runs ``SamdEngine._steps``, the generator ``SamdEngine.generate``
drains, on its own engine, so outputs are bitwise those of running each
request alone through ``SamdEngine.generate``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .config import GenerationConfig, SamdConfig
from .engine import Outputs, SamdEngine, StepStats
from .models.configs import ModelConfig
from .models.llama import Params


class InterleavedSamdEngine:
    """N-lane round-robin multiplexer over single-stream SamdEngines.

    Args:
      drafter_factory: builds a fresh drafter per lane (lanes must not
        share mutable drafter state; a shared static corpus through
        ``sam.SamCursor`` is fine).
      lanes: number of requests in flight.
      engine_kwargs: passed to each lane's SamdEngine (max_cache_len,
        eos_token_id, prefill_buckets, device, ...).
    """

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 samd_cfg: SamdConfig, drafter_factory: Callable[[], object],
                 *, lanes: int = 2, **engine_kwargs):
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if getattr(drafter_factory(), "wants_hidden", False):
            raise NotImplementedError(
                "interleaving serves host drafters only; hidden-state "
                "drafters (EAGLE) run on SamdEngine (ROADMAP queue 1 "
                "weighs deleting interleaving)")
        self.n_lanes = lanes
        self._engines: List[SamdEngine] = [
            SamdEngine(model_cfg, params, samd_cfg, drafter_factory(),
                       **engine_kwargs) for _ in range(lanes)]
        self.queue: List[tuple] = []
        self.results: Dict[int, Outputs] = {}
        self._next_id = 0

    @property
    def stats(self) -> StepStats:
        agg = StepStats()
        for eng in self._engines:
            agg.merge(eng.stats)
        return agg

    def add_request(self, input_ids: Sequence[int],
                    gen_config: Optional[GenerationConfig] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(input_ids),
                           gen_config or GenerationConfig()))
        return rid

    def run(self) -> Dict[int, Outputs]:
        """Drain the queue through the lanes; returns {request_id:
        Outputs}."""
        lane_rid: List[Optional[int]] = [None] * self.n_lanes
        lane_gen: List[Optional[object]] = [None] * self.n_lanes

        def advance(i: int) -> None:
            """Resume lane i for one step: it reads its last result,
            dispatches the next step and yields again (its copy already
            under way), or finishes."""
            try:
                next(lane_gen[i])
            except StopIteration as fin:
                self.results[lane_rid[i]] = fin.value
                lane_rid[i] = None
                lane_gen[i] = None

        while self.queue or any(g is not None for g in lane_gen):
            for i in range(self.n_lanes):
                if lane_gen[i] is None and self.queue:
                    rid, ids, gen = self.queue.pop(0)
                    lane_rid[i] = rid
                    lane_gen[i] = self._engines[i]._steps(ids, gen)
                    advance(i)          # prefill + first dispatch
            for i in range(self.n_lanes):
                if lane_gen[i] is not None:
                    advance(i)
        out, self.results = self.results, {}
        return out
