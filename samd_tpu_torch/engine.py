"""SamdEngine — the host-automaton speculative-decoding loop (counterpart of
``samd_tpu/engine.py:49-330, 401-453``).

One decode step runs the verify forward over an M-wide draft block (a
chain or a tree from the host drafter), acceptance and KV compaction on
the device, and brings back one packed ``[2 + D]`` int32 vector (accept
length, bonus token, accepted path), plus the ``[M, K]`` top-K harvest
when the drafter consumes it (Token Recycle).  The KV cache is updated in
place.

Greedy requests accept the longest path that matches the argmax.  Sampled
requests (``GenerationConfig(greedy=False)``) accept by the tree rule of
their ``accept_mode`` (``verify.make_accept_fn``): each draws from its
counter-based stream on the device, keyed by ``GenerationConfig.seed``
(``ops.request_noise``, the stream of every sampling engine of the
package): draw 0 gives the first token after the prefill, then each step
takes the next draw, one fixed-size block of noise (``verify.TreeNoise``).

``ArBaseline(block_size=M)`` runs vanilla AR decoding through the same
M-wide step (one real token + padding).  Row position inside a block does
not change a row's arithmetic, so its greedy output is bitwise comparable
with a speculative engine's: it is the equality oracle.

The loop is a generator (``SamdEngine._steps``) that yields each step's
result while it travels to the host (``HostCopy``): ``generate`` waits for
it at once, ``interleave.InterleavedSamdEngine`` serves other requests
meanwhile, and both run the same code.

A hidden-state drafter (``wants_hidden``: the EAGLE drafters) gets the
target's hidden states of the prompt and of each step's accepted path on
the device (``observe_prompt_hidden``, ``observe_step_hidden``), and hands
out drafts built on the device, which ``ops.treeops.unpack_draft_device``
unpacks there.

``stream_generate`` yields each step's committed tokens from the same
generator, and a ``profiling.PhaseTimer`` set as ``engine.profiler``
times the host draft, the device step and the host update of every step.

With ``mesh=`` (a ``parallel.sharding.Mesh``) the engine serves on one
rank of it, as the reference's does under GSPMD: the parameters and the
cache become the rank's shards (``shard_params``, ``shard_kv``), every
forward runs ``models.llama.forward(..., mesh=)``, and every rank runs the
same host drafter on the same tokens, so all ranks take the same path and
``generate`` returns the same ``Outputs`` on each.  An int8 KV cache under
a mesh raises: the reference has no sharding for it.
"""

from __future__ import annotations

import time
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .cache import compact_accepted, init_kv_cache
from .config import GenerationConfig, SamdConfig
from .device import resolve_device
from .drafters.base import Draft
from .models.configs import ModelConfig, check_supported
from .models.llama import Params, block_decode_mask, forward, prefill_mask
from .ops.quant import tensors
from .ops.request_noise import seed_tensor
from .ops.treeops import pack_draft_host, unpack_draft, unpack_draft_device
from .verify import (draw_first_token, draw_tree_noise, greedy_accept,
                     make_accept_fn)

Outputs = namedtuple(
    "Outputs",
    ["output_ids", "decode_tokens", "decode_steps", "accept_length_per_step"])

PREFILL_BUCKETS = (128, 256, 512, 1024, 2048)
HARVEST_TOPK = 8


@dataclass
class StepStats:
    """Draft-source / accept-length diagnostics."""
    source_counts: Dict[str, int] = field(default_factory=dict)
    accept_by_source: Dict[str, int] = field(default_factory=dict)

    def record(self, source: str, accept_len: int) -> None:
        self.source_counts[source] = self.source_counts.get(source, 0) + 1
        self.accept_by_source[source] = (
            self.accept_by_source.get(source, 0) + accept_len)

    def mean_accept(self) -> float:
        steps = sum(self.source_counts.values())
        return sum(self.accept_by_source.values()) / max(steps, 1)

    def merge(self, other: "StepStats") -> None:
        for k, v in other.source_counts.items():
            self.source_counts[k] = self.source_counts.get(k, 0) + v
        for k, v in other.accept_by_source.items():
            self.accept_by_source[k] = self.accept_by_source.get(k, 0) + v


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def check_params_device(params: Params, device: torch.device) -> None:
    """Raise unless every tensor of ``params`` (quantized leaves' values
    and scales included) lies on ``device``'s type."""
    for t in tensors(params):
        if t.device.type != device.type:
            raise ValueError(f"params have a tensor on {t.device}, the "
                             f"engine runs on {device}")


def check_request(ids: Sequence[int], gen: GenerationConfig,
                  vocab_size: int) -> None:
    """Raise ValueError for a request no engine can serve: an empty prompt,
    a token id outside [0, vocab_size) (on CUDA the embedding's gather
    would assert and poison the context for every later request), or a
    sampled request whose top_k exceeds the vocabulary."""
    if not ids:
        raise ValueError("the prompt must be non-empty")
    bad = [t for t in ids if not 0 <= t < vocab_size]
    if bad:
        raise ValueError(f"token id {bad[0]} outside [0, {vocab_size})")
    if not gen.greedy and gen.top_k > vocab_size:
        raise ValueError(f"top_k {gen.top_k} exceeds the vocabulary of "
                         f"{vocab_size}")


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest entries of each row of ``[..., N]``
    and their indices, descending, ties toward the lower index
    (``torch.topk`` promises no order among ties, so a stable descending
    sort picks them)."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def harvest_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` most likely token ids of each row of ``[..., V]`` logits,
    int32 ``[..., k]`` (``top_k``'s tie order)."""
    return top_k(logits, k)[1].to(torch.int32)


class HostCopy:
    """Device tensors on their way to the host.  On CUDA each goes into
    pinned memory with a ``non_blocking`` copy and one event marks the
    end; ``wait`` blocks on the event alone.  CPU tensors are copied at
    once."""

    def __init__(self, tensors: Sequence[Optional[torch.Tensor]]):
        self.event = None
        self.host: List[Optional[torch.Tensor]] = []
        for t in tensors:
            if t is None:
                self.host.append(None)
            elif t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            else:
                self.host.append(t.clone())
        if any(t is not None and t.device.type == "cuda" for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> List[Optional[np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        return [None if h is None else h.numpy() for h in self.host]


class SamdEngine:
    """Verify loop over a host drafter (``lookup``/``observe_*``): greedy,
    or sampled by the request's tree accept rule."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 samd_cfg: SamdConfig, drafter, *,
                 max_cache_len: int = 2048,
                 eos_token_id: int = 2,
                 stop_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        check_supported(model_cfg)
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device or "cuda")
        else:
            from .parallel.sharding import check_shardable, shard_params

            if model_cfg.kv_quant:
                raise ValueError("int8 KV under a mesh needs a QuantizedKV "
                                 "sharding spec")
            if device is not None and \
                    resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            check_shardable(model_cfg, mesh)
            params = shard_params(params, mesh, model_cfg)
        check_params_device(params, self.device)
        self.model_cfg = model_cfg
        self.params = params
        self.samd_cfg = samd_cfg
        self.drafter = drafter
        self.max_cache_len = max_cache_len
        self.eos_token_id = eos_token_id
        self.stop_token_id = stop_token_id
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= max_cache_len)
        # the top-K harvest is computed (a sort over V) only when the
        # drafter consumes it
        self.wants_harvest = getattr(drafter, "wants_harvest", False)
        self.wants_hidden = getattr(drafter, "wants_hidden", False)
        self.stats = StepStats()
        self.profiler = None        # a profiling.PhaseTimer, when set
        self.kv_k, self.kv_v = init_kv_cache(model_cfg, 1, max_cache_len,
                                             self.device)
        if mesh is not None:
            from .parallel.sharding import shard_kv

            self.kv_k, self.kv_v = shard_kv(self.kv_k, self.kv_v, mesh)

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------
    def _prefill(self, input_ids: List[int]):
        """Forward the bucket-padded prompt at offset 0; returns the greedy
        next token (0-dim int32 on the device), the last prompt row's
        logits [V], for a harvesting drafter the prompt rows' top-K [len, K]
        (else None) and the hidden states [P, H]."""
        P = _bucket(len(input_ids), self.prefill_buckets)
        dev, S = self.device, self.max_cache_len
        padded = torch.zeros((1, P), dtype=torch.int32)
        padded[0, :len(input_ids)] = torch.tensor(input_ids,
                                                  dtype=torch.int32)
        logits, hidden = forward(
            self.params, self.model_cfg, padded.to(dev),
            torch.arange(P, device=dev)[None, :], self.kv_k, self.kv_v, 0,
            prefill_mask(1, P, S, dev), mesh=self.mesh)
        last = logits[0, len(input_ids) - 1]
        topk = (harvest_topk(logits[0, :len(input_ids)], HARVEST_TOPK)
                if self.wants_harvest else None)
        return torch.argmax(last).to(torch.int32), last, topk, hidden[0]

    def _verify_core(self, cache_len: torch.Tensor, draft: Draft):
        """Draft buffers, mask and the verify forward.  A draft from the
        host has its tree buffers derived there and uploaded; one built on
        the device is unpacked there."""
        cfg, S, dev = self.model_cfg, self.max_cache_len, self.device
        D = self.samd_cfg.max_tree_depth
        if isinstance(draft.packed, torch.Tensor):
            tokens, tree_mask, depths, paths = (t[0] for t in (
                unpack_draft_device(draft.packed[None], D, draft.depth)))
        else:
            tokens, tree_mask, depths, paths = (
                t.to(dev) for t in unpack_draft(draft.packed, D))
        mask = block_decode_mask(tree_mask, cache_len, S)
        logits, hidden = forward(
            self.params, cfg, tokens[None], depths[None, :] + cache_len,
            self.kv_k, self.kv_v, cache_len, mask, mesh=self.mesh)
        return logits, hidden, tokens, paths

    def _decode_step(self, cache_len: torch.Tensor, draft: Draft,
                     accept=None, noise=None):
        """One verify step; greedy without ``accept``, else that tree rule
        under this step's ``noise``.  Returns the packed ``[2 + D]`` result,
        the block's top-K harvest (None unless the drafter wants it) and the
        target hidden states of the accepted path's nodes [D, H] (None
        unless the drafter wants them), all on the device."""
        M = self.samd_cfg.max_predicts
        logits, hidden, tokens, paths = self._verify_core(cache_len, draft)
        if accept is None:
            res = greedy_accept(logits[0], tokens, paths)
        else:
            res = accept(logits[0], tokens, paths, noise)
        compact_accepted(self.kv_k, cache_len, res.path_nodes, M)
        compact_accepted(self.kv_v, cache_len, res.path_nodes, M)
        # one-transfer result: [accept_len, next_token, path tokens...]
        pack = torch.cat([res.accept_len[None], res.next_token[None],
                          res.accepted_tokens]).to(torch.int32)
        topk = (harvest_topk(logits[0], HARVEST_TOPK)
                if self.wants_harvest else None)
        path_hidden = (hidden[0][torch.clamp(res.path_nodes, min=0).long()]
                       if self.wants_hidden else None)
        return pack, topk, path_hidden

    # ------------------------------------------------------------------
    # Generation loop
    # ------------------------------------------------------------------
    def _truncate_at_stop(self, accepted: List[int]):
        for stop in (self.eos_token_id, self.stop_token_id):
            if stop is not None and stop in accepted:
                return accepted[:accepted.index(stop) + 1], True
        return accepted, False

    def _steps(self, input_ids: Sequence[int],
               gen: Optional[GenerationConfig] = None,
               committed: Optional[List[List[int]]] = None):
        """The loop of ``generate`` as a generator: each step yields its
        ``HostCopy`` once dispatched and reads it when resumed; returns the
        Outputs (``StopIteration.value``).  Each step's committed tokens
        are appended to ``committed`` when it is given."""
        gen = gen or GenerationConfig()
        input_ids = list(input_ids)
        check_request(input_ids, gen, self.model_cfg.vocab_size)
        M, dev = self.samd_cfg.max_predicts, self.device
        D = self.samd_cfg.max_tree_depth
        S = min(self.max_cache_len, gen.max_cache_len)

        self.drafter.reset()
        first, last, topk, hidden = self._prefill(input_ids)
        accept = seeds = draws = sig = None
        if not gen.greedy:
            sig = gen.sampling_signature
            accept = make_accept_fn(sig)
            seeds = seed_tensor([gen.seed], dev)
            draws = torch.ones((1,), dtype=torch.int32, device=dev)
            first = draw_first_token(seeds, last[None], gen.temperature)[0]
        first, topk = HostCopy([first, topk]).wait()
        self.drafter.observe_prompt(input_ids, topk)
        if self.wants_hidden:
            self.drafter.observe_prompt_hidden(input_ids, hidden)

        cache_len = len(input_ids)
        output = list(input_ids)
        decode_tokens = 0
        decode_steps = 0
        accept_lens: List[int] = []
        start_token = int(first)
        prof = self.profiler
        for _ in range(gen.max_steps):
            if cache_len + M > S:
                break
            if prof:
                t0 = time.perf_counter()
            draft = self.drafter.lookup(start_token)
            if prof:
                t0 = prof.lap("draft_lookup", t0)
            offset = torch.tensor(cache_len, dtype=torch.int32, device=dev)
            noise = None
            if accept is not None:
                noise = draw_tree_noise(seeds, draws, None, sig, M, M, D,
                                        self.model_cfg.vocab_size)
                noise = type(noise)(*(t[0] for t in noise))
                draws.add_(1)
            pack, topk, path_hidden = self._decode_step(offset, draft,
                                                        accept, noise)
            pending = HostCopy([pack, topk])
            yield pending
            pack, topk = pending.wait()
            if prof:    # dispatch and wait (and, interleaved, other lanes)
                t0 = prof.lap("device_step", t0)
            accept_len = int(pack[0])
            next_start = int(pack[1])
            accepted = pack[2:2 + accept_len].tolist()

            accepted, eos_hit = self._truncate_at_stop(accepted)
            self.drafter.observe_accepted(accepted)
            if self.wants_harvest:
                self.drafter.observe_verify(draft.packed[0], topk,
                                            draft.num_nodes)
            if self.wants_hidden:
                self.drafter.observe_step_hidden(accepted, path_hidden,
                                                 len(accepted))
            self.stats.record(draft.source, len(accepted))
            if prof:
                prof.lap("host_update", t0)
            if committed is not None:
                committed.append(accepted)

            output.extend(accepted)
            cache_len += accept_len  # cache holds the full accepted path
            decode_steps += 1
            decode_tokens += len(accepted)
            accept_lens.append(len(accepted))
            start_token = next_start
            if eos_hit or decode_tokens >= gen.max_new_tokens:
                break

        output = output[:len(input_ids) + gen.max_new_tokens]
        return Outputs(output, decode_tokens, decode_steps, accept_lens)

    def generate(self, input_ids: Sequence[int],
                 gen_config: Optional[GenerationConfig] = None) -> Outputs:
        steps = self._steps(input_ids, gen_config)
        while True:
            try:
                next(steps)
            except StopIteration as fin:
                return fin.value

    def stream_generate(self, input_ids: Sequence[int],
                        gen_config: Optional[GenerationConfig] = None):
        """Yield accepted-token chunks as they commit (the CLI's
        streaming).  They come from ``_steps``, the loop ``generate``
        runs, cut to ``max_new_tokens`` as ``generate`` cuts its output, so
        joined they equal ``generate(...).output_ids[len(input_ids):]``."""
        gen = gen_config or GenerationConfig()
        committed: List[List[int]] = []
        steps = self._steps(input_ids, gen, committed)
        left = gen.max_new_tokens
        running = True
        while running:
            try:
                next(steps)
            except StopIteration:
                running = False
            while committed:
                chunk = committed.pop(0)[:left]
                left -= len(chunk)
                if chunk:
                    yield chunk


# ----------------------------------------------------------------------
# Autoregressive baseline (speedup denominator + equality oracle)
# ----------------------------------------------------------------------

class _SingleTokenDrafter:
    """Draft = just the start token (padded to the block size): every step
    verifies one token, which is always accepted — vanilla AR decoding."""

    wants_harvest = False

    def __init__(self, block_size: int = 1):
        self.block_size = block_size

    def reset(self):
        pass

    def observe_prompt(self, tokens, topk=None):
        pass

    def observe_accepted(self, tokens):
        pass

    def observe_verify(self, block_tokens, block_topk, num_nodes):
        pass

    def lookup(self, start_token: int) -> Draft:
        packed = pack_draft_host([start_token], [-1], self.block_size)
        return Draft(packed=packed, num_nodes=1, source="ar")


class ArBaseline:
    """Plain autoregressive decoding through the same forward/cache code.

    ``block_size=1`` is the speed baseline; ``block_size=M`` runs AR
    through the same M-wide step as a speculative engine with
    ``max_predicts=M`` — the bitwise greedy-equality oracle, under the
    same ``mesh`` as the engine it judges."""

    def __init__(self, model_cfg: ModelConfig, params: Params, *,
                 max_cache_len: int = 2048, eos_token_id: int = 2,
                 stop_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 block_size: int = 1,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        samd_cfg = SamdConfig(draft_source="sam_only",
                              max_predicts=block_size,
                              max_tree_paths=block_size,
                              max_tree_depth=block_size)
        self.cfg = model_cfg
        self._engine = SamdEngine(
            model_cfg, params, samd_cfg, _SingleTokenDrafter(block_size),
            max_cache_len=max_cache_len, eos_token_id=eos_token_id,
            stop_token_id=stop_token_id, prefill_buckets=prefill_buckets,
            device=device, mesh=mesh)

    def generate(self, input_ids, gen_config=None) -> Outputs:
        return self._engine.generate(input_ids, gen_config)
