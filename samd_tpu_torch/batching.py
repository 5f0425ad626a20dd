"""Continuous batching over the host drafters (counterpart of
``samd_tpu/batching.py``).

``BatchedSamdEngine`` owns B cache slots and steps every active request
together:

  * each request keeps its own host drafter (SAM cursors are per-request
    state; a static corpus SAM is shared through per-request
    ``sam.SamCursor`` objects);
  * one step unpacks the B drafts ``[B, 2, M]`` on the host, runs one
    ``[B, M]`` forward with per-slot cache offsets ``[B]`` (the plain
    attention over the dense batched cache, as ``BatchedFusedSamEngine``
    does), accepts per slot (greedy, or the request's tree rule under its
    own stream's noise) and compacts each slot's accepted path in place
    (``cache.compact_accepted_batched``); it reads one ``[B, 2 + D]``
    control matrix back, plus the ``[B, M, K]`` top-K harvest when the
    drafters consume it;
  * when a request finishes, its slot is re-prefilled from the queue.

Inactive slots run a 1-node pad draft whose writes land past their
committed length, where no slot reads them.

``PagedBatchedSamdEngine`` keeps the KV in a shared page pool instead: the
forward scatters the block into pages and attends straight over the pool
(K4, ``ops.paged_attention``), one fused gather and scatter compacts every
slot's accepted rows, and a request's pages return to the pool when it
finishes.  Like the reference it refuses an int8 pool.

Sampled requests: each slot keeps its request's seed and draw counter on
the device (``ops.request_noise``); draw 0 gives the first token and each
step the request takes one block of tree noise (``verify.draw_tree_noise``,
the counter advancing only on its own steps), the same draws as
``engine.SamdEngine`` makes for it alone; greedy slots keep the argmax
path.  The slots that sample at once must share one sampling signature
(``run`` raises ``ValueError`` otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .cache import compact_accepted_batched, init_kv_cache, update_slot
from .config import GenerationConfig, SamdConfig
from .device import resolve_device
from .engine import (HARVEST_TOPK, PREFILL_BUCKETS, HostCopy, Outputs,
                     StepStats, _bucket, check_params_device, check_request,
                     harvest_topk)
from .models.configs import ModelConfig, check_supported
from .models.llama import Params, block_decode_mask, forward, prefill_mask
from .ops.paged_attention import boundary_mask_window
from .ops.request_noise import seed_word
from .ops.treeops import pack_draft_host, unpack_draft
from .paged_kv import (PagedAux, PagedKVPool, PagedRequest,
                       paged_compact_block, paged_flat_indices,
                       paged_write_block)
from .streaming import ProgressStreamMixin
from .verify import (draw_first_token, draw_tree_noise, greedy_accept,
                     make_accept_fn)


@dataclass
class _Slot:
    request_id: Optional[int] = None
    drafter: object = None
    cache_len: int = 0
    start_token: int = 0
    prompt_len: int = 0
    output: List[int] = field(default_factory=list)
    decode_tokens: int = 0
    decode_steps: int = 0
    accept_lens: List[int] = field(default_factory=list)
    max_new_tokens: int = 0
    sig: Optional[tuple] = None             # sampling signature (None = greedy)

    @property
    def active(self) -> bool:
        return self.request_id is not None


class BatchedSamdEngine(ProgressStreamMixin):
    """B request slots over one dense batched cache, each with its own host
    drafter from ``drafter_factory``."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 samd_cfg: SamdConfig, drafter_factory: Callable[[], object],
                 *, batch_size: int = 4, max_cache_len: int = 2048,
                 eos_token_id: int = 2, stop_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 device: Union[str, torch.device] = "cuda"):
        check_supported(model_cfg)
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        probe = drafter_factory()
        if getattr(probe, "wants_hidden", False):
            raise NotImplementedError(
                "hidden-state drafters (EAGLE) run on SamdEngine and the "
                "fused SAM[EAGLE-2] engines; the reference's batched host "
                "engine carries no hidden states either")
        self.model_cfg = model_cfg
        self.params = params
        self.samd_cfg = samd_cfg
        self.drafter_factory = drafter_factory
        self.B = batch_size
        self.S = max_cache_len
        self.eos_token_id = eos_token_id
        self.stop_token_id = stop_token_id
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= max_cache_len)
        self.stats = StepStats()
        # the top-K harvest (a sort over V per row) only when the drafters
        # consume it
        self._wants_harvest = getattr(probe, "wants_harvest", False)
        self._init_kv()
        self.slots = [_Slot() for _ in range(batch_size)]
        self.queue: List[tuple] = []
        self.results: Dict[int, Outputs] = {}
        self._next_id = 0
        self._pad_draft = pack_draft_host([0], [-1], samd_cfg.max_predicts)
        # each sampling slot's stream: its seed and next draw index
        self._seeds = torch.zeros((batch_size,), dtype=torch.int64,
                                  device=self.device)
        self._draws = torch.zeros((batch_size,), dtype=torch.int32,
                                  device=self.device)
        self.steps_run = 0      # [B, M] decode forwards, over all runs

    # -- KV backend (the paged variant overrides these) --------------------
    def _init_kv(self) -> None:
        self.kv_k, self.kv_v = init_kv_cache(self.model_cfg, self.B, self.S,
                                             self.device)

    def _check_fits(self, ids) -> None:
        """Raise ValueError unless the prompt can ever be admitted."""
        if not self.prefill_buckets or len(ids) > self.prefill_buckets[-1]:
            raise ValueError(f"prompt length {len(ids)} exceeds the largest "
                             f"prefill bucket {self.prefill_buckets[-1:]}")

    def _prefill_forward(self, ids, P: int, fk, fv, W: int):
        """The bucket-padded prompt's forward at offset 0 into a batch-1
        cache of W slots: (greedy next token, last prompt row's logits,
        the prompt rows' top-K or None)."""
        dev = self.device
        padded = torch.zeros((1, P), dtype=torch.int32)
        padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        logits, _ = forward(self.params, self.model_cfg, padded.to(dev),
                            torch.arange(P, device=dev)[None, :], fk, fv, 0,
                            prefill_mask(1, P, W, dev))
        last = logits[0, len(ids) - 1]
        topk = (harvest_topk(logits[0, :len(ids)], HARVEST_TOPK)
                if self._wants_harvest else None)
        return torch.argmax(last).to(torch.int32), last, topk

    def _prefill_slot(self, slot: int, ids):
        """A batch-1 prefill into a fresh cache, written into ``slot``."""
        P = _bucket(len(ids), self.prefill_buckets)
        fk, fv = init_kv_cache(self.model_cfg, 1, self.S, self.device)
        first = self._prefill_forward(ids, P, fk, fv, self.S)
        update_slot(self.kv_k, fk, slot)
        update_slot(self.kv_v, fv, slot)
        return first

    def _forward(self, tokens, pos, cache_lens, tree_mask) -> torch.Tensor:
        """The [B, M] verify forward; returns the logits [B, M, V]."""
        mask = block_decode_mask(tree_mask, cache_lens, self.S)
        logits, _ = forward(self.params, self.model_cfg, tokens, pos,
                            self.kv_k, self.kv_v, cache_lens, mask)
        return logits

    def _compact(self, cache_lens, path_nodes) -> None:
        M = self.samd_cfg.max_predicts
        compact_accepted_batched(self.kv_k, cache_lens, path_nodes, M)
        compact_accepted_batched(self.kv_v, cache_lens, path_nodes, M)

    def _release_slot(self, slot: int) -> None:
        """Called when a request finishes (paged: free its pages)."""

    def _pre_step(self, stepping: List[int]) -> None:
        """Called before each step with the slots that step (paged: grow
        their pages)."""

    # -- scheduler ---------------------------------------------------------
    def add_request(self, input_ids: Sequence[int],
                    gen_config: Optional[GenerationConfig] = None) -> int:
        gen = gen_config or GenerationConfig()
        ids = list(input_ids)
        # rejected here, before the queue: a request the engine cannot serve
        # would otherwise fail the whole batch in run()
        check_request(ids, gen, self.model_cfg.vocab_size)
        self._check_fits(ids)
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, ids, gen))
        return rid

    def _admit(self) -> None:
        for slot_idx, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            rid, input_ids, gen = self.queue.pop(0)
            first, last, topk = self._prefill_slot(slot_idx, input_ids)
            sig = None
            if not gen.greedy:
                sig = gen.sampling_signature
                self._seeds[slot_idx] = seed_word(gen.seed)
                self._draws[slot_idx] = 1
                first = draw_first_token(self._seeds[slot_idx:slot_idx + 1],
                                         last[None], gen.temperature)[0]
            first, topk = HostCopy([first, topk]).wait()
            drafter = self.drafter_factory()
            drafter.reset()
            drafter.observe_prompt(input_ids, topk)
            self.slots[slot_idx] = _Slot(
                request_id=rid, drafter=drafter,
                cache_len=len(input_ids), start_token=int(first),
                prompt_len=len(input_ids), output=list(input_ids),
                max_new_tokens=gen.max_new_tokens, sig=sig)

    def _finish(self, slot_idx: int) -> None:
        s = self.slots[slot_idx]
        out = s.output[:s.prompt_len + s.max_new_tokens]
        self.results[s.request_id] = Outputs(
            out, s.decode_tokens, s.decode_steps, s.accept_lens)
        self._release_slot(slot_idx)
        self.slots[slot_idx] = _Slot()
        self._stream_done(s.request_id)

    def _dispatch(self, cache_lens: np.ndarray, drafts: np.ndarray,
                  stepping: List[int]) -> HostCopy:
        """One batched decode step on the device: (pack [B, 2 + D], topk
        [B, M, K] or None) on their way to the host."""
        dev, M = self.device, self.samd_cfg.max_predicts
        D = self.samd_cfg.max_tree_depth
        sigs = {self.slots[i].sig for i in stepping} - {None}
        if len(sigs) > 1:
            raise ValueError("concurrent sampling requests must share one "
                             f"sampling signature; got {sigs}")
        self._pre_step(stepping)
        tokens, tree_mask, depths, paths = (
            t.to(dev) for t in unpack_draft(drafts, D))
        lens = torch.from_numpy(cache_lens).to(dev)
        logits = self._forward(tokens, depths + lens[:, None], lens,
                               tree_mask)
        res = greedy_accept(logits, tokens, paths)
        accept_len, path_nodes = res.accept_len, res.path_nodes
        accepted, next_token = res.accepted_tokens, res.next_token
        if sigs:
            sig = next(iter(sigs))
            samp = [i in stepping and self.slots[i].sig is not None
                    for i in range(self.B)]
            flag = torch.tensor(samp, device=dev)
            noise = draw_tree_noise(self._seeds, self._draws, flag, sig, M,
                                    M, D, self.model_cfg.vocab_size)
            self._draws.add_(flag.to(torch.int32))
            s = make_accept_fn(sig)(logits, tokens, paths, noise)

            def sel(a, b):
                return torch.where(flag.reshape((-1,) + (1,) * (a.dim() - 1)),
                                   a, b)
            accept_len = sel(s.accept_len, accept_len)
            path_nodes = sel(s.path_nodes, path_nodes)
            accepted = sel(s.accepted_tokens, accepted)
            next_token = sel(s.next_token, next_token)
        self._compact(lens, path_nodes)
        self.steps_run += 1
        pack = torch.cat([accept_len[:, None], next_token[:, None],
                          accepted], dim=1).to(torch.int32)
        topk = (harvest_topk(logits, HARVEST_TOPK)
                if self._wants_harvest else None)
        return HostCopy([pack, topk])

    def _step(self) -> None:
        M = self.samd_cfg.max_predicts
        drafts = np.zeros((self.B, 2, M), np.int32)
        metas = []
        for i, s in enumerate(self.slots):
            if s.active and s.cache_len + M <= self.S:
                d = s.drafter.lookup(s.start_token)
                drafts[i] = d.packed
                metas.append((i, d))
            else:
                drafts[i] = self._pad_draft
                if s.active:
                    self._finish(i)  # out of cache: finish what we have
        if not metas:
            return
        cache_lens = np.asarray([s.cache_len for s in self.slots], np.int32)
        pack, topk = self._dispatch(cache_lens, drafts,
                                    [i for i, _ in metas]).wait()
        for i, d in metas:
            s = self.slots[i]
            accept_len = int(pack[i, 0])
            accepted = pack[i, 2:2 + accept_len].tolist()
            eos_hit = False
            for stop in (self.eos_token_id, self.stop_token_id):
                if stop is not None and stop in accepted:
                    accepted = accepted[:accepted.index(stop) + 1]
                    eos_hit = True
                    break
            s.drafter.observe_accepted(accepted)
            if self._wants_harvest:
                s.drafter.observe_verify(drafts[i, 0], topk[i], d.num_nodes)
            self.stats.record(d.source, len(accepted))
            self._emit_stream_chunk(s.request_id, accepted, s.max_new_tokens)
            s.output.extend(accepted)
            s.cache_len += accept_len
            s.decode_steps += 1
            s.decode_tokens += len(accepted)
            s.accept_lens.append(len(accepted))
            s.start_token = int(pack[i, 1])
            if eos_hit or s.decode_tokens >= s.max_new_tokens:
                self._finish(i)

    def run(self) -> Dict[int, Outputs]:
        """Process the queue to completion; returns request_id → Outputs.
        A failure releases every slot (and its pages) before it
        propagates."""
        try:
            while self.queue or any(s.active for s in self.slots):
                self._admit()
                self._step()
        except BaseException:
            for i, s in enumerate(self.slots):
                if s.active:
                    self._release_slot(i)
                    self.slots[i] = _Slot()
                    self._stream_done(s.request_id)
            raise
        out, self.results = self.results, {}
        return out


# ----------------------------------------------------------------------
# Paged-KV variant
# ----------------------------------------------------------------------

class PagedBatchedSamdEngine(BatchedSamdEngine):
    """``BatchedSamdEngine`` whose KV lives in a shared page pool that the
    paged attention (K4) reads directly through per-slot page tables
    (reference ``samd_tpu/batching.py:366-602``).  Per step a stepping
    slot's table grows to cover its block; the block is scattered into
    pages by the forward; one fused gather and scatter compacts every
    slot's accepted rows.  The prefill runs a dense batch-1 forward into a
    fresh cache of the prompt's bucket and scatters it into pages.  The
    pool is of the model's type: like the reference, the engine refuses
    int8 KV."""

    def __init__(self, *args, n_pages: int = 64, page_size: int = 128,
                 **kwargs):
        self._n_pages = n_pages
        self._page_size = page_size
        super().__init__(*args, **kwargs)

    def _init_kv(self) -> None:
        if self.S % self._page_size != 0:
            raise ValueError("max_cache_len must be a multiple of page_size")
        if self.model_cfg.kv_quant:
            raise ValueError("the paged page pool is of the model's type; "
                             "int8 KV covers the dense-cache engines")
        self.pool = PagedKVPool(self.model_cfg, n_pages=self._n_pages,
                                page_size=self._page_size,
                                device=self.device)
        self.page_size = self._page_size
        self.kv_k, self.kv_v = self.pool.k, self.pool.v
        self.page_reqs = [PagedRequest(self.pool, self.S)
                          for _ in range(self.B)]
        self._tables_cache = None
        self.peak_pages = 0   # high-water mark of allocated pages

    def _tables(self) -> torch.Tensor:
        """[B, P] device tables, uploaded again only when a page
        assignment changed."""
        host = np.stack([r.host_table() for r in self.page_reqs])
        if self._tables_cache is None or \
                not np.array_equal(self._tables_cache[0], host):
            self._tables_cache = (host,
                                  torch.from_numpy(host).to(self.device))
        return self._tables_cache[1]

    def _check_fits(self, ids) -> None:
        super()._check_fits(ids)
        need = self.pool.pages_for(_bucket(len(ids), self.prefill_buckets))
        if need > self.pool.n_pages:
            raise ValueError(f"prompt length {len(ids)} needs {need} pages; "
                             f"the pool holds {self.pool.n_pages}")

    def _pre_step(self, stepping: List[int]) -> None:
        M = self.samd_cfg.max_predicts
        for i in stepping:
            self.page_reqs[i].ensure(self.slots[i].cache_len + M)
        self.peak_pages = max(self.peak_pages,
                              self.pool.n_pages - len(self.pool._free))

    def _forward(self, tokens, pos, cache_lens, tree_mask) -> torch.Tensor:
        mask = boundary_mask_window(tree_mask, cache_lens, self.page_size)
        logits, _ = forward(self.params, self.model_cfg, tokens, pos,
                            self.kv_k, self.kv_v, cache_lens, mask,
                            paged=PagedAux(self._tables(),
                                           self.pool.scratch_page))
        return logits

    def _compact(self, cache_lens, path_nodes) -> None:
        """One gather and one scatter compact every slot's accepted block
        rows to [offset, offset + D) (reference ``compact_all``,
        ``samd_tpu/batching.py:420-444``, here ``paged_compact_block``)."""
        M = self.samd_cfg.max_predicts
        for side in (self.kv_k, self.kv_v):
            paged_compact_block(side, self._tables(), cache_lens, path_nodes,
                                M, self.pool.scratch_page)

    def _release_slot(self, slot: int) -> None:
        self.page_reqs[slot].release()

    def _prefill_slot(self, slot: int, ids):
        P = _bucket(len(ids), self.prefill_buckets)
        req = self.page_reqs[slot]
        req.release()
        req.ensure(min(-(-P // self.page_size) * self.page_size, self.S))
        fk, fv = init_kv_cache(self.model_cfg, 1, P, self.device)
        first = self._prefill_forward(ids, P, fk, fv, P)
        flat_pg, flat_sl = paged_flat_indices(
            req.table(self.device)[None],
            torch.zeros((1,), dtype=torch.int32, device=self.device), P,
            self.page_size, self.pool.scratch_page)
        for l in range(self.model_cfg.num_layers):
            paged_write_block(self.kv_k[l], fk[l], flat_pg, flat_sl)
            paged_write_block(self.kv_v[l], fv[l], flat_pg, flat_sl)
        self.peak_pages = max(self.peak_pages,
                              self.pool.n_pages - len(self.pool._free))
        return first

    def live_kv_tokens(self) -> int:
        """Pool tokens allocated to requests right now."""
        return sum(len(r.pages) for r in self.page_reqs) * self.page_size
