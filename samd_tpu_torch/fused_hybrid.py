"""Fused hybrid SAM[Token Recycle] decoding on the device (counterpart of
``samd_tpu/fused_hybrid.py:1-1024``).

The reference's flagship configuration: every step each request picks its
draft from its own longest-suffix match over its history and the corpus:

  * a retrieval CHAIN of ``n_predicts`` nodes when the match reaches
    ``len_threshold`` (nodes past the available continuation carry -1);
  * else a Token-Recycle TREE of ``tree_nodes`` nodes, filled level by
    level from the request's ``[V + 1, K]`` harvest table (a node whose
    parent token was never harvested carries -1, and so do its children).

A -1 node can never be accepted.  One forward verifies the ``max_block``
M-wide block; the accepted path is compacted in the KV cache, the block's
top-K rows are scattered into the harvest table
(``fused_base.harvest_update``: the highest row wins a duplicated token)
and the path is appended to the history.  The draft's tree buffers (mask,
depths, root-to-node paths) come from three constant parent vectors
unpacked once, the chain, the tree and (inline prefill) the full-block
chain, and are selected per slot on the device: the loop reads nothing per
step but its control vector.

``FusedHybridEngine`` serves one request over a batch-1 cache (the verify
kernel, its int8-KV mode with ``kv_quant``), with per-request cache
buckets; ``BatchedFusedHybridEngine`` steps B slots through the scheduler
of ``fused_sam.BatchedFusedSamEngine`` (one control read per step,
continuous admission, inline prefill); ``PagedBatchedFusedHybridEngine``
keeps their KV in a shared page pool (K4), of q's type or int8.  Greedy
outputs equal ``engine.ArBaseline(block_size=max_block)``'s wherever every
draft was a chain; tree rows attend their ancestors at other columns than
a chain does (docs/EXACTNESS.md), so on the card a tree-drafted request
may first differ at a near-tie.  Sampled requests accept by the tree rule
of their ``accept_mode`` (``verify.make_accept_fn``) with the noise of
their own ``torch.Generator`` (``verify.TreeNoise``).

The harvest's top-K is ``engine.harvest_topk`` (a stable sort: the
reference's exact ``lax.top_k``, which its ``approx_max_k`` equals on the
CPU); the reference's ``approx_harvest`` switch is not ported.

SAM[EAGLE-2] (``FusedHybridEagleEngine``, ``BatchedFusedHybridEagleEngine``,
``PagedBatchedFusedHybridEagleEngine``, reference
``fused_hybrid.py:1026-1728``) draws the tree from the EAGLE-2 draft net
(``eagle_fused``) through the same engines' drafter hooks
(``_tree_draft``, ``_buffers``, ``_observe_block``, ``_observe_prompt``,
``_observe_accept``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .cache import compact_accepted, compact_accepted_batched
from .config import GenerationConfig
from .drafters.tree_topology import child_ranks, rank_probability_tree
from .eagle_fused import EagleDraftNet
from .engine import Outputs, harvest_topk
from .fused_base import harvest_update
from .fused_sam import BatchedFusedSamEngine, FusedSamEngine, \
    PagedBatchedFusedSamEngine
from .models.configs import ModelConfig
from .models.llama import Params, block_decode_mask, forward
from .ops.paged_attention import boundary_mask_window
from .ops.treeops import unpack_draft
from .paged_kv import paged_compact_block
from .sam.trees import node_depths
from .verify import draw_tree_noise, greedy_accept, make_accept_fn


@dataclass(frozen=True)
class FusedHybridConfig:
    """Reference-canonical hybrid knobs (n_predicts 40, len_threshold 5,
    len_bias 5)."""
    max_ngram: int = 8
    ext: int = 56
    n_predicts: int = 40        # retrieval chain length (incl. start token)
    len_threshold: int = 5
    len_bias: int = 5
    tree_nodes: int = 61        # Token-Recycle topology size
    topk: int = 8
    # the batched engines' segment length (one stream has no segments)
    steps_per_call: int = 256
    corpus_capacity: int = 1 << 15
    max_block: int = 64         # M >= max(n_predicts, tree_nodes)
    # n-gram hash index for corpus-scale retrieval (ops.ngram_index)
    indexed: bool = False
    index_grams: Tuple[int, ...] = (32, 16, 8, 7, 6, 5, 4, 3, 2, 1)
    index_bucket_cap: int = 8
    index_keep_latest: int = 0
    # per-request KV-cache sizes (see FusedSamConfig.cache_buckets)
    cache_buckets: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_block < max(self.n_predicts, self.tree_nodes):
            raise ValueError("max_block must cover n_predicts and "
                             "tree_nodes")

    @property
    def block(self) -> int:
        """M, the verify block (the name the fused scheduler reads)."""
        return self.max_block


def build_tr_topology(tree_nodes: int, topk: int
                      ) -> Tuple[np.ndarray, np.ndarray, list, np.ndarray]:
    """The Token-Recycle topology (``rank_probability_tree``) relabelled so
    that each depth level is a contiguous run of nodes (ties in node
    order): (parents, depths, children, rank), where ``rank[c]`` is c's
    place among its parent's children (the harvest column it takes)."""
    parents = rank_probability_tree(tree_nodes, branching=topk)
    d = node_depths(parents)
    order = np.lexsort((np.arange(len(parents)), d))
    new_pos = np.empty(len(parents), np.int32)
    new_pos[order] = np.arange(len(parents), dtype=np.int32)
    relabeled = np.full(len(parents), -1, np.int32)
    for i, p in enumerate(parents):
        if p >= 0:
            relabeled[new_pos[i]] = new_pos[p]
    children = child_ranks(relabeled)
    rank = np.zeros(len(parents), np.int32)
    for childs in children:
        for r, c in enumerate(childs):
            rank[c] = r
    return relabeled, node_depths(relabeled), children, rank


def make_tr_draft(tr_parents, tr_depths, tr_rank, M: int,
                  device: Union[str, torch.device]):
    """The Token-Recycle tree fill from the harvest tables:
    ``tr_draft(harvests [B, V + 1, K], seens [B, V + 1], starts [B]) ->
    tokens [B, M]`` int32, -1 at every node past the tree and under a
    parent whose token was never harvested.  One gather per depth level."""
    levels = []
    for dd in range(1, int(tr_depths.max()) + 1):
        nodes = np.nonzero(tr_depths == dd)[0]
        levels.append(tuple(torch.from_numpy(np.asarray(a, np.int64)).to(
            device) for a in (nodes, tr_parents[nodes], tr_rank[nodes])))

    def tr_draft(harvests: torch.Tensor, seens: torch.Tensor,
                 starts: torch.Tensor) -> torch.Tensor:
        B, V1, K = harvests.shape
        dev = harvests.device
        tokens = torch.full((B, M), -1, dtype=torch.int32, device=dev)
        tokens[:, 0] = starts
        valid = torch.zeros((B, M), dtype=torch.bool, device=dev)
        valid[:, 0] = True
        flat = harvests.reshape(B * V1, K)
        base = V1 * torch.arange(B, device=dev)[:, None]
        for nodes, par, rank in levels:
            ptok = tokens[:, par]                                 # [B, n]
            pt = torch.clamp(ptok, min=0).long()
            ok = valid[:, par] & (ptok >= 0) & torch.gather(seens, 1, pt)
            t = flat[base + pt, rank[None, :]]
            tokens[:, nodes] = torch.where(ok, t, -1)
            valid[:, nodes] = ok
        return tokens

    return tr_draft


def constant_buffers(parents, M: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A constant draft's buffers from its [M] parents, unpacked once on the
    host (``ops.treeops.unpack_draft``): (tree mask [M, M], depths [M],
    root-to-node paths [M, M])."""
    parents = np.asarray(parents, np.int32)
    return unpack_draft(np.stack([np.zeros_like(parents), parents]), M)[1:]


class HarvestTables:
    """The Token-Recycle harvest of an engine with ``cfg.topk``,
    ``model_cfg`` and ``device``: per slot the table ``harvests[b]``
    [V + 1, K] and ``seens[b]`` [V + 1] (row V is the sink), filled from
    every prefill row and every verified block row."""

    def _init_harvest(self, slots: int) -> None:
        V, K = self.model_cfg.vocab_size, self.cfg.topk
        self.harvests = torch.zeros((slots, V + 1, K), dtype=torch.int32,
                                    device=self.device)
        self.seens = torch.zeros((slots, V + 1), dtype=torch.bool,
                                 device=self.device)

    def _observe_block(self, logits: torch.Tensor, drafts: torch.Tensor,
                       lives: torch.Tensor) -> None:
        """After a verify of drafts [B, T] (-1 where invalid): harvest the
        block's top-K rows of the live slots' valid nodes.  A dead slot's
        rows land on its sink row V, as in the reference's loop; a step
        with no live slot (a segment's no-op step, which the reference
        never runs) leaves the tables as they are."""
        V = self.model_cfg.vocab_size
        rows = torch.where(lives[:, None] & (drafts >= 0), drafts, V)
        sink = self.harvests[:, V].clone()
        harvest_update(self.harvests, self.seens, rows,
                       harvest_topk(logits, self.cfg.topk))
        self.harvests[:, V] = torch.where(lives.any(), self.harvests[:, V],
                                          sink)

    def _observe_prompt(self, slot: int, tokens: torch.Tensor, true_len: int,
                        logits: torch.Tensor, hidden: torch.Tensor) -> None:
        V = self.model_cfg.vocab_size
        P = tokens.shape[0]
        rows = torch.where(torch.arange(P, device=tokens.device) < true_len,
                           tokens, V)
        harvest_update(self.harvests[slot:slot + 1],
                       self.seens[slot:slot + 1], rows[None],
                       harvest_topk(logits, self.cfg.topk)[None])


class _HybridDraft(HarvestTables):
    """The hybrid's drafter state and draft, shared by the single-stream
    and the batched engines (which own ``cfg``, ``model_cfg``, ``device``,
    ``B`` or one slot, ``_draft``, the corpus and ``_chain_pos``): the
    harvest tables and constant buffers for the three draft shapes,
    stacked as kind 0 chain, 1 tree, 2 full-block chain."""

    def _init_hybrid(self, slots: int) -> None:
        hc, dev = self.cfg, self.device
        M = hc.max_block
        self.tr_parents, self.tr_depths, _, self.tr_rank = \
            build_tr_topology(hc.tree_nodes, hc.topk)
        N = len(self.tr_parents)
        chain = np.concatenate([np.arange(-1, hc.n_predicts - 1),
                                np.arange(hc.n_predicts, M)])
        tree = np.concatenate([self.tr_parents, np.arange(N, M)])
        kinds = [constant_buffers(p, M) for p in
                 (chain, tree, np.arange(-1, M - 1))]
        self._kind_mask, self._kind_depths, self._kind_paths = (
            torch.stack([k[i] for k in kinds]).to(dev) for i in range(3))
        self._tr_draft = make_tr_draft(self.tr_parents, self.tr_depths,
                                       self.tr_rank, M, dev)
        self._init_harvest(slots)

    def _max_accept(self) -> int:
        """A retrieval chain commits at most n_predicts tokens, a tree its
        depth + 1."""
        return max(self.cfg.n_predicts, int(self.tr_depths.max()) + 1)

    # -- drafter hooks (the SAM[EAGLE-2] engines override these) ---------
    def _tree_draft(self, hist_lens: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
        """The model-side draft of every slot, [B, M] tokens (-1 where
        invalid) on the constant tree."""
        return self._tr_draft(self.harvests, self.seens, starts)

    def _observe_accept(self, hidden, hist_lens, path_nodes, acc, alens,
                        lives) -> None:
        """After a step's accept: the block's hidden states [B, M, H], the
        committed lengths before the step [B], the accepted path's nodes
        and tokens [B, D], the accept lengths and live flags [B].  The
        harvest has what it needs from ``_observe_block``."""

    def _accept_rule(self, sig: tuple):
        return make_accept_fn(sig)

    def _draw_noise(self, generators, sig: tuple):
        M = self.cfg.max_block
        return draw_tree_noise(generators, sig, M, M, M,
                               self.model_cfg.vocab_size, self.device)

    # -- the draft ----------------------------------------------------------
    def _hybrid_draft(self, history, hist_lens, starts):
        """Each slot's draft from its history [B, S] and start token [B]:
        (use_sam [B], tokens [B, M] with -1 where invalid, kind [B] — 0 a
        retrieval chain, 1 the tree)."""
        hc, M = self.cfg, self.cfg.max_block
        match, _, raw, cont_avail = self._draft(
            self.corpus, self.corpus_len, history, hist_lens, starts,
            self.corpus_index)
        # a fixed-length chain, as the reference hybrid drafts it
        avail = torch.clamp(cont_avail, max=hc.n_predicts - 1)
        pos = self._chain_pos[None, :]
        keep = (pos >= 1) & (pos <= avail[:, None]) & (pos < hc.n_predicts)
        chain = torch.where(keep | (pos == 0), raw, -1)
        use_sam = match >= hc.len_threshold
        tree = self._tree_draft(hist_lens, starts)
        tokens = torch.where(use_sam[:, None], chain, tree)
        return use_sam, tokens, (~use_sam).to(torch.int64)

    def _buffers(self, kind: torch.Tensor):
        """(tree mask [B, M, M], depths [B, M], paths [B, M, M]) of each
        slot's draft kind."""
        return (self._kind_mask[kind], self._kind_depths[kind],
                self._kind_paths[kind])


class FusedHybridEngine(_HybridDraft, FusedSamEngine):
    """SAM[Token Recycle] over one batch-1 KV cache, greedy or sampled
    (reference ``samd_tpu/fused_hybrid.py:114-368``).  The harvest table
    persists across requests, as the reference's Token-Recycle cache does.
    ``sam_steps``: the last request's steps that drafted a retrieval chain
    (read once per request)."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 hy_cfg: Optional[FusedHybridConfig] = None, *,
                 corpus: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(model_cfg, params, hy_cfg or FusedHybridConfig(),
                         corpus=corpus, **kwargs)
        self._init_hybrid(1)
        self.sam_steps = 0          # the last request's retrieval drafts
        self.sam_steps_total = 0
        self.steps_total = 0
        self._sam_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

    def _step(self, W, history, hist_len, start, budget, done, live, eos,
              accept=None, noise=None):
        """One hybrid step on the device (reference body,
        ``samd_tpu/fused_hybrid.py:224-284``); the contract of
        ``FusedSamEngine._step``: a step that is not ``live`` compacts
        every row onto itself, harvests nothing and counts no draft."""
        M = self.cfg.max_block
        use_sam, draft, kind = self._hybrid_draft(
            history[None], hist_len[None], start[None])
        tree_mask, depths, paths = self._buffers(kind)
        off = torch.clamp(hist_len, max=W - M)     # hist_len when live
        logits, hidden = forward(
            self.params, self.model_cfg, torch.clamp(draft, min=0),
            depths + off, self.kv_k, self.kv_v, off,
            block_decode_mask(tree_mask[0], off, W))
        if accept is None:
            res = greedy_accept(logits[0], draft[0], paths[0])
        else:
            res = accept(logits, draft, paths, noise)
            res = type(res)(*(t[0] for t in res))
        D = res.path_nodes.shape[0]
        path = torch.where(live, res.path_nodes, self._chain_pos[:D])
        compact_accepted(self.kv_k, off, path, M)
        compact_accepted(self.kv_v, off, path, M)
        self._observe_block(logits, draft, live[None])
        acc = torch.clamp(res.accepted_tokens, min=0)
        is_eos = (acc == eos) & (self._chain_pos[:D] < res.accept_len)
        any_eos = torch.any(is_eos)
        alen = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32)) + 1,
                           res.accept_len).to(torch.int32)
        self._observe_accept(hidden, hist_len[None], res.path_nodes[None],
                             acc[None], alen[None], live[None])
        self._sam_count += (use_sam[0] & live).to(torch.int32)
        return self._commit(history, hist_len, start, budget, done, live,
                            acc, alen, any_eos, res.next_token)

    def generate(self, input_ids: Sequence[int],
                 gen_config: Optional[GenerationConfig] = None) -> Outputs:
        self._sam_count.zero_()
        out = super().generate(input_ids, gen_config)
        self.sam_steps = int(self._sam_count)
        self.sam_steps_total += self.sam_steps
        self.steps_total += out.decode_steps
        return out


class BatchedFusedHybridEngine(_HybridDraft, BatchedFusedSamEngine):
    """B request slots of SAM[Token Recycle] under continuous batching
    (reference ``samd_tpu/fused_hybrid.py:371-913``): the scheduler of
    ``BatchedFusedSamEngine`` (segments with one control read each,
    admission, refill, inline prefill, one sampling signature) over the
    hybrid step.  Each slot keeps its own harvest table across the requests
    it serves; only live slots harvest.  Row 5 of the control matrix counts
    a slot's retrieval-chain steps (``sam_steps_total``)."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 hy_cfg: Optional[FusedHybridConfig] = None, *,
                 corpus: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(model_cfg, params,
                         hy_cfg or FusedHybridConfig(steps_per_call=16),
                         corpus=corpus, **kwargs)
        self._init_hybrid(self.B)

    @property
    def sam_steps_total(self) -> int:
        return self.stats_corpus_steps

    @property
    def steps_total(self) -> int:
        return self.stats_live_steps

    def _compact(self, hist_lens, path_nodes, paged) -> None:
        M = self.cfg.max_block
        compact_accepted_batched(self.kv_k, hist_lens, path_nodes, M)
        compact_accepted_batched(self.kv_v, hist_lens, path_nodes, M)

    def _step(self, hist_lens, starts, budgets, lives, slot_steps, sam_steps,
              prompt_lens, alloc_limits, paged, samp=None, accept=None,
              noise=None):
        """One hybrid step of all B slots on the device (reference body,
        ``samd_tpu/fused_hybrid.py:596-758``); the contract of
        ``BatchedFusedSamEngine._step``, with row 5 the retrieval-chain
        steps."""
        M, S, B = self.cfg.max_block, self.S, self.B
        hist = self.histories
        use_sam, drafts, kind = self._hybrid_draft(hist[:, :S], hist_lens,
                                                   starts)
        pos = hist_lens[:, None] + self._chain_pos[None, :]       # [B, M]
        if self.inline_prefill:
            # a slot inside its prompt drafts the next M prompt tokens as a
            # forced-accept chain over the whole block; rows past the prompt
            # carry -1, so the harvest ignores them
            pf_rest = prompt_lens - hist_lens
            in_pf = pf_rest > 0
            forced = torch.clamp(pf_rest, max=M).to(torch.int32)
            chunk = torch.where(self._chain_pos[None, :] < forced[:, None],
                                torch.gather(hist, 1, pos.long()), -1)
            drafts = torch.where(in_pf[:, None], chunk, drafts)
            kind = torch.where(in_pf, 2, kind)
            use_sam = use_sam & ~in_pf
        tree_mask, depths, paths = self._buffers(kind)
        if paged is not None:
            mask = boundary_mask_window(tree_mask, hist_lens,
                                        self.kv_k.page_size)
        else:
            mask = block_decode_mask(tree_mask, hist_lens, S)
        logits, hidden = forward(
            self.params, self.model_cfg, torch.clamp(drafts, min=0),
            depths + hist_lens[:, None], self.kv_k, self.kv_v, hist_lens,
            mask, paged=paged)
        res = greedy_accept(logits, drafts, paths)
        alens, path_nodes = res.accept_len, res.path_nodes
        acc, bonus = res.accepted_tokens, res.next_token
        if accept is not None:
            s = accept(logits, drafts, paths, noise)
            alens = torch.where(samp, s.accept_len, alens)
            path_nodes = torch.where(samp[:, None], s.path_nodes, path_nodes)
            acc = torch.where(samp[:, None], s.accepted_tokens, acc)
            bonus = torch.where(samp, s.next_token, bonus)
        D = acc.shape[1]
        if self.inline_prefill:
            # the prompt chunk is accepted as forced: its path is the chain
            # itself; the boundary block's bonus (the argmax at the last
            # prompt row) is the first generated token, mid-prompt the next
            # start is the next prompt token
            alens = torch.where(in_pf, forced, alens)
            acc = torch.where(in_pf[:, None],
                              torch.clamp(drafts, min=0)[:, :D], acc)
            path_nodes = torch.where(
                in_pf[:, None], self._chain_pos[None, :D], path_nodes)
            last = torch.gather(logits, 1, torch.clamp(
                forced - 1, min=0).long()[:, None, None].expand(
                    B, 1, logits.shape[-1]))[:, 0]
            bonus = torch.where(in_pf, torch.argmax(last, dim=-1).to(
                torch.int32), bonus)
            nxt_prompt = torch.gather(hist, 1, torch.clamp(
                hist_lens + M, max=S - 1).long()[:, None])[:, 0]
            bonus = torch.where(in_pf & (pf_rest > M), nxt_prompt, bonus)
        self._compact(hist_lens, path_nodes, paged)
        self._observe_block(logits, drafts, lives)
        acc = torch.clamp(acc, min=0)
        is_eos = (acc == self._eos) & (self._chain_pos[None, :D]
                                       < alens[:, None])
        if self.inline_prefill:
            is_eos = is_eos & ~in_pf[:, None]
        any_eos = is_eos.any(dim=1)
        alens = torch.where(
            any_eos, torch.argmax(is_eos.to(torch.int32), dim=1) + 1,
            alens).to(torch.int32)
        alens = torch.where(lives, alens, 0)
        self._observe_accept(hidden, hist_lens, path_nodes, acc, alens, lives)
        hist.scatter_(1, pos[:, :D].long(), acc)
        hist_lens = hist_lens + alens
        counted = lives
        if self.inline_prefill:   # prompt tokens consume no budget
            budgets = budgets - torch.where(in_pf, 0, alens)
            counted = counted & ~in_pf
        else:
            budgets = budgets - alens
        slot_steps = slot_steps + counted.to(torch.int32)
        sam_steps = sam_steps + (lives & use_sam).to(torch.int32)
        starts = torch.where(lives, bonus, starts)
        lives = lives & ~any_eos & (budgets > 0) \
            & (hist_lens + M <= alloc_limits)
        return hist_lens, starts, budgets, lives, slot_steps, sam_steps


class PagedBatchedFusedHybridEngine(BatchedFusedHybridEngine,
                                    PagedBatchedFusedSamEngine):
    """``BatchedFusedHybridEngine`` over a shared page pool (reference
    ``samd_tpu/fused_hybrid.py:915-1024``): the page lifecycle, the int8
    pool option (``quantized_kv``), the capacity retries and the scatter
    prefill of ``PagedBatchedFusedSamEngine``; tree drafts compact the
    accepted path on the pages (``paged_kv.paged_compact_block``)."""

    def _compact(self, hist_lens, path_nodes, paged) -> None:
        for side in (self.kv_k, self.kv_v):
            paged_compact_block(side, paged.tables, hist_lens, path_nodes,
                                self.cfg.max_block, paged.scratch_page)


# ----------------------------------------------------------------------
# SAM[EAGLE-2]: retrieval chains or draft-net trees, on the device
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class FusedHybridEagleConfig:
    """SAM-Decoding[EAGLE-2], the reference's strongest configuration
    (``samd_tpu/fused_hybrid.py:1026-1045``)."""
    max_ngram: int = 8
    ext: int = 56
    n_predicts: int = 40
    len_threshold: int = 5
    len_bias: int = 5
    eagle_depth: int = 5
    eagle_topk: int = 8
    eagle_total: int = 63
    steps_per_call: int = 256
    corpus_capacity: int = 1 << 15
    max_block: int = 64
    indexed: bool = False
    index_grams: Tuple[int, ...] = (32, 16, 8, 7, 6, 5, 4, 3, 2, 1)
    index_bucket_cap: int = 8
    index_keep_latest: int = 0
    cache_buckets: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_block < max(self.n_predicts, self.eagle_total + 1):
            raise ValueError("max_block must cover n_predicts and "
                             "eagle_total + 1")

    @property
    def block(self) -> int:
        return self.max_block


class _EagleHybrid(EagleDraftNet):
    """The hybrid's drafter hooks with an EAGLE-2 tree in place of the
    Token-Recycle one: the chain's constant buffers, and per step every
    slot's expanded tree, unpacked on the device; the draft net's KV
    extends with every step's accepted (token, target hidden) pairs,
    whichever source drafted, and a prefill fills it from the prompt.
    The net and its state are ``eagle_fused.EagleDraftNet``'s."""

    def _init_hybrid(self, slots: int) -> None:
        hc, M = self.cfg, self.cfg.max_block
        chain = np.concatenate([np.arange(-1, hc.n_predicts - 1),
                                np.arange(hc.n_predicts, M)])
        self._chain_bufs = tuple(t.to(self.device)[None]
                                 for t in constant_buffers(chain, M))
        self._init_eagle(self.net_params, slots, depth=hc.eagle_depth,
                         topk=hc.eagle_topk, total=hc.eagle_total, M=M)

    def _max_accept(self) -> int:
        return max(self.cfg.n_predicts, self.eagle_depth + 1)

    def _tree_draft(self, hist_lens, starts):
        packed, self._tree_bufs = self._eagle_tree(hist_lens, starts)
        return packed[:, 0]

    def _buffers(self, kind):
        chain = kind == 0
        return tuple(torch.where(chain.reshape((-1,) + (1,) * (t.dim() - 1)),
                                 c, t)
                     for c, t in zip(self._chain_bufs, self._tree_bufs))

    def _observe_block(self, logits, drafts, lives) -> None:
        pass

    def _observe_prompt(self, slot, tokens, true_len, logits, hidden):
        self._net_prefill(slot, tokens, true_len, hidden)

    def _observe_accept(self, hidden, hist_lens, path_nodes, acc, alens,
                        lives) -> None:
        self._net_extend(hidden, hist_lens, path_nodes, acc, alens, lives)


class FusedHybridEagleEngine(_EagleHybrid, FusedHybridEngine):
    """SAM[EAGLE-2] over one batch-1 cache (reference
    ``samd_tpu/fused_hybrid.py:1048-1278``): per step a retrieval chain
    when the suffix match reaches ``len_threshold``, else an EAGLE-2 tree.
    ``net_params=None`` draws a random net from a generator seeded 7;
    keyword arguments are ``fused_sam.SingleStreamEngine``'s."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 hy_cfg: Optional[FusedHybridEagleConfig] = None, *,
                 net_params=None, corpus: Optional[Sequence[int]] = None,
                 **kwargs):
        self.net_params = net_params
        super().__init__(model_cfg, params,
                         hy_cfg or FusedHybridEagleConfig(), corpus=corpus,
                         **kwargs)


class BatchedFusedHybridEagleEngine(_EagleHybrid, BatchedFusedHybridEngine):
    """B request slots of SAM[EAGLE-2] under continuous batching (reference
    ``samd_tpu/fused_hybrid.py:1280-1631``): the scheduler, sampling and
    compaction of ``BatchedFusedHybridEngine``; the per-slot state is the
    draft net's KV and the target's last hidden state, not harvest tables,
    and the expansion runs over the slot axis.  Admission takes the
    one-shot prefill only (the net's pairs sit one position behind the
    target KV, so an inline first block has no pair to start from)."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 hy_cfg: Optional[FusedHybridEagleConfig] = None, *,
                 net_params=None, corpus: Optional[Sequence[int]] = None,
                 **kwargs):
        if kwargs.pop("inline_prefill", False):
            raise ValueError("the SAM[EAGLE-2] engines prefill in one shot")
        self.net_params = net_params
        super().__init__(model_cfg, params,
                         hy_cfg or FusedHybridEagleConfig(steps_per_call=16),
                         corpus=corpus, **kwargs)

    def _alloc_limits(self) -> np.ndarray:
        # a slot also stops where its tree scratch would pass S
        return np.minimum(super()._alloc_limits(),
                          self.S + self.cfg.block - self.tree_slots)


class PagedBatchedFusedHybridEagleEngine(BatchedFusedHybridEagleEngine,
                                         PagedBatchedFusedHybridEngine):
    """``BatchedFusedHybridEagleEngine`` with the target KV on a shared page
    pool, of q's type or int8 (reference
    ``samd_tpu/fused_hybrid.py:1633-1728``): the page lifecycle and
    ``paged_kv.paged_compact_block`` of ``PagedBatchedFusedHybridEngine``.
    The draft net's KV stays dense per slot (one layer)."""
