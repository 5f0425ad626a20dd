"""Fused EAGLE-2 on the device (counterpart of ``samd_tpu/eagle_fused.py``).

Each step runs three phases on the device, with one host read of the
control vector (``fused_sam.SingleStreamEngine``'s loop):

  expand : beam search over the one-layer draft net (``make_eagle_expand``:
           depth x top-K, a global top-``total`` selection, packing in
           (depth, pool index) order) gives the packed ``[2, M]`` draft;
  verify : ``ops.treeops.unpack_draft_device`` derives the tree's mask,
           positions and paths on the device, one target forward verifies
           the block and the tree rule accepts a path;
  extend : the accepted path's (token, target hidden) pairs advance the
           draft net's stable KV, and the target hidden of the last
           accepted node seeds the next expansion.

Draft-net KV layout: the net's pairs sit one position behind the target
KV (the stable length is ``hist_len - 1``); the expansion writes its tree
scratch after the stable prefix and the next extension overwrites it.  The
net KV carries ``max(M, 1 + depth * K)`` columns past S, so no write ever
clamps (the reference's clamped update, which only a stopped slot of a
batched engine reaches, is not copied).

Ties among equal scores go to the lower index, as ``lax.top_k`` breaks them
(``engine.top_k``), in the four top-K calls and the global selection.  The
draft head is the target's (``models.llama._head``): the int4 head of a
packed-int4 model under ``int4_impl="kernel"`` goes through the int4
matmul (K3, one launch per level), a plain or int8 head through the
reference's pre-dequant product.  Greedy outputs equal
``engine.ArBaseline(block_size=total + 1)``'s on the CPU; on the card tree
rows attend their ancestors at other columns than a chain does
(docs/EXACTNESS.md), so a request may first differ at a near-tie.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .cache import compact_accepted
from .drafters.eagle.net import (EagleNetConfig, eagle_forward,
                                 init_eagle_kv, init_eagle_params)
from .engine import check_params_device, top_k
from .fused_sam import SingleStreamEngine
from .models.configs import ModelConfig
from .models.llama import Params, _head, block_decode_mask, forward
from .ops.treeops import unpack_draft_device
from .verify import draw_tree_noise, greedy_accept, make_accept_fn

NEG = -1e30


def make_eagle_expand(net_cfg: EagleNetConfig, model_cfg: ModelConfig, *,
                      depth: int, topk: int, total: int, M: int):
    """The EAGLE-2 beam expansion over a slot axis (reference
    ``samd_tpu/eagle_fused.py:47-152``, which the reference vmaps):
    ``expand(net_params, params, ekv_k, ekv_v, stable_len [B],
    last_hidden [B, H], start [B]) -> packed [B, 2, M]`` int32, writing
    each slot's tree scratch into its net KV at
    ``[stable_len, stable_len + 1 + depth * K)``.  Returns (expand, that
    scratch width).  The selection is ancestor-closed by score
    monotonicity; padding nodes are self-parented."""
    K = topk
    tree_slots = 1 + depth * K
    pool = 1 + K + (depth - 1) * K * K
    sel_n = total + 1
    if sel_n > min(pool, M):
        raise ValueError(f"total_tokens + 1 = {sel_n} exceeds the block "
                         f"({M}) or the candidate pool ({pool})")

    def expand(net_params: Dict, params: Params, ekv_k: torch.Tensor,
               ekv_v: torch.Tensor, stable_len: torch.Tensor,
               last_hidden: torch.Tensor, start: torch.Tensor
               ) -> torch.Tensor:
        B, S = start.shape[0], ekv_k.shape[2]
        dev, embed = start.device, params["embed"]
        H = net_cfg.hidden_size
        stable = stable_len.to(torch.int64)
        s_idx = torch.arange(S, device=dev)
        kk = torch.arange(K, device=dev)

        def logp(h):
            return torch.log_softmax(_head(h, params, model_cfg), dim=-1)

        # the root: tree slot 0, net KV column stable_len
        h0 = eagle_forward(
            net_params, net_cfg, F.embedding(start.long()[:, None], embed),
            last_hidden[:, None], stable[:, None], ekv_k, ekv_v, stable,
            (s_idx[None] <= stable[:, None])[:, None])[:, 0]      # [B, H]
        val1, tok1 = top_k(logp(h0), K)                           # [B, K]
        pool_tokens = torch.zeros((B, pool), dtype=torch.int64, device=dev)
        pool_parents = torch.full((B, pool), -1, dtype=torch.int64,
                                  device=dev)
        pool_scores = torch.full((B, pool), NEG, dtype=torch.float32,
                                 device=dev)
        pool_depth = torch.zeros((B, pool), dtype=torch.int64, device=dev)
        pool_tokens[:, 0] = start
        pool_scores[:, 0] = 0.0
        pool_tokens[:, 1:1 + K] = tok1
        pool_parents[:, 1:1 + K] = 0
        pool_scores[:, 1:1 + K] = val1
        pool_depth[:, 1:1 + K] = 1
        beam_tokens, beam_scores = tok1, val1
        beam_hidden = h0[:, None].expand(B, K, H)
        beam_pool_idx = (1 + kk).expand(B, K)
        anc = torch.zeros((B, K, tree_slots), dtype=torch.bool, device=dev)
        anc[:, :, 0] = True
        # index writes take a device value: no host copy in a captured step
        true = torch.ones((), dtype=torch.bool, device=dev)
        anc[:, kk, 1 + kk] = true
        # tree columns of the net KV, as each beam row sees them
        rel = torch.clamp(s_idx[None] - stable[:, None], 0, tree_slots - 1)
        in_tree = (s_idx[None] >= stable[:, None]) \
            & (s_idx[None] < stable[:, None] + tree_slots)
        prefix = s_idx[None] < stable[:, None]
        parent_row = kk.repeat_interleave(K)                      # [K*K]
        for lvl in range(1, depth):
            # the beam (depth lvl) takes tree slots 1 + (lvl-1)K .. + K - 1
            anc_now = anc.clone()
            anc_now[:, kk, 1 + (lvl - 1) * K + kk] = true
            tree_m = torch.gather(anc_now, 2,
                                  rel[:, None, :].expand(B, K, S))
            mask = prefix[:, None] | (in_tree[:, None] & tree_m)  # [B,K,S]
            h = eagle_forward(
                net_params, net_cfg, F.embedding(beam_tokens, embed),
                beam_hidden, (stable + lvl)[:, None].expand(B, K), ekv_k,
                ekv_v, stable + 1 + (lvl - 1) * K, mask)          # [B,K,H]
            v, t = top_k(logp(h), K)                              # [B,K,K]
            cand_scores = (beam_scores[:, :, None] + v).reshape(B, K * K)
            cand_tokens = t.reshape(B, K * K)
            base = 1 + K + (lvl - 1) * K * K
            cols = slice(base, base + K * K)
            pool_tokens[:, cols] = cand_tokens
            pool_parents[:, cols] = beam_pool_idx[:, parent_row]
            pool_scores[:, cols] = cand_scores
            pool_depth[:, cols] = lvl + 1
            # the next beam: the global top-K candidates
            beam_scores, bi = top_k(cand_scores, K)
            row = parent_row[bi]                                  # [B, K]
            beam_tokens = torch.gather(cand_tokens, 1, bi)
            beam_hidden = torch.gather(h, 1, row[..., None].expand(B, K, H))
            beam_pool_idx = base + bi
            anc = torch.gather(anc_now, 1, row[..., None].expand(
                B, K, tree_slots))
        # the best total + 1 nodes (root included), packed in (depth,
        # pool index) order: parents precede children
        _, sel = top_k(pool_scores, sel_n)
        key = torch.gather(pool_depth, 1, sel) * pool + sel
        sel = torch.gather(sel, 1, torch.argsort(key, dim=1))
        new_pos = torch.full((B, pool), -1, dtype=torch.int64, device=dev)
        new_pos.scatter_(1, sel, torch.arange(sel_n, device=dev).expand(
            B, sel_n))
        par = torch.gather(pool_parents, 1, sel)
        packed = torch.zeros((B, 2, M), dtype=torch.int32, device=dev)
        packed[:, 0, :sel_n] = torch.gather(pool_tokens, 1, sel).to(
            torch.int32)
        packed[:, 1, :sel_n] = torch.where(
            par >= 0, torch.gather(new_pos, 1, torch.clamp(par, min=0)),
            -1).to(torch.int32)
        packed[:, 1, sel_n:] = torch.arange(sel_n, M, dtype=torch.int32,
                                            device=dev)
        return packed

    return expand, tree_slots


class EagleDraftNet:
    """The draft net's state of an engine with ``model_cfg``, ``params``,
    ``device`` and ``S``: per slot the net KV ``ekv_k``/``ekv_v``
    ``[slots, KH, S + room, D]`` and the target's last hidden state
    ``last_hiddens`` ``[slots, H]``; the expansion, the prompt prefill and
    the extension with a step's accepted pairs."""

    def _init_eagle(self, net_params: Optional[Dict], slots: int, *,
                    depth: int, topk: int, total: int, M: int) -> None:
        dev = self.device
        self.net_cfg = EagleNetConfig.from_target(self.model_cfg)
        if net_params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            net_params = init_eagle_params(self.net_cfg, gen, device=dev)
        check_params_device(net_params, dev)
        self.net_params = net_params
        self.eagle_depth = depth
        self._expand, self.tree_slots = make_eagle_expand(
            self.net_cfg, self.model_cfg, depth=depth, topk=topk,
            total=total, M=M)
        # room past S for a stopped slot's scratch and extension
        self.ekv_k, self.ekv_v = init_eagle_kv(
            self.net_cfg, slots, self.S + max(M, self.tree_slots), dev)
        self.last_hiddens = torch.zeros(
            (slots, self.model_cfg.hidden_size), dtype=self.model_cfg.dtype,
            device=dev)

    def _max_accept(self) -> int:
        """A tree commits at most its depth + 1 tokens."""
        return self.eagle_depth + 1

    def _last_start(self, W: int) -> int:
        """One stream also stops where its tree scratch would pass S, as
        the reference's loop does."""
        return min(W - self.cfg.block, self.S - self.tree_slots)

    def _eagle_tree(self, hist_lens: torch.Tensor, starts: torch.Tensor):
        """Every slot's EAGLE-2 tree from its stable net KV (length
        ``hist_lens - 1``): (packed [B, 2, M], its buffers on the device:
        tree mask, depths, paths)."""
        packed = self._expand(self.net_params, self.params, self.ekv_k,
                              self.ekv_v, hist_lens - 1, self.last_hiddens,
                              starts)
        M = packed.shape[-1]
        return packed, unpack_draft_device(packed, M, self.eagle_depth)[1:]

    def _net_prefill(self, slot: int, tokens: torch.Tensor, true_len: int,
                     hidden: torch.Tensor) -> None:
        """The prompt's (token[1:], target hidden[:-1]) pairs into a fresh
        net KV of ``slot``; its last hidden state seeds the expansion."""
        self.ekv_k[slot].zero_()
        self.ekv_v[slot].zero_()
        n, dev = true_len - 1, self.device
        if n > 0:
            cols = torch.arange(self.ekv_k.shape[2], device=dev)
            pos = torch.arange(n, device=dev)
            eagle_forward(
                self.net_params, self.net_cfg,
                F.embedding(tokens[1:true_len].long()[None],
                            self.params["embed"]),
                hidden[None, :n], pos[None], self.ekv_k[slot:slot + 1],
                self.ekv_v[slot:slot + 1], pos[:1] * 0,
                (cols[None] <= pos[:, None])[None])
        self.last_hiddens[slot] = hidden[true_len - 1].to(
            self.last_hiddens.dtype)

    def _net_extend(self, hidden: torch.Tensor, hist_lens: torch.Tensor,
                    path_nodes: torch.Tensor, acc: torch.Tensor,
                    alens: torch.Tensor, lives: torch.Tensor) -> None:
        """After a verify: each slot's accepted pairs (embedding of
        ``acc[b, j]``, target hidden of path node j - 1, the last hidden
        before it for j = 0) at net positions ``hist_lens - 1 + j``.
        hidden [B, M, H] (the block's), hist_lens [B] before the step,
        path_nodes and acc [B, D], alens [B]; only live slots move their
        last hidden.  Rows past a slot's accept length are overwritten
        before any row reads them."""
        B, D = acc.shape
        H, dev = hidden.shape[-1], hidden.device
        path_hidden = torch.gather(hidden, 1, torch.clamp(
            path_nodes, min=0).long()[..., None].expand(B, D, H))
        prev = torch.cat([self.last_hiddens[:, None].to(hidden.dtype),
                          path_hidden[:, :-1]], dim=1)
        offs = torch.clamp(hist_lens - 1, min=0).to(torch.int64)
        pos = offs[:, None] + torch.arange(D, device=dev)[None]
        cols = torch.arange(self.ekv_k.shape[2], device=dev)
        eagle_forward(self.net_params, self.net_cfg,
                      F.embedding(acc.long(), self.params["embed"]), prev,
                      pos, self.ekv_k, self.ekv_v, offs,
                      cols[None, None] <= pos[..., None])
        last = torch.gather(path_hidden, 1, torch.clamp(
            alens - 1, min=0).long()[:, None, None].expand(B, 1, H))[:, 0]
        self.last_hiddens.copy_(torch.where(
            lives[:, None], last.to(self.last_hiddens.dtype),
            self.last_hiddens))           # in place: captured steps read it


@dataclass(frozen=True)
class FusedEagle2Config:
    depth: int = 5
    topk: int = 8
    total_tokens: int = 63
    steps_per_call: int = 256     # the most steps of one segment

    @property
    def block(self) -> int:       # verify block M = the tree
        return self.total_tokens + 1


class FusedEagle2Engine(EagleDraftNet, SingleStreamEngine):
    """EAGLE-2 tree decoding over one batch-1 cache, greedy or sampled by
    the request's tree accept rule (reference
    ``samd_tpu/eagle_fused.py:154-363``).  ``net_params=None`` draws a
    random net from a generator seeded 7; ``steps_per_call`` caps a
    segment (the reference's loop length); keyword arguments are
    ``fused_sam.SingleStreamEngine``'s."""

    def __init__(self, model_cfg: ModelConfig, params: Params, *,
                 net_params: Optional[Dict] = None, depth: int = 5,
                 topk: int = 8, total_tokens: int = 63,
                 steps_per_call: int = 256, **kwargs):
        super().__init__(model_cfg, params,
                         FusedEagle2Config(depth, topk, total_tokens,
                                           steps_per_call), **kwargs)
        self._init_eagle(net_params, 1, depth=depth, topk=topk,
                         total=total_tokens, M=self.cfg.block)

    def _observe_prompt(self, slot, tokens, true_len, logits, hidden):
        self._net_prefill(slot, tokens, true_len, hidden)

    def _accept_rule(self, sig: tuple):
        return make_accept_fn(sig)

    def _draw_noise(self, seeds, draws, mask, sig: tuple):
        M = self.cfg.block
        return draw_tree_noise(seeds, draws, mask, sig, M, M, M,
                               self.model_cfg.vocab_size)

    def _step(self, W, history, hist_len, start, budget, done, live, eos,
              accept=None, noise=None):
        """Expand, verify, accept, compact, extend, commit (reference
        body, ``samd_tpu/eagle_fused.py:270-318``); the contract of
        ``fused_sam.FusedSamEngine._step``: a step that is not ``live``
        compacts every row onto itself and keeps the net's last hidden
        state (its net KV rows past the stable length are scratch)."""
        M = self.cfg.block
        packed, (tree_mask, depths, paths) = self._eagle_tree(
            hist_len[None], start[None])
        draft = packed[:, 0]
        off = torch.clamp(hist_len, max=W - M)     # hist_len when live
        logits, hidden = forward(
            self.params, self.model_cfg, draft, depths + off,
            self.kv_k, self.kv_v, off,
            block_decode_mask(tree_mask[0], off, W))
        if accept is None:
            res = greedy_accept(logits[0], draft[0], paths[0])
        else:
            res = accept(logits, draft, paths, noise)
            res = type(res)(*(t[0] for t in res))
        pos = self._chain_pos[:res.path_nodes.shape[0]]
        path = torch.where(live, res.path_nodes, pos)
        compact_accepted(self.kv_k, off, path, M)
        compact_accepted(self.kv_v, off, path, M)
        acc = torch.clamp(res.accepted_tokens, min=0)
        is_eos = (acc == eos) & (pos < res.accept_len)
        any_eos = torch.any(is_eos)
        alen = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32)) + 1,
                           res.accept_len).to(torch.int32)
        self._net_extend(hidden, hist_len[None], res.path_nodes[None],
                         acc[None], alen[None], live[None])
        return self._commit(history, hist_len, start, budget, done, live,
                            acc, alen, any_eos, res.next_token)
