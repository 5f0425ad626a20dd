"""Token Recycle on the device (counterpart of
``samd_tpu/token_recycle_fused.py:44-251``).

Each step fills the static Token-Recycle tree level by level from the
``[V + 1, K]`` harvest table (``fused_hybrid.make_tr_draft``; a node under
a never-harvested token carries -1, which no argmax matches), verifies it
in one forward with the topology's constant mask, positions and
root-to-node paths, compacts the accepted path in the KV cache, and
scatters the block's top-K rows back into the table
(``fused_base.harvest_update``).  The prefill harvests every prompt row.
Greedy outputs equal ``engine.ArBaseline``'s on the CPU; on the card tree
rows attend their ancestors at other columns than a chain does
(docs/EXACTNESS.md), so a request may first differ at a near-tie.  The
harvest table persists across requests.  The request loop, with one
control read per step, is ``fused_sam.SingleStreamEngine``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .cache import compact_accepted
from .fused_hybrid import (HarvestTables, build_tr_topology,
                           constant_buffers, make_tr_draft)
from .fused_sam import SingleStreamEngine
from .models.configs import ModelConfig
from .models.llama import Params, block_decode_mask, forward
from .verify import greedy_accept


@dataclass(frozen=True)
class FusedTokenRecycleConfig:
    num_nodes: int = 61
    topk: int = 8

    @property
    def block(self) -> int:       # verify block M = the tree
        return self.num_nodes


class FusedTokenRecycleEngine(HarvestTables, SingleStreamEngine):
    """Greedy Token-Recycle tree decoding, one request at a time.  Keyword
    arguments are ``fused_sam.SingleStreamEngine``'s."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 tr_cfg: Optional[FusedTokenRecycleConfig] = None,
                 **kwargs):
        super().__init__(model_cfg, params,
                         tr_cfg or FusedTokenRecycleConfig(), **kwargs)
        parents, depths, _, rank = build_tr_topology(self.cfg.num_nodes,
                                                     self.cfg.topk)
        self.N = len(parents)
        dev = self.device
        # the constant verify buffers: ancestor mask, depths as positions,
        # root-to-node paths of max depth + 1
        self.tree_mask, self.positions, self.paths = (
            t.to(dev) for t in constant_buffers(parents,
                                                int(depths.max()) + 1))
        self._fill = make_tr_draft(parents, depths, rank, self.N, dev)
        self._init_harvest(1)
        self._live = torch.ones(1, dtype=torch.bool, device=dev)

    def _accept_rule(self, sig: tuple):
        raise NotImplementedError(f"{type(self).__name__} is greedy, as "
                                  "the reference's is")

    def _step(self, W, history, hist_len, start, budget, eos, accept=None,
              noise=None):
        """Fill, verify, accept greedily, compact, harvest, commit
        (reference body, ``samd_tpu/token_recycle_fused.py:185-221``)."""
        draft = self._fill(self.harvests, self.seens, start[None])  # [1, N]
        mask = block_decode_mask(self.tree_mask, hist_len, W)
        logits, _ = forward(self.params, self.model_cfg,
                            torch.clamp(draft, min=0),
                            (self.positions + hist_len)[None], self.kv_k,
                            self.kv_v, hist_len, mask)
        res = greedy_accept(logits[0], draft[0], self.paths)
        compact_accepted(self.kv_k, hist_len, res.path_nodes, self.N)
        compact_accepted(self.kv_v, hist_len, res.path_nodes, self.N)
        self._observe_block(logits, draft, self._live)
        acc = torch.clamp(res.accepted_tokens, min=0)
        pos = self._chain_pos[:acc.shape[0]]
        is_eos = (acc == eos) & (pos < res.accept_len)
        any_eos = torch.any(is_eos)
        alen = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32)) + 1,
                           res.accept_len).to(torch.int32)
        history.index_copy_(0, (hist_len + pos).long(), acc)
        budget = budget - alen
        return (hist_len + alen, res.next_token, budget,
                any_eos | (budget <= 0))
