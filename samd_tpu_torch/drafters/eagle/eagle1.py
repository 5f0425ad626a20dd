"""The EAGLE-1 drafter: static choice-tree drafts from the one-layer draft
net (counterpart of ``samd_tpu/drafters/eagle/eagle1.py``).

The tree's topology is fixed ahead of time (``rank_probability_tree``, or
``SamdConfig.tree_adjacency``) and relabelled so that each depth level is a
contiguous run of nodes.  Drafting walks it level by level on the device:
each node takes the rank-r prediction of its parent's draft-net output
(r = its place among the parent's children), and each level goes through
the draft net with the tree's ancestor mask, its K rows written at the
level's own columns after the stable prefix.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...engine import top_k
from ...models.configs import ModelConfig
from ...models.llama import _head
from ...ops.treeops import pack_draft_host
from ...sam.trees import ancestor_closure, node_depths
from ..base import Draft
from ..tree_topology import child_ranks, rank_probability_tree
from .drafter import EagleStableKV, random_net
from .net import EagleNetConfig, eagle_forward


class Eagle1Drafter(EagleStableKV):
    """Shares the stable-KV machinery of ``Eagle2Drafter``; only the
    expansion differs (a static topology instead of score selection)."""

    def __init__(self, net_params: Dict, net_cfg: EagleNetConfig,
                 model_cfg: ModelConfig, params: Dict, *, max_nodes: int,
                 parents: Optional[np.ndarray] = None, topk: int = 4,
                 max_draft_cache: int = 2048):
        if parents is None:
            parents = rank_probability_tree(26, branching=topk)
        parents = np.asarray(parents, np.int32)
        if len(parents) > max_nodes:
            raise ValueError("topology larger than verify block")
        # relabel in (depth, index) order: each level a contiguous run
        d = node_depths(parents)
        order = np.lexsort((np.arange(len(parents)), d))
        new_pos = np.empty(len(parents), np.int32)
        new_pos[order] = np.arange(len(parents), dtype=np.int32)
        relabeled = np.full(len(parents), -1, np.int32)
        for i, p in enumerate(parents):
            if p >= 0:
                relabeled[new_pos[i]] = new_pos[p]
        self.parents_np = relabeled
        self.n_nodes = len(parents)
        self.rank_topk = topk
        self.children = child_ranks(relabeled)
        self.node_depths = node_depths(relabeled)
        self.depth = int(self.node_depths.max())
        self._init_stable(net_params, net_cfg, model_cfg, params, max_nodes,
                          max_draft_cache, self.n_nodes)
        dev = self.device
        rank = np.zeros(self.n_nodes, np.int64)
        for childs in self.children:
            for r, c in enumerate(childs):
                rank[c] = r
        self._levels = []
        for dd in range(self.depth + 1):
            nodes = np.nonzero(self.node_depths == dd)[0]
            self._levels.append(tuple(torch.from_numpy(np.asarray(
                a, np.int64)).to(dev) for a in (nodes, relabeled[nodes],
                                                rank[nodes])))
        self._anc = torch.from_numpy(ancestor_closure(relabeled)).to(dev)
        self._packed = torch.from_numpy(pack_draft_host(
            np.zeros(self.n_nodes, np.int32), relabeled,
            max_nodes)).to(dev)

    def lookup(self, start_token: int) -> Draft:
        dev, N, S = self.device, self.n_nodes, self.kv_k.shape[2]
        stable = self.stable_len
        cols = torch.arange(S, device=dev)
        rel = torch.clamp(cols - stable, 0, N - 1)
        in_tree = (cols >= stable) & (cols < stable + N)
        tokens = torch.zeros(N, dtype=torch.int64, device=dev)
        tokens[0] = start_token
        hidden = torch.zeros((N, self.cfg.hidden_size), dtype=self.cfg.dtype,
                             device=dev)
        for dd, (nodes, par, rank) in enumerate(self._levels):
            if dd > 0:
                top = top_k(_head(hidden[par], self.params, self.model_cfg),
                            self.rank_topk)[1]                 # [n, K]
                tokens[nodes] = top[torch.arange(len(nodes), device=dev),
                                    rank]
                prev = hidden[par]
            else:
                prev = self.last_hidden[None]
            n = len(nodes)
            mask = (cols < stable)[None] | (in_tree[None] & torch.gather(
                self._anc[nodes], 1, rel[None].expand(n, S)))
            h = eagle_forward(
                self.net_params, self.cfg,
                F.embedding(tokens[nodes][None], self.params["embed"]),
                prev[None], torch.full((1, n), stable + dd, device=dev),
                self.kv_k, self.kv_v, stable + nodes[:1], mask[None])
            hidden[nodes] = h[0].to(hidden.dtype)
        packed = self._packed.clone()
        packed[0, :N] = tokens.to(torch.int32)
        return Draft(packed=packed, num_nodes=N, source="eagle",
                     depth=self.depth)


def make_eagle1(model_cfg: ModelConfig, params: Dict, samd_cfg, *,
                net_params: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> Eagle1Drafter:
    if net_params is None:
        net_params = random_net(model_cfg, params, generator)
    parents = None
    if samd_cfg.tree_adjacency is not None:
        from ...sam.trees import adjacency_to_parents
        parents = adjacency_to_parents(samd_cfg.tree_adjacency)
    return Eagle1Drafter(net_params, EagleNetConfig.from_target(model_cfg),
                         model_cfg, params, max_nodes=samd_cfg.max_predicts,
                         parents=parents)
