"""Token-Recycle drafter: trainless model-based tree drafts (counterpart of
``samd_tpu/drafters/token_recycle.py``).

Harvests the top-K next-token predictions for every token position the target
model ever scored (prefill + every verify block) and fills a static draft tree
with them: the i-th child of a node holds the rank-i prediction for the node's
token.  Reference: samd/tree_model/token_recycle/token_recycle.py.

Design (as in the reference package):
  * The token→top-K map is a dense ``[vocab, K]`` int32 numpy array plus a
    seen-bitmap, not a Python dict — updates are vectorized slice-assignments
    of the device-computed top-K harvest, ~free on the host.
  * The cache lives across requests (``reset`` is a no-op, as in the
    original), so two runs agree only when they serve requests in the same
    order.
  * The static tree's mask/positions/retrieve buffers are built once, padded
    to the engine's static (M, R, D); only the token vector changes per step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops.treeops import pack_draft_host
from .base import Draft
from .tree_topology import child_ranks, rank_probability_tree

TOPK = 8


class TokenRecycleDrafter:
    wants_harvest = True

    def __init__(self, vocab_size: int, *, parents: Optional[np.ndarray] = None,
                 max_nodes: int, max_paths: int = 0, max_depth: int = 0,
                 topk: int = TOPK):
        self.vocab_size = vocab_size
        self.topk = topk
        if parents is None:
            parents = rank_probability_tree(min(61, max_nodes),
                                            branching=topk)
        self.parents = parents
        self.children = child_ranks(parents)
        self.num_nodes = len(parents)
        # Static topology: pack once, rewrite only the token row per step.
        self._packed = pack_draft_host(
            np.zeros(self.num_nodes, np.int32), parents, max_nodes)
        self._cache = np.zeros((vocab_size, topk), dtype=np.int32)
        self._seen = np.zeros(vocab_size, dtype=bool)

    def reset(self) -> None:
        # Reference TokenRecycle.reset keeps its cache across requests
        # (samd/tree_model/token_recycle/token_recycle.py:33).
        pass

    def clear(self) -> None:
        self._cache[:] = 0
        self._seen[:] = False

    def harvest(self, tokens: np.ndarray, topk: np.ndarray) -> None:
        """tokens: [T] int; topk: [T, K] int — from prefill or verify logits."""
        t = np.asarray(tokens, dtype=np.int64)
        self._cache[t] = topk[:len(t), :self.topk]
        self._seen[t] = True

    # --- Drafter protocol -------------------------------------------------
    def observe_prompt(self, tokens: Sequence[int],
                       topk: Optional[np.ndarray] = None) -> None:
        if topk is not None:
            self.harvest(np.asarray(tokens), topk)

    def observe_accepted(self, tokens: Sequence[int]) -> None:
        pass

    def observe_verify(self, block_tokens: np.ndarray, block_topk: np.ndarray,
                       num_nodes: int) -> None:
        self.harvest(block_tokens[:num_nodes], block_topk[:num_nodes])

    def lookup(self, start_token: int) -> Draft:
        tokens, parents = self.fill_tree(start_token)
        packed = pack_draft_host(tokens, parents, self._packed.shape[1])
        return Draft(packed=packed, num_nodes=len(tokens),
                     source="token_recycle")

    def fill_tree(self, start_token: int):
        """Fill the static topology with harvested predictions, PRUNING
        subtrees under tokens with no harvest.  (The reference leaves such
        nodes as token 0, samd/tree_model/token_recycle/
        token_recycle.py:50-60 — wasted verify slots, and the duplicate
        0-token paths create accept-length ties whose bf16 tie-breaking can
        diverge from the AR baseline.)"""
        tokens = [start_token]
        parents = [-1]
        node_map = {0: 0}  # topology node -> emitted index
        for node in range(self.num_nodes):
            emitted = node_map.get(node)
            if emitted is None:
                continue
            tok = tokens[emitted]
            if not self._seen[tok]:
                continue
            preds = self._cache[tok]
            for rank, child in enumerate(self.children[node]):
                node_map[child] = len(tokens)
                tokens.append(int(preds[rank]))
                parents.append(emitted)
        return np.asarray(tokens, np.int32), np.asarray(parents, np.int32)
