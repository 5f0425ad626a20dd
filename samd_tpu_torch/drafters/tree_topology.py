"""Static draft-tree topology generation (a copy of
``samd_tpu/drafters/tree_topology.py``; ``samd/...`` paths are in the
original SAM-Decoding code base).

The reference ships hand-designed BFS adjacency JSONs
(samd/config/token_recycle.json, 61 nodes; loaded at
samd/samd_config.py:69-81).  Instead of shipping opaque
hand-edited topologies, we *derive* them: assume the drafter's rank-r
suggestion is correct with probability ∝ (r+1)^-beta, score every candidate
node by the product of rank-probabilities along its root path, and keep the
``num_nodes`` highest-scoring nodes.  Best-first expansion guarantees parents
are selected before children, yielding a valid tree in BFS-ish order.  With
the default parameters this reproduces the qualitative shape of the
reference's tree (wide at the root, rapidly narrowing with depth).
"""

from __future__ import annotations

import heapq
import json
from typing import List, Tuple

import numpy as np


def rank_probability_tree(num_nodes: int = 61, *, branching: int = 8,
                          max_depth: int = 10,
                          beta: float = 2.0) -> np.ndarray:
    """Return a parent-index array for the top-``num_nodes`` tree under the
    rank-probability model."""
    rank_p = (np.arange(1, branching + 1, dtype=np.float64)) ** (-beta)
    rank_p /= rank_p.sum()
    parents: List[int] = [-1]
    depths: List[int] = [0]
    # heap of (-score, tiebreak, parent_node, rank)
    counter = 0
    heap: List[Tuple[float, int, int, int]] = []
    for r in range(branching):
        heapq.heappush(heap, (-rank_p[r], counter, 0, r))
        counter += 1
    scores = [1.0]
    while len(parents) < num_nodes and heap:
        neg_score, _, parent, rank = heapq.heappop(heap)
        node = len(parents)
        parents.append(parent)
        depths.append(depths[parent] + 1)
        scores.append(-neg_score)
        if depths[node] < max_depth:
            for r in range(branching):
                counter += 1
                heapq.heappush(
                    heap, (neg_score * rank_p[r], counter, node, r))
    return np.asarray(parents, dtype=np.int32)


def child_ranks(parents: np.ndarray) -> List[List[int]]:
    """children-of-node lists in node order; the i-th child of a node is
    filled with the drafter's rank-i suggestion."""
    adj: List[List[int]] = [[] for _ in parents]
    for i, p in enumerate(parents):
        if p >= 0:
            adj[p].append(i)
    return adj


def save_topology(parents: np.ndarray, path: str) -> None:
    adj = child_ranks(parents)
    with open(path, "w") as f:
        json.dump({"tree_adj": {str(i): c for i, c in enumerate(adj)}}, f)


def load_topology(path: str) -> np.ndarray:
    """Load a BFS adjacency JSON (same schema as the reference's
    config/token_recycle.json) into a parent array."""
    with open(path) as f:
        adj_dict = json.load(f)["tree_adj"]
    n = len(adj_dict)
    parents = np.full(n, -1, dtype=np.int32)
    for node_str, children in adj_dict.items():
        for c in children:
            parents[c] = int(node_str)
    return parents
