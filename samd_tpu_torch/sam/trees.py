"""Draft-tree buffer construction (a copy of ``samd_tpu/sam/trees.py``).

A draft tree is described by a parent-index array ``parents`` (``parents[0] ==
-1`` for the root).  Verification needs three device buffers derived from it:

  * ``attn_mask[i, j]``      – node *i* may attend to node *j* (ancestor
                                closure, including self)
  * ``position_ids[i]``      – depth of node *i* (added to the cache offset)
  * ``retrieve_indices[r,d]``– node indices along the root→leaf path of leaf
                                *r*, padded with -1

These mirror the original SAM-Decoding code's buffers
(samd/tree_model/token_recycle/utils.py:37-99 for static BFS
trees and samd_sam_only/sam/dyn_sam.py:123-155 for dynamic
parent-array trees) but are computed vectorized in numpy and padded to static
shapes so one decode step serves every draft source.

The engine unifies sequences and trees: a sequence draft is simply a chain
tree (``parents[i] = i-1``), so one verify kernel handles both (the reference
keeps separate ``seq_decode``/``tree_decode`` forward paths,
samd/samd_model.py:140-147).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class TreeBuffers:
    """Host-side (numpy) draft buffers, padded to static shapes.

    Shapes: tokens [M], attn_mask [M, M] bool, position_ids [M] int32,
    retrieve_indices [R, D] int32 (-1 padded), plus the true node count.
    Padding nodes are parented to the root with position 0 and a self-only
    mask row; they are excluded from every retrieval path, so they can never
    be accepted.
    """

    tokens: np.ndarray
    attn_mask: np.ndarray
    position_ids: np.ndarray
    retrieve_indices: np.ndarray
    num_nodes: int


def ancestor_closure(parents: np.ndarray) -> np.ndarray:
    """Boolean [n, n] matrix: mask[i, j] = j is an ancestor of i (or i==j)."""
    n = len(parents)
    mask = np.eye(n, dtype=bool)
    for i in range(1, n):
        p = parents[i]
        if p >= 0:
            mask[i] |= mask[p]
    return mask


def node_depths(parents: np.ndarray) -> np.ndarray:
    n = len(parents)
    depth = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        p = parents[i]
        if p >= 0:
            depth[i] = depth[p] + 1
    return depth


def leaf_paths(parents: np.ndarray, *, reverse_leaf_order: bool = False,
               pad_to_depth: Optional[int] = None,
               pad_to_rows: Optional[int] = None) -> np.ndarray:
    """Root→leaf node-index paths, one row per leaf, -1 padded.

    ``reverse_leaf_order=True`` reproduces the static-tree buffer ordering of
    the reference (leaves emitted last-first,
    samd/tree_model/token_recycle/utils.py:92); dynamic SAM
    trees use natural order
    (samd_sam_only/sam/dyn_sam.py:139-151).  The order only
    matters for tie-breaking among equally long accepted paths.
    """
    n = len(parents)
    has_child = np.zeros(n, dtype=bool)
    for i in range(1, n):
        if parents[i] >= 0:
            has_child[parents[i]] = True
    leaves = [i for i in range(n) if not has_child[i]]
    if reverse_leaf_order:
        leaves = leaves[::-1]
    paths: List[List[int]] = []
    for leaf in leaves:
        path = []
        x = leaf
        while x != -1:
            path.append(x)
            x = int(parents[x])
        paths.append(path[::-1])
    depth = max(len(p) for p in paths)
    if pad_to_depth is not None:
        if depth > pad_to_depth:
            raise ValueError(f"tree depth {depth} exceeds pad_to_depth={pad_to_depth}")
        depth = pad_to_depth
    rows = len(paths)
    if pad_to_rows is not None:
        if rows > pad_to_rows:
            raise ValueError(f"{rows} leaves exceed pad_to_rows={pad_to_rows}")
        rows = pad_to_rows
    out = np.full((rows, depth), -1, dtype=np.int32)
    for r, p in enumerate(paths):
        out[r, :len(p)] = p
    return out


def build_tree_buffers(tokens: Sequence[int], parents: Sequence[int], *,
                       max_nodes: int, max_paths: int, max_depth: int,
                       reverse_leaf_order: bool = False) -> TreeBuffers:
    """Pad a (tokens, parents) draft tree into static-shape verify buffers."""
    n = len(tokens)
    if n > max_nodes:
        raise ValueError(f"tree has {n} nodes > max_nodes={max_nodes}")
    parr = np.asarray(parents, dtype=np.int32)
    mask = np.zeros((max_nodes, max_nodes), dtype=bool)
    mask[:n, :n] = ancestor_closure(parr)
    # Padding nodes see only themselves (keeps softmax well-defined).
    idx = np.arange(n, max_nodes)
    mask[idx, idx] = True
    pos = np.zeros(max_nodes, dtype=np.int32)
    pos[:n] = node_depths(parr)
    retrieve = leaf_paths(parr, reverse_leaf_order=reverse_leaf_order,
                          pad_to_depth=max_depth, pad_to_rows=max_paths)
    toks = np.zeros(max_nodes, dtype=np.int32)
    toks[:n] = np.asarray(tokens, dtype=np.int32)
    return TreeBuffers(tokens=toks, attn_mask=mask, position_ids=pos,
                       retrieve_indices=retrieve, num_nodes=n)


def chain_buffers(tokens: Sequence[int], *, max_nodes: int,
                  max_depth: int, max_paths: int = 1) -> TreeBuffers:
    """Buffers for a sequence draft: a single root→leaf chain.

    ``max_paths`` lets callers pad the retrieve matrix to the same static row
    count as tree drafts, so every draft source shares one compiled step."""
    n = len(tokens)
    parents = np.arange(-1, n - 1, dtype=np.int32)
    return build_tree_buffers(tokens, parents, max_nodes=max_nodes,
                              max_paths=max_paths, max_depth=max_depth)


def adjacency_to_parents(adjacency: Sequence[Sequence[int]]) -> np.ndarray:
    """Convert a BFS adjacency list (node -> children ids) to a parent array.

    This is the on-disk topology format of the reference's static trees
    (samd/config/token_recycle.json, loaded at
    samd/samd_config.py:69-81)."""
    n = len(adjacency)
    parents = np.full(n, -1, dtype=np.int32)
    for node, children in enumerate(adjacency):
        for c in children:
            parents[c] = node
    return parents


def parents_to_adjacency(parents: Sequence[int]) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in parents]
    for i, p in enumerate(parents):
        if p >= 0:
            adj[p].append(i)
    return adj
