"""Draft-tree buffers from a parent-index vector (counterpart of
``samd_tpu/ops/treeops.py``).

A draft is two int32 vectors, ``tokens`` and ``parents``, packed as
``[2, M]``.  The attention mask (ancestor closure), node depths and
root→node paths are derived from it on the host, where the host drafters
build it: the reference's ``lax.scan`` loops over M become one numpy pass
over the nodes, and the results come back as CPU tensors for one upload
each.  A draft built on the device (the EAGLE drafters') is unpacked there
by ``unpack_draft_device``, with no host read.  Their integers equal the
reference's.

Padding convention: padding node *i* has ``parents[i] == i`` (self-parent)
and sits after all real nodes; real nodes obey ``parents[i] < i`` and
``parents[0] == -1``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _host_parents(parents) -> np.ndarray:
    """A host tensor or array of parents as a [N, M] int64 numpy array."""
    if isinstance(parents, torch.Tensor):
        parents = parents.numpy()
    parents = np.asarray(parents, np.int64)
    return parents.reshape(-1, parents.shape[-1])


def _unpack_parents(P: np.ndarray, max_depth: int = 0):
    """[N, M] parents -> ([N, M, M] bool ancestor closure, [N, M] int32
    depths, [N, M, max_depth] int32 root->node paths padded with -1, or
    None without ``max_depth``), in one pass over the nodes: a node's row,
    depth and path extend its parent's.  A self-parent padding node reads
    its own row and depth before they are written (zero), so it sees only
    itself, gets depth 1 and the path [i, i], as in the reference.  Real
    nodes need depth < ``max_depth``."""
    N, M = P.shape
    n = np.arange(N)
    mask = np.zeros((N, M, M), bool)
    depth = np.zeros((N, M), np.int32)
    paths = (np.full((N, M, max_depth), -1, np.int32) if max_depth
             else None)
    for i in range(M):
        p = P[:, i]
        real = p >= 0
        pc = np.maximum(p, 0)
        mask[:, i] = mask[n, pc] & real[:, None]
        mask[:, i, i] = True
        d = np.where(real, depth[n, pc] + 1, 0)
        depth[:, i] = d
        if paths is not None:
            paths[:, i] = np.where(real[:, None], paths[n, pc], -1)
            paths[p == i, i, 0] = i
            ok = d < max_depth
            paths[n[ok], i, d[ok]] = i
    return mask, depth, paths


def tree_mask_from_parents(parents) -> torch.Tensor:
    """[..., M] int (host tensor or array) -> [..., M, M] bool
    ancestor-closure mask (self included)."""
    shape = tuple(parents.shape)
    mask, _, _ = _unpack_parents(_host_parents(parents))
    return torch.from_numpy(mask.reshape(shape + shape[-1:]))


def unpack_draft(draft, max_depth: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """draft: [..., 2, M] int on the host (tensor or array; row 0 tokens,
    row 1 parents) → CPU tensors (tokens [..., M], tree_mask [..., M, M],
    position_ids/depths [..., M], paths [..., M, D]), ready for one upload
    each.  A leading slot axis unpacks a batch's drafts in one pass."""
    if isinstance(draft, torch.Tensor):
        draft = draft.numpy()
    draft = np.asarray(draft)
    lead, M = draft.shape[:-2], draft.shape[-1]
    P = _host_parents(draft[..., 1, :])
    mask, depth, paths = _unpack_parents(P, max_depth)
    return (torch.from_numpy(np.ascontiguousarray(
                draft[..., 0, :], dtype=np.int32)),
            torch.from_numpy(mask.reshape(lead + (M, M))),
            torch.from_numpy(depth.reshape(lead + (M,))),
            torch.from_numpy(paths.reshape(lead + (M, max_depth))))


def unpack_draft_device(draft: torch.Tensor, max_depth: int, levels: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``unpack_draft`` of drafts [B, 2, M] on their own device, the same
    integers (``_unpack_parents``'s, padding included).  Real nodes sit at
    depth <= ``levels`` (< ``max_depth``): the ancestors k = 0 .. levels
    of every node come from ``levels`` batched gathers of the parents, and
    the mask, depths and paths from them, not from a loop over M.  A
    self-parented padding node is its own ancestor at every k, so it sees
    only itself, gets depth 1 and the path [i, i]."""
    tokens = draft[:, 0].to(torch.int32)
    parents = draft[:, 1].long()
    B, M = parents.shape
    idx = torch.arange(M, device=parents.device)
    anc = [idx.expand(B, M)]                  # anc[k][b, i]: k-th ancestor
    for _ in range(levels):
        prev = anc[-1]
        up = torch.gather(parents, 1, torch.clamp(prev, min=0))
        anc.append(torch.where(prev >= 0, up, -1))
    anc = torch.stack(anc)                                     # [k, B, M]
    depths = torch.where(parents == idx, 1, (anc[1:] >= 0).sum(0))
    mask = (anc[..., None] == idx).any(0)                      # [B, M, M]
    dist = depths[..., None] - torch.arange(max_depth, device=idx.device)
    rows = torch.gather(anc.permute(1, 2, 0), 2,
                        torch.clamp(dist, 0, levels))          # [B, M, D]
    paths = torch.where(dist >= 0, rows, -1)
    return (tokens, mask, depths.to(torch.int32), paths.to(torch.int32))


def pack_draft_host(tokens, parents, max_nodes: int) -> np.ndarray:
    """Host-side packing (numpy) of a draft into the [2, M] layout, padding
    with self-parent nodes."""
    n = len(tokens)
    if n > max_nodes:
        raise ValueError(f"draft has {n} nodes > max_nodes={max_nodes}")
    out = np.empty((2, max_nodes), np.int32)
    out[0, :n] = tokens
    out[0, n:] = 0
    out[1, :n] = parents
    out[1, n:] = np.arange(n, max_nodes)
    return out
