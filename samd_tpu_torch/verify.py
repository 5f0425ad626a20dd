"""Greedy draft verification and the sampling warps (counterpart of
``samd_tpu/verify.py:31-135``).

For every root→node path of the draft tree, count the longest prefix where
each drafted token equals the model's argmax at its parent; accept the best
path plus one bonus token.  All on the device, with no host sync.

``_process_logits`` warps logits for sampling (temperature, then top-p,
then top-k) over any leading shape ``[..., V]``; the fused engines' chain
accept rules (``fused_sam.chain_sampling_accept``) read it.  The tree
sampling rules of ``SamdEngine`` are ROADMAP queue 1 item 12.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AcceptResult(NamedTuple):
    best_path: torch.Tensor       # 0-dim int32 — winning retrieve row
    accept_len: torch.Tensor      # 0-dim int32 — #accepted tokens (>= 1)
    path_nodes: torch.Tensor      # [D] int32 — block-relative node ids of
                                  #   the winning path (clamped where padded)
    accepted_tokens: torch.Tensor  # [D] int32 — tokens along that path
    next_token: torch.Tensor      # 0-dim int32 — argmax at the last node
    next_logits: torch.Tensor     # [V] f32 — that node's logits


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along axis 0 for a 0-dim index tensor, without the host sync
    that indexing with a tensor scalar costs."""
    return x.index_select(0, i.reshape(1).long())[0]


def greedy_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                  retrieve_indices: torch.Tensor) -> AcceptResult:
    """logits: [M, V] f32; draft_tokens: [M] int; retrieve_indices: [R, D]
    int (-1 padded).  Ties in argmax go to the first index, as in JAX."""
    argmax_tokens = torch.argmax(logits, dim=-1).to(torch.int32)  # [M]
    valid = retrieve_indices >= 0
    nodes = torch.clamp(retrieve_indices, min=0).long()           # [R, D]
    cand = draft_tokens.to(torch.int32)[nodes]                    # [R, D]
    pred = argmax_tokens[nodes]
    hit = (cand[:, 1:] == pred[:, :-1]) & valid[:, 1:]
    run = torch.cumprod(hit.to(torch.int32), dim=1).sum(dim=1)    # [R]
    # only rows anchored at the root are real paths
    run = torch.where(retrieve_indices[:, 0] == 0, run, -1).to(torch.int32)
    best = torch.argmax(run).to(torch.int32)
    accept_len = (take(run, best) + 1).to(torch.int32)
    path_nodes = take(nodes, best).to(torch.int32)
    last_node = take(path_nodes, accept_len - 1)
    return AcceptResult(
        best_path=best,
        accept_len=accept_len,
        path_nodes=path_nodes,
        accepted_tokens=take(cand, best),
        next_token=take(argmax_tokens, last_node),
        next_logits=take(logits, last_node),
    )


def _top_p_threshold(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Smallest KEPT logit of the nucleus (the smallest top set whose
    probability mass strictly exceeds ``top_p``), per row: ``[..., 1]``.

    Sort-free, as in the reference: bisection on the probability cut, 24
    halvings in f32 (the bracket reaches f32 epsilon around the cut), with
    strict ``>`` so a token whose preceding mass equals ``top_p`` is kept.
    When the argmax alone exceeds ``top_p`` the cut is the argmax's
    probability.  The threshold snaps to the smallest logit at or above the
    cut, so ties with it are kept."""
    probs = torch.softmax(logits, dim=-1)
    lo = torch.zeros(probs.shape[:-1] + (1,), dtype=probs.dtype,
                     device=probs.device)                  # mass(>= 0) = 1
    hi = probs.amax(dim=-1, keepdim=True)                  # the argmax only

    def mass(cut):
        return torch.where(probs >= cut, probs, 0.0).sum(dim=-1, keepdim=True)

    # invariant: mass(>= lo) > top_p >= mass(>= h), except when the argmax
    # alone exceeds top_p, where hi itself is the answer
    pmax_ok = mass(hi) > top_p
    h = hi
    for _ in range(24):
        mid = 0.5 * (lo + h)
        ok = mass(mid) > top_p                  # the cut can rise to mid
        lo, h = torch.where(ok, mid, lo), torch.where(ok, h, mid)
    cut = torch.where(pmax_ok, hi, lo)
    return torch.where(probs >= cut, logits, torch.inf).amin(dim=-1,
                                                              keepdim=True)


def _process_logits(logits: torch.Tensor, temperature: float, top_p: float,
                    top_k: int) -> torch.Tensor:
    """Temperature, then top-p, then top-k warping of ``[..., V]`` f32
    logits (the reference's order); cut tokens become -inf.  The k-th value
    of ``torch.topk`` stands in for ``lax.top_k``'s, and ``<`` keeps
    boundary ties."""
    if temperature >= 1e-5 and temperature != 1.0:
        logits = logits / temperature
    if 1e-8 <= top_p < 1.0:
        threshold = _top_p_threshold(logits, top_p)
        logits = torch.where(logits < threshold, -torch.inf, logits)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return logits
