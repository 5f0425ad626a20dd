"""Draft verification: greedy acceptance, the sampling warps and the tree
sampling rules (counterpart of ``samd_tpu/verify.py``).

Greedy: for every root→node path of the draft tree, count the longest
prefix where each drafted token equals the model's argmax at its parent;
accept the best path plus one bonus token.  All on the device, with no
host sync.

``_process_logits`` warps logits for sampling (temperature, then top-p,
then top-k) over any leading shape ``[..., V]``; the fused engines' chain
rules (``fused_sam.chain_sampling_accept``) and the tree rules here read
it.

Tree sampling rules (``make_accept_fn``): speculative rejection sampling
along tree paths (``sampling_accept``, which keeps the target
distribution), and the typical and nucleus posterior rules.  As in the
fused engines, the randomness is an explicit argument (``TreeNoise``),
drawn on the device from the request's counter-based stream
(``draw_tree_noise``, ``ops.request_noise``: a pure function of the seed,
the draw index and the element), so a request's stream depends only on
its seed and its own sampled steps.  Every rule takes a leading
slot axis: ``logits [..., M, V]``, ``draft_tokens [..., M]``,
``retrieve_indices [..., R, D]``.  A draft token of -1 (an invalid node of
the fused tree drafters, ``fused_hybrid``) is accepted by no rule: each
rule treats it as if the tree did not hold it.  The reference's typical
rule reads such a token's probability as token 0's and its rejection rule
as the last token's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .ops.request_noise import request_uniforms


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


def _lead_flat(logits, draft_tokens, retrieve_indices):
    """Leading axes flattened to one: ([N, M, V], [N, M] long, [N, R, D])
    and the leading shape."""
    lead = logits.shape[:-2]
    M, V = logits.shape[-2:]
    R, D = retrieve_indices.shape[-2:]
    return (lead, logits.reshape(-1, M, V),
            draft_tokens.reshape(-1, M).long(),
            retrieve_indices.reshape(-1, R, D))


def _path_tables(draft_tokens: torch.Tensor, retrieve_indices: torch.Tensor):
    """Shared per-path gathers over [N, ...]: (valid [N, R, D], nodes
    [N, R, D] long, cand [N, R, D] tokens along each row)."""
    N, R, D = retrieve_indices.shape
    valid = retrieve_indices >= 0
    nodes = torch.clamp(retrieve_indices, min=0).long()
    cand = torch.gather(draft_tokens, 1, nodes.reshape(N, R * D)
                        ).reshape(N, R, D)
    return valid, nodes, cand


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[n, i[n]]`` along axis 1 for each n (any trailing shape)."""
    idx = i.long().reshape(-1, 1, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, 1, *x.shape[2:]))[:, 0]


def _result(lead, best, accept_len, nodes, tokens, next_token, next_logits
            ) -> "AcceptResult":
    """An AcceptResult with the leading shape restored."""
    D = nodes.shape[-1]
    return AcceptResult(
        best_path=best.to(torch.int32).reshape(lead),
        accept_len=accept_len.to(torch.int32).reshape(lead),
        path_nodes=nodes.to(torch.int32).reshape(lead + (D,)),
        accepted_tokens=tokens.to(torch.int32).reshape(lead + (D,)),
        next_token=next_token.to(torch.int32).reshape(lead),
        next_logits=next_logits.reshape(lead + next_logits.shape[-1:]))


def greedy_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                  retrieve_indices: torch.Tensor) -> AcceptResult:
    """logits: [..., M, V] f32; draft_tokens: [..., M] int;
    retrieve_indices: [..., R, D] int (-1 padded).  Ties in argmax go to
    the first index, as in JAX."""
    lead, logits, draft_tokens, retrieve_indices = _lead_flat(
        logits, draft_tokens, retrieve_indices)
    argmax_tokens = torch.argmax(logits, dim=-1)                  # [N, M]
    valid, nodes, cand = _path_tables(draft_tokens, retrieve_indices)
    N, R, D = nodes.shape
    pred = torch.gather(argmax_tokens, 1, nodes.reshape(N, R * D)
                        ).reshape(N, R, D)
    hit = (cand[..., 1:] == pred[..., :-1]) & valid[..., 1:]
    run = torch.cumprod(hit.to(torch.int32), dim=-1).sum(dim=-1)  # [N, R]
    # only rows anchored at the root are real paths
    run = torch.where(retrieve_indices[..., 0] == 0, run, -1)
    best = torch.argmax(run, dim=-1)                              # [N]
    accept_len = _pick(run, best) + 1
    path_nodes = _pick(nodes, best)                               # [N, D]
    last_node = _pick(path_nodes, accept_len - 1)
    return _result(lead, best, accept_len, path_nodes, _pick(cand, best),
                   _pick(argmax_tokens, last_node),
                   _pick(logits, last_node))


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


# ----------------------------------------------------------------------
# Tree sampling rules, with explicit noise
# ----------------------------------------------------------------------

class TreeNoise(NamedTuple):
    """One step's randomness for the tree accept rules."""
    uniform: torch.Tensor   # [..., D, R] in [0, 1): rejection's test of
                            # row r's candidate at depth d
    gumbel: torch.Tensor    # [..., G, V] Gumbel(0, 1); the last row draws
                            # the bonus, nucleus's rows 0..M-1 its samples


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms in [0, 1) (clamped to f32's
    smallest normal, as ``jax.random.gumbel`` draws them)."""
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


def draw_first_token(seeds: torch.Tensor, last_logits: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """The first token after the prefill of each sampled request: a draw
    from ``softmax(last_logits / temperature)`` (``[B, V]`` f32) with the
    V uniforms of draw 0 of each request's stream (``seeds`` [B] int64, see
    ``ops.request_noise``); ``[B]`` int32.  No top-p or top-k here, as in
    the reference.  Decode steps draw 1, 2, ...."""
    draws = torch.zeros(seeds.shape, dtype=torch.int32, device=seeds.device)
    u = request_uniforms(seeds, draws, last_logits.shape[-1])
    return torch.argmax(last_logits / temperature + gumbel_from_uniform(u),
                        dim=-1).to(torch.int32)


def tree_noise_rows(sig: tuple, M: int) -> int:
    """G, the Gumbel rows a step of signature ``sig`` reads: M + 1 for the
    nucleus rule (one sample per node and the bonus), else 1."""
    return M + 1 if sig[3] == "nucleus" else 1


def draw_uniforms(seeds: torch.Tensor, draws: torch.Tensor,
                  mask: Optional[torch.Tensor], n: int) -> torch.Tensor:
    """``[B, n]`` uniforms in [0, 1): every slot draws at once, slot b
    draw ``draws[b]`` of its seed's stream (``ops.request_noise``), and a
    slot outside ``mask`` [B] bool (greedy, or not stepping) gets zeros.
    The caller advances ``draws`` where ``mask`` holds, so a slot's stream
    moves with its own sampled steps alone."""
    return request_uniforms(seeds, draws, n, mask)


def draw_tree_noise(seeds: torch.Tensor, draws: torch.Tensor,
                    mask: Optional[torch.Tensor], sig: tuple, M: int, R: int,
                    D: int, V: int) -> TreeNoise:
    """One step's noise for B slots (``draw_uniforms``, ``D * R + G * V``
    per slot): ``[B, D, R]`` uniforms and ``[B, G, V]`` Gumbel noise."""
    G = tree_noise_rows(sig, M)
    u = draw_uniforms(seeds, draws, mask, D * R + G * V)
    return TreeNoise(u[:, :D * R].reshape(-1, D, R),
                     gumbel_from_uniform(u[:, D * R:]).reshape(-1, G, V))


def _best_row_result(lead, logits_for_next, draft_tokens, retrieve_indices,
                     mask, likelihood, gumbel) -> AcceptResult:
    """Turn a per-(row, pos) acceptance mask into an AcceptResult, over
    [N, ...] (reference ``samd_tpu/verify.py:144-171``).

    mask: [N, R, D-1] accept mask for positions 1..D-1; likelihood:
    [N, R, D-1] per-position log-prob (tie-break among max-run rows,
    highest likelihood first); gumbel [N, V] draws the bonus from the last
    accepted node's row of ``logits_for_next``."""
    valid, nodes, cand = _path_tables(draft_tokens, retrieve_indices)
    runm = torch.cumprod(mask.to(torch.int32), dim=-1)
    run = runm.sum(dim=-1)                                      # [N, R]
    run = torch.where(retrieve_indices[..., 0] == 0, run, -1)
    best_run = run.amax(dim=-1, keepdim=True)
    lik = torch.where(runm > 0, likelihood, 0.0).sum(dim=-1)
    lik_key = torch.where(run == best_run, lik, -torch.inf)
    best = torch.argmax(lik_key, dim=-1)
    accept_len = torch.clamp(best_run[:, 0], min=0) + 1
    path_nodes = _pick(nodes, best)
    last_node = _pick(path_nodes, accept_len - 1)
    next_logits = _pick(logits_for_next, last_node)             # [N, V]
    bonus = torch.argmax(next_logits + gumbel, dim=-1)
    tokens = torch.where(_pick(valid, best), _pick(cand, best), 0)
    return _result(lead, best, accept_len, path_nodes, tokens, bonus,
                   next_logits)


def _parent_probs(probs, nodes, cand):
    """probs[n, nodes[n, r, d-1], cand[n, r, d]] for d >= 1: [N, R, D-1]."""
    N, R, D = nodes.shape
    V = probs.shape[-1]
    parent = nodes[..., :-1].reshape(N, -1)                     # [N, R(D-1)]
    tok = torch.clamp(cand[..., 1:], 0, V - 1).reshape(N, -1)
    flat = parent * V + tok
    return torch.gather(probs.reshape(N, -1), 1, flat).reshape(N, R, D - 1)


def typical_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                   retrieve_indices: torch.Tensor, noise: TreeNoise, *,
                   temperature: float, posterior_threshold: float = 0.3,
                   posterior_alpha: float = 0.09) -> AcceptResult:
    """Typical-sampling acceptance (Medusa-style): accept a drafted token
    when its parent-node probability clears min(posterior_threshold,
    exp(-entropy) * posterior_alpha); among longest-run rows pick the
    highest-likelihood one; the bonus is drawn from the last accepted
    node's tempered distribution (reference ``samd_tpu/verify.py:174-196``).
    """
    lead, logits, draft_tokens, retrieve_indices = _lead_flat(
        logits, draft_tokens, retrieve_indices)
    warped = logits / max(temperature, 1e-5)
    probs = torch.softmax(warped, dim=-1)                       # [N, M, V]
    entropy = -(probs * torch.log(probs + 1e-5)).sum(dim=-1)    # [N, M]
    thresh = torch.clamp(torch.exp(-entropy) * posterior_alpha,
                         max=posterior_threshold)
    valid, nodes, cand = _path_tables(draft_tokens, retrieve_indices)
    cand_prob = _parent_probs(probs, nodes, cand)
    parent_thresh = torch.gather(thresh, 1, nodes[..., :-1].reshape(
        nodes.shape[0], -1)).reshape(cand_prob.shape)
    mask = (cand_prob > parent_thresh) & valid[..., 1:] \
        & (cand[..., 1:] >= 0)
    lik = torch.log(torch.clamp(cand_prob, min=1e-20))
    return _best_row_result(lead, warped, draft_tokens, retrieve_indices,
                            mask, lik, noise.gumbel.reshape(
                                -1, *noise.gumbel.shape[-2:])[:, -1])


def nucleus_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                   retrieve_indices: torch.Tensor, noise: TreeNoise, *,
                   temperature: float, top_p: float) -> AcceptResult:
    """Nucleus (top-p) acceptance: one sample per draft node from its
    top-p-warped distribution (Gumbel rows 0..M-1); a drafted child is
    accepted iff it equals its parent's sample, so children of one parent
    share one draw (reference ``samd_tpu/verify.py:199-226``)."""
    lead, logits, draft_tokens, retrieve_indices = _lead_flat(
        logits, draft_tokens, retrieve_indices)
    N, M, V = logits.shape
    gumbel = noise.gumbel.reshape(N, -1, V)
    warped = _process_logits(logits / max(temperature, 1e-5), 1.0, top_p, 0)
    sampled = torch.argmax(warped + gumbel[:, :M], dim=-1)      # [N, M]
    valid, nodes, cand = _path_tables(draft_tokens, retrieve_indices)
    parent_sample = torch.gather(sampled, 1, nodes[..., :-1].reshape(
        N, -1)).reshape(cand[..., 1:].shape)
    mask = (cand[..., 1:] == parent_sample) & valid[..., 1:]
    probs = torch.softmax(warped, dim=-1)
    lik = torch.log(torch.clamp(_parent_probs(probs, nodes, cand),
                                min=1e-20))
    return _best_row_result(lead, warped, draft_tokens, retrieve_indices,
                            mask, lik, gumbel[:, M])


def sampling_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                    retrieve_indices: torch.Tensor, noise: TreeNoise, *,
                    temperature: float, top_p: float,
                    top_k: int) -> AcceptResult:
    """Speculative rejection sampling over tree paths (reference
    ``samd_tpu/verify.py:247-342``): walk the depth levels; at each level
    take the distinct next tokens of the still-matching rows in row order
    and accept token x with probability p(x) (the draft proposes
    deterministically, q = 1), else zero it out and renormalize.  At the
    first rejection the bonus is drawn from the residual distribution; if
    every level accepted, from the last node's warped distribution.

    The reference tests the candidates of a level one at a time; here a
    level's candidates are tested at once: candidate k, after the
    rejection of candidates 1..k-1, has probability p(x_k) / (1 - sum of
    their p) under the renormalized distribution, and the first candidate
    whose uniform falls below it is taken.  Up to rounding in the
    renormalization this is the reference's walk, draw for draw.  The test
    is ``u < p`` with u in [0, 1), true with probability p exactly (the
    reference's ``u <= p`` also takes a token of probability 0 when u is
    0, which the top-k cut of a point-mass request must never do)."""
    lead, logits, draft_tokens, retrieve_indices = _lead_flat(
        logits, draft_tokens, retrieve_indices)
    N, M, V = logits.shape
    R, D = retrieve_indices.shape[-2:]
    dev = logits.device
    valid, nodes, cand = _path_tables(draft_tokens, retrieve_indices)
    cand = torch.where(valid, cand, -1)
    probs = torch.softmax(_process_logits(logits, temperature, top_p, top_k),
                          dim=-1)                               # [N, M, V]
    uniform = noise.uniform.reshape(N, D, R)
    rows = torch.arange(R, device=dev)
    accept_len = torch.ones((N,), dtype=torch.int64, device=dev)
    best = torch.zeros((N,), dtype=torch.int64, device=dev)
    alive = valid[..., 0] & (retrieve_indices[..., 0] == 0)      # [N, R]
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    residual = torch.zeros((N, V), dtype=probs.dtype, device=dev)
    use_residual = torch.zeros((N,), dtype=torch.bool, device=dev)
    for i in range(1, D):
        parent = _pick(nodes[..., i - 1], best)                 # [N]
        p = _pick(probs, parent)                                # [N, V]
        toks = cand[..., i]                                     # [N, R]
        # a -1 node (an invalid draft node) is no candidate, as if the
        # tree did not hold it
        row_ok = alive & valid[..., i] & (toks >= 0)
        # each distinct token once, at its first alive row
        same = (toks[:, :, None] == toks[:, None, :]) & row_ok[:, None, :]
        first_row = torch.where(same, rows, R).amin(dim=-1)
        is_first = row_ok & (first_row == rows)
        px = torch.where(is_first, torch.gather(
            p, 1, torch.clamp(toks, min=0)), 0.0)               # [N, R]
        left = p.sum(dim=-1, keepdim=True) - (torch.cumsum(px, dim=-1) - px)
        take = is_first & (uniform[:, i] < px / torch.clamp(left, min=1e-20))
        accepted = take.any(dim=-1)
        row = torch.argmax(take.to(torch.int32), dim=-1)
        any_candidate = is_first.any(dim=-1)
        active = ~done & any_candidate
        acc = active & accepted
        best = torch.where(acc, row, best)
        row_tok = torch.gather(toks, 1, row[:, None])
        alive = torch.where(acc[:, None],
                            alive & (toks == row_tok) & valid[..., i], alive)
        accept_len = accept_len + acc.to(torch.int64)
        rejected_now = active & ~accepted
        # the residual after every candidate of this level was rejected
        cut = torch.zeros((N, V), dtype=torch.int32, device=dev).scatter_add(
            1, torch.clamp(toks, min=0), is_first.to(torch.int32))
        res = torch.where(cut > 0, 0.0, p)
        res = res / torch.clamp(res.sum(dim=-1, keepdim=True), min=1e-20)
        residual = torch.where(rejected_now[:, None], res, residual)
        use_residual = use_residual | rejected_now
        done = done | rejected_now | ~any_candidate
    path_nodes = _pick(nodes, best)
    last_node = _pick(path_nodes, accept_len - 1)
    final = torch.where(use_residual[:, None], residual,
                        _pick(probs, last_node))
    final_log = torch.log(torch.clamp(final, min=1e-20))
    bonus = torch.argmax(final_log + noise.gumbel.reshape(N, -1, V)[:, -1],
                         dim=-1)
    tokens = torch.where(_pick(valid, best), _pick(cand, best), 0)
    return _result(lead, best, accept_len, path_nodes, tokens, bonus,
                   final_log)


TreeAcceptFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                         TreeNoise], AcceptResult]


def make_accept_fn(sig: tuple) -> TreeAcceptFn:
    """Accept rule for a ``GenerationConfig.sampling_signature``
    ``(temperature, top_p, top_k, accept_mode, posterior_threshold,
    posterior_alpha)`` → ``fn(logits, draft_tokens, retrieve, noise)``."""
    temperature, top_p, top_k, mode, pthr, palpha = sig
    if mode == "typical":
        def typical(logits, draft_tokens, retrieve, noise):
            return typical_accept(logits, draft_tokens, retrieve, noise,
                                  temperature=temperature,
                                  posterior_threshold=pthr,
                                  posterior_alpha=palpha)
        return typical
    if mode == "nucleus":
        def nucleus(logits, draft_tokens, retrieve, noise):
            return nucleus_accept(logits, draft_tokens, retrieve, noise,
                                  temperature=temperature, top_p=top_p)
        return nucleus

    def rejection(logits, draft_tokens, retrieve, noise):
        return sampling_accept(logits, draft_tokens, retrieve, noise,
                               temperature=temperature, top_p=top_p,
                               top_k=top_k)
    return rejection
