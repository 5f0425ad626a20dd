"""Shared pieces of the fused device-resident engines (counterpart of
``samd_tpu/fused_base.py:59-163``).

The corpus buffer and its n-gram index are explicit arguments of the
retrieval function, never captured in a closure (the reference's lesson of
edb6d83, fused_base.py:43-56).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .fused_sam import suffix_match
from .ops.ngram_index import NgramIndex, build_ngram_index
from .ops.ngram_index import indexed_suffix_match


def _retrieval_draft_argform(*, S: int, max_ngram: int, ext: int,
                             len_bias: int, block: int):
    """Returns ``draft(corpus, corpus_len, history, hist_len, start,
    corpus_index=None) -> (match [B], use_dyn [B], tokens [B, block],
    cont_avail [B])`` over a leading slot axis: history [B, S], hist_len
    and start [B]; the corpus [C], its 0-dim length and its optional
    ``ops.ngram_index.NgramIndex`` are shared by the slots.  With an index
    the corpus search is the index probe instead of the scan.  ``use_dyn``
    says the draft continues the slot's own history rather than the corpus
    (the history wins ties).  ``tokens[:, 0] == start``; positions past the
    available continuation hold the raw clamped gather, and callers apply
    their own length policy.  The single-stream engine calls it with
    B = 1."""
    Q = max_ngram
    M = block

    def draft(corpus, corpus_len, history, hist_len, start,
              corpus_index: Optional[NgramIndex] = None):
        dev = history.device
        hl = hist_len[:, None]                                   # [B, 1]

        def window(idx):
            return torch.where(idx >= 0, torch.gather(
                history, 1, torch.clamp(idx, 0, S - 1).long()), -1)

        query = window(hl - (Q - 1) + torch.arange(Q - 1, device=dev))
        query = torch.cat([query, start[:, None].to(query.dtype)], dim=1)
        tail = window(hl - (Q - 1) - ext + torch.arange(ext, device=dev))
        tail_len = torch.clamp(hist_len - (Q - 1), 0, ext)
        m_dyn, e_dyn = suffix_match(history, hist_len, query, tail,
                                    tail_len, max_ngram=Q, ext=ext)
        if corpus_index is not None:
            m_cor, e_cor = indexed_suffix_match(
                corpus, corpus_len, corpus_index, query, tail, tail_len,
                max_ngram=Q, ext=ext)
        else:
            m_cor, e_cor = suffix_match(corpus[None], corpus_len, query,
                                        tail, tail_len, max_ngram=Q, ext=ext)
        m_cor_adj = m_cor - len_bias
        use_dyn = m_dyn >= m_cor_adj
        match = torch.maximum(m_dyn, m_cor_adj)
        src = torch.where(use_dyn, e_dyn, e_cor)
        src_len = torch.where(use_dyn, hist_len, corpus_len)
        cidx = src[:, None] + 1 + torch.arange(M - 1, device=dev)
        cont = torch.where(
            use_dyn[:, None],
            torch.gather(history, 1, torch.clamp(cidx, 0, S - 1).long()),
            corpus[torch.clamp(cidx, 0, corpus.shape[0] - 1).long()])
        cont_avail = torch.clamp(src_len - (src + 1), 0, M - 1)
        tokens = torch.cat([start[:, None].to(cont.dtype), cont], dim=1
                           ).to(torch.int32)
        return match, use_dyn, tokens, cont_avail

    return draft


def build_optional_index(corpus, cfg, device: Union[str, torch.device]
                         ) -> Optional[NgramIndex]:
    """The corpus's ``NgramIndex`` on ``device`` for an ``indexed`` fused
    config, over the gram sizes that fit the ``max_ngram + ext`` window;
    None when the config is not indexed or the corpus is empty."""
    if not cfg.indexed or corpus is None or len(corpus) == 0:
        return None
    window = cfg.max_ngram + cfg.ext
    return build_ngram_index(
        np.asarray(corpus[:cfg.corpus_capacity], np.int32),
        grams=tuple(g for g in cfg.index_grams if g <= window),
        bucket_cap=cfg.index_bucket_cap, keep_latest=cfg.index_keep_latest,
        device=device)


def load_corpus_buffer(corpus, capacity: int,
                       device: Union[str, torch.device]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack an optional token list into the fixed-capacity device buffer
    (-1 padded) and its 0-dim int32 length."""
    buf = np.full((capacity,), -1, np.int32)
    n = 0
    if corpus is not None and len(corpus) > 0:
        n = min(len(corpus), capacity)
        buf[:n] = np.asarray(corpus[:n], np.int32)
    return (torch.from_numpy(buf).to(device),
            torch.tensor(n, dtype=torch.int32, device=device))


def pack_ctrl(*scalars: torch.Tensor) -> torch.Tensor:
    """Pack a fused loop's control scalars (hist_len, steps, done, ...)
    into one int32 vector: one device→host fetch reads them all."""
    return torch.stack([s.reshape(()).to(torch.int32) for s in scalars])


def finalize_generation(history: torch.Tensor, hist_len: int,
                        prompt_len: int, eos_token_id: int,
                        max_new_tokens: int) -> List[int]:
    """Fetch the committed history and apply the EOS/budget trim."""
    out = history[:hist_len].cpu().tolist()
    gen_part = out[prompt_len:]
    if eos_token_id in gen_part:
        gen_part = gen_part[:gen_part.index(eos_token_id) + 1]
    return out[:prompt_len] + gen_part[:max_new_tokens]


def init_history(input_ids: Sequence[int], S: int,
                 device: Union[str, torch.device]) -> torch.Tensor:
    """[S] int32 history buffer holding the prompt.  A prompt longer than
    S raises (JAX would clamp the write)."""
    if len(input_ids) > S:
        raise ValueError(f"prompt of {len(input_ids)} tokens > history {S}")
    history = torch.zeros((S,), dtype=torch.int32)
    history[:len(input_ids)] = torch.tensor(list(input_ids),
                                            dtype=torch.int32)
    return history.to(device)


def harvest_update(harvests: torch.Tensor, seens: torch.Tensor,
                   rows: torch.Tensor, topk: torch.Tensor) -> None:
    """The Token-Recycle harvest scatter, IN PLACE: for every slot b and
    block row t, ``harvests[b, rows[b, t]] = topk[b, t]`` and
    ``seens[b, rows[b, t]] = True``, then ``seens[:, V] = False``.

    harvests [B, V + 1, K] int32, seens [B, V + 1] bool, rows [B, T] int
    (V, the sink row, for rows that must not land: dead slots, invalid
    nodes, prefill padding), topk [B, T, K] (``engine.harvest_topk``).

    A block often holds one token at several rows.  The reference's
    ``.at[rows].set`` keeps the last of them on the CPU; a CUDA scatter
    promises no order.  Here the rule is explicit: the highest row index
    wins, and every duplicate writes that winner's values, so the scatter's
    order cannot matter."""
    B, V1, K = harvests.shape
    T = rows.shape[1]
    dev = rows.device
    r = rows.long()
    t = torch.arange(T, device=dev)
    same = r[:, :, None] == r[:, None, :]                        # [B, T, T]
    win = torch.where(same, t, -1).amax(dim=-1)                  # [B, T]
    vals = torch.gather(topk.to(torch.int32), 1,
                        win[:, :, None].expand(B, T, K))
    flat = (r + V1 * torch.arange(B, device=dev)[:, None]).reshape(-1)
    harvests.view(B * V1, K).index_copy_(0, flat, vals.reshape(B * T, K))
    seens.view(-1)[flat] = True
    seens[:, V1 - 1] = False

