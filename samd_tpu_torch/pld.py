"""Prompt-lookup decoding (PLD) on the device (counterpart of
``samd_tpu/pld.py:38-232``).

Each step drafts the continuation of the first occurrence of the longest
trailing n-gram (up to ``max_ngram`` tokens, ending with the start token)
in the request's own history, a vectorized window comparison over the
history buffer, and verifies it as a chain of ``n_predicts + 1`` tokens in
one forward.  Greedy: the accepted prefix matches the argmax, so the output
equals ``engine.ArBaseline(block_size=n_predicts + 1)``'s.  The request
loop is ``fused_sam.SingleStreamEngine``'s: segments of up to
``steps_per_call`` steps, replayed as a CUDA graph on the card, with one
control read per segment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .fused_sam import SingleStreamEngine, chain_tree_mask
from .models.configs import ModelConfig
from .models.llama import Params, block_decode_mask, forward
from .verify import take


@dataclass(frozen=True)
class PldConfig:
    """The reference PLD's defaults: max_matching_ngram_size 3,
    num_pred_tokens 10."""
    max_ngram: int = 3
    n_predicts: int = 10          # draft continuation length
    steps_per_call: int = 256     # the most steps of one segment

    @property
    def block(self) -> int:       # verify block M = start token + draft
        return self.n_predicts + 1


def pld_draft(history: torch.Tensor, hist_len: torch.Tensor,
              start_token: torch.Tensor, *, max_ngram: int, n_predicts: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first occurrence of the longest trailing n-gram (ending with
    ``start_token``) in ``history[:hist_len]`` and its continuation as a
    chain draft: (tokens [M] int32, 0-dim draft length), M = n_predicts +
    1; tokens past the draft length are the clamped gather's."""
    S = history.shape[0]
    G = max_ngram
    dev = history.device
    ar = torch.arange(S, device=dev)
    # windows[i, j] = history[i + j]
    windows = history[torch.clamp(ar[:, None] + torch.arange(G, device=dev),
                                  max=S - 1)]                       # [S, G]
    # the query: the last G - 1 history tokens, then the start token
    qidx = hist_len - G + 1 + torch.arange(G, device=dev)
    query = torch.where(qidx >= 0, history[torch.clamp(qidx, 0, S - 1)], -1)
    query = torch.cat([query[:-1], start_token.reshape(1).to(query.dtype)])
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    n_hit = torch.zeros((), dtype=torch.int64, device=dev)
    for n in range(G, 0, -1):
        hit = (windows[:, :n] == query[G - n:]).all(dim=1) \
            & (ar + n <= hist_len)
        take_n = hit.any() & (n_hit == 0)
        pos = torch.where(take_n, torch.argmax(hit.to(torch.int32)), pos)
        n_hit = torch.where(take_n, n, n_hit)
    cont_start = pos + n_hit
    cont_len = torch.where(
        n_hit > 0, torch.clamp(hist_len - cont_start, 0, n_predicts), 0)
    cont = history[torch.clamp(
        cont_start + torch.arange(n_predicts, device=dev), max=S - 1)]
    tokens = torch.cat([start_token.reshape(1).to(cont.dtype), cont])
    return tokens.to(torch.int32), (cont_len + 1).to(torch.int32)


class PldEngine(SingleStreamEngine):
    """Greedy prompt-lookup speculative decoding, one request at a time.
    Keyword arguments are ``fused_sam.SingleStreamEngine``'s."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 pld_cfg: Optional[PldConfig] = None, **kwargs):
        super().__init__(model_cfg, params, pld_cfg or PldConfig(),
                         **kwargs)

    def _accept_rule(self, sig: tuple):
        raise NotImplementedError(f"{type(self).__name__} is greedy, as "
                                  "the reference's is")

    def _step(self, W, history, hist_len, start, budget, done, live, eos,
              accept=None, noise=None):
        """Draft, verify the chain (block columns past the draft masked),
        accept the prefix matching the argmax, trim at EOS, commit; a no-op
        unless ``live`` (the contract of ``FusedSamEngine._step``)."""
        chain_pos, M = self._chain_pos, self.cfg.block
        draft, dlen = pld_draft(history, hist_len, start,
                                max_ngram=self.cfg.max_ngram,
                                n_predicts=self.cfg.n_predicts)
        off = torch.clamp(hist_len, max=W - M)     # hist_len when live
        mask = block_decode_mask(chain_tree_mask(dlen, M), off, W)
        logits, _ = forward(self.params, self.model_cfg, draft[None],
                            (chain_pos + off)[None], self.kv_k,
                            self.kv_v, off, mask)
        argmax_tok = torch.argmax(logits[0], dim=-1).to(torch.int32)
        hit = (draft[1:] == argmax_tok[:-1]) & (chain_pos[1:] < dlen)
        alen = torch.cumprod(hit.to(torch.int32), dim=0).sum() + 1
        is_eos = (draft == eos) & (chain_pos < alen)
        any_eos = torch.any(is_eos)
        alen = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32)) + 1,
                           alen).to(torch.int32)
        # the accepted chain prefix is already in place in the cache
        return self._commit(history, hist_len, start, budget, done, live,
                            draft, alen, any_eos, take(argmax_tok, alen - 1))
