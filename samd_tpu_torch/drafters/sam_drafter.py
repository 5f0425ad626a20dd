"""SAM-based drafters and the adaptive draft-source selector (counterpart
of ``samd_tpu/drafters/sam_drafter.py``).

Implements both reference policies over the unified automaton engine:

  * ``sam_hybrid`` — SAM sequence draft when the (bias-adjusted) suffix match
    is at least ``len_threshold``, otherwise delegate to a model-based tree
    drafter (reference samd/draft.py:52-63).
  * ``sam_only``  — dynamic-SAM sequence draft vs static-SAM frequency-tree
    draft by direct match comparison, with adaptive draft length
    ``n = min(max_predicts, 1 + match * alpha)``
    (reference samd_sam_only/draft.py:49-59 and
    samd_sam_only/sam/dyn_sam.py:115-121).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import SamdConfig
from ..ops.treeops import pack_draft_host
from ..sam.automaton import SuffixAutomaton
from .base import Draft, Drafter


class AdaptiveSelector:
    """Owns the dynamic SAM, optional static corpus SAM and optional tree
    drafter; routes each step's draft per the configured policy."""

    def __init__(self, config: SamdConfig, *,
                 static_sam: Optional[SuffixAutomaton] = None,
                 tree_drafter: Optional[Drafter] = None):
        self.config = config
        if config.use_native_sam:
            # no fall back: a native engine that fails to build raises here
            from ..sam.native import NativeSuffixAutomaton
            dyn_cls = NativeSuffixAutomaton
        else:
            dyn_cls = SuffixAutomaton
        self.dyn = dyn_cls(track_text=True, track_counts=False)
        self.static = static_sam
        self.tree_drafter = tree_drafter
        if config.draft_source == "sam_hybrid" and tree_drafter is None:
            raise ValueError("sam_hybrid requires a tree_drafter")
        if self.static is not None and self.static._topk is None \
                and config.draft_source == "sam_only":
            self.static.finalize_topk(config.tree_topk)

    @property
    def wants_harvest(self) -> bool:
        return (self.tree_drafter is not None
                and getattr(self.tree_drafter, "wants_harvest", False))

    @property
    def wants_hidden(self) -> bool:
        return (self.tree_drafter is not None
                and getattr(self.tree_drafter, "wants_hidden", False))

    def observe_prompt_hidden(self, tokens, hidden) -> None:
        self.tree_drafter.observe_prompt_hidden(tokens, hidden)

    def observe_step_hidden(self, accepted, path_hidden, accept_len) -> None:
        self.tree_drafter.observe_step_hidden(accepted, path_hidden,
                                              accept_len)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self.dyn.reset()
        if self.static is not None:
            self.static.reset_cursor()
        if self.tree_drafter is not None:
            self.tree_drafter.reset()

    def observe_prompt(self, tokens: Sequence[int],
                       topk: Optional[np.ndarray] = None) -> None:
        self.dyn.feed(tokens, grow=True)
        if self.static is not None:
            self.static.feed(tokens, grow=False)
        if self.tree_drafter is not None:
            self.tree_drafter.observe_prompt(tokens, topk)

    def observe_accepted(self, tokens: Sequence[int]) -> None:
        self.dyn.feed(tokens, grow=True)
        if self.static is not None:
            self.static.feed(tokens, grow=False)
        if self.tree_drafter is not None:
            self.tree_drafter.observe_accepted(tokens)

    def observe_verify(self, block_tokens: np.ndarray, block_topk: np.ndarray,
                       num_nodes: int) -> None:
        if self.tree_drafter is not None:
            self.tree_drafter.observe_verify(block_tokens, block_topk,
                                             num_nodes)

    # ------------------------------------------------------------------
    def lookup(self, start_token: int) -> Draft:
        cfg = self.config
        s_dyn, m_dyn = self.dyn.peek(start_token)
        if self.static is not None:
            s_st, m_st = self.static.peek(start_token)
        else:
            s_st, m_st = 0, 0
        m_st_adj = m_st - cfg.len_bias

        if cfg.draft_source == "sam_hybrid":
            return self._hybrid(start_token, s_dyn, m_dyn, s_st, m_st_adj)
        return self._sam_only(start_token, s_dyn, m_dyn, s_st, m_st_adj)

    def _chain(self, seq, source: str) -> Draft:
        parents = np.arange(-1, len(seq) - 1, dtype=np.int32)
        packed = pack_draft_host(seq, parents, self.config.max_predicts)
        return Draft(packed=packed, num_nodes=len(seq), source=source)

    def _hybrid(self, start_token, s_dyn, m_dyn, s_st, m_st_adj) -> Draft:
        cfg = self.config
        if max(m_dyn, m_st_adj) >= cfg.len_threshold:
            if m_dyn >= m_st_adj:
                seq = self.dyn.sequence_draft(
                    s_dyn, start_token, cfg.n_predicts, widen=True)
                return self._chain(seq, "sam_dyn")
            seq = self.static.sequence_draft(
                s_st, start_token, cfg.n_predicts, widen=False)
            return self._chain(seq, "sam_static")
        return self.tree_drafter.lookup(start_token)

    def _sam_only(self, start_token, s_dyn, m_dyn, s_st, m_st_adj) -> Draft:
        cfg = self.config
        if m_dyn >= m_st_adj or self.static is None:
            n = min(cfg.max_predicts, 1 + int(m_dyn * cfg.alpha))
            seq = self.dyn.sequence_draft(s_dyn, start_token, n, widen=False)
            return self._chain(seq, "sam_dyn")
        n = min(cfg.max_predicts, 1 + int(m_st_adj * cfg.alpha))
        tokens, parents = self.static.tree_draft(
            s_st, start_token, n, cfg.tree_topk)
        packed = pack_draft_host(tokens, parents, cfg.max_predicts)
        return Draft(packed=packed, num_nodes=len(tokens),
                     source="sam_static")
