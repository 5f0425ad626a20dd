"""Suffix-automaton engine for retrieval-based speculative decoding (a copy
of ``samd_tpu/sam/automaton.py``: host code, numpy and Python only).

This is the host-side heart of SAM-Decoding: an online suffix automaton (SAM)
over a token stream supporting O(1)-amortized longest-suffix-match queries and
continuation retrieval for draft generation.

Design notes (paths of the form ``samd/...`` are in the original
SAM-Decoding code base):
  * One engine class covers both the "dynamic" per-request automaton (built
    over prompt + generation) and the "static" corpus automaton (built offline,
    with occurrence counts and per-state top-k transitions for frequency-tree
    drafting).  The reference keeps four near-identical copies
    (``samd/sam/dyn_sam.py``, ``samd/sam/static_sam.py`` and their
    ``samd_sam_only`` variants); here the differences are configuration.
  * States live in parallel Python lists (structure-of-arrays) rather than a
    list of dataclass objects, so the automaton serializes to flat numpy/CSR
    arrays (see :mod:`samd_tpu_torch.sam.serialize`) and mirrors the C++ engine
    layout (``samd_tpu_torch/csrc/sam_engine.cpp``) byte-for-byte.
  * All positions are 0-based: ``first_end[s]`` is the index in ``text`` of the
    last token of the *first* occurrence of state ``s``'s strings.  (The
    reference uses 1-based ``min_endpos`` with a sentinel at ``input_ids[0]``,
    cf. samd/sam/dyn_sam.py:22.)

Behavioral parity targets (verified by tests/test_torch_sam.py against a brute-force
oracle and by construction):
  * match transfer          == reference ``transfer_state``
                               (samd/sam/dyn_sam.py:69-78)
  * suffix-link climbing    == reference ``to_anc``
                               (samd/sam/dyn_sam.py:99-105)
  * sequence draft          == reference ``gen_draft``
                               (samd/sam/dyn_sam.py:107-113 and
                                samd_sam_only/sam/dyn_sam.py:115-121)
  * occurrence counting     == reference ``cnt_endpos`` accumulation
                               (samd_sam_only/sam/static_sam.py:94-96)
  * frequency tree draft    == reference best-first search
                               (samd_sam_only/sam/static_sam.py:182-215)
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = 0
NO_LINK = -1


class SuffixAutomaton:
    """Online suffix automaton over an integer token alphabet.

    Parameters
    ----------
    track_text:
        Keep the raw token stream (required for continuation/sequence drafts;
        the dynamic per-request SAM needs this, a pure-frequency corpus SAM
        does not have to but it is cheap).
    track_counts:
        Maintain ``occ[s]`` = |endpos(s)| (number of occurrences of the
        state's strings) incrementally during construction.  Needed for
        frequency-tree drafting from a corpus SAM.
    """

    def __init__(self, *, track_text: bool = True, track_counts: bool = False):
        self.track_text = track_text
        self.track_counts = track_counts
        # Structure-of-arrays state storage.
        self._trans: List[Dict[int, int]] = [{}]  # state -> {token: state}
        self._link: List[int] = [NO_LINK]
        self._len: List[int] = [0]
        self._first_end: List[int] = [NO_LINK]  # 0-based end index of first occurrence
        self._occ: List[int] = [0]
        self._last = ROOT
        self.text: List[int] = []
        # Per-request match cursor: (state, matched length).
        self.cur_state = ROOT
        self.cur_length = 0
        # Populated by finalize_topk(): per-state transitions sorted by
        # child occurrence count, truncated to k.
        self._topk: Optional[List[List[Tuple[int, int]]]] = None

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return len(self._link)

    def __len__(self) -> int:
        return len(self.text)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    def _new_state(self, length: int, link: int, first_end: int, occ: int,
                   trans: Optional[Dict[int, int]] = None) -> int:
        self._trans.append({} if trans is None else dict(trans))
        self._link.append(link)
        self._len.append(length)
        self._first_end.append(first_end)
        self._occ.append(occ)
        return len(self._link) - 1

    def extend(self, token: int) -> None:
        """Append one token to the indexed stream (classic SAM extension)."""
        pos = len(self.text)
        if self.track_text:
            self.text.append(token)
        else:
            self.text.append(0)  # keep len(self.text) meaningful
        cur = self._new_state(pos + 1, NO_LINK, pos, 0)
        p = self._last
        trans = self._trans
        while p != NO_LINK and token not in trans[p]:
            trans[p][token] = cur
            p = self._link[p]
        if p == NO_LINK:
            self._link[cur] = ROOT
        else:
            q = trans[p][token]
            if self._len[p] + 1 == self._len[q]:
                self._link[cur] = q
            else:
                # Clone q with a shorter length; inherits q's transitions,
                # first_end and occurrence count (reference copies them via
                # deepcopy, samd/sam/dyn_sam.py:61).
                clone = self._new_state(
                    self._len[p] + 1, self._link[q],
                    self._first_end[q], self._occ[q], trans[q],
                )
                while p != NO_LINK and trans[p].get(token) == q:
                    trans[p][token] = clone
                    p = self._link[p]
                self._link[q] = clone
                self._link[cur] = clone
        self._last = cur
        if self.track_counts:
            # Every suffix of the current prefix occurs at `pos`; those are
            # exactly the states on the suffix-link path of `cur`.
            s = cur
            while s != ROOT:
                self._occ[s] += 1
                s = self._link[s]

    # ------------------------------------------------------------------
    # Matching
    # ------------------------------------------------------------------
    def match_step(self, state: int, length: int, token: int) -> Tuple[int, int]:
        """Advance a (state, length) match by one token, following suffix
        links on mismatch.  Pure function of the automaton."""
        trans = self._trans
        while state != ROOT and token not in trans[state]:
            state = self._link[state]
            length = self._len[state]
        nxt = trans[state].get(token)
        if nxt is None:
            return ROOT, 0
        return nxt, length + 1

    def peek(self, token: int) -> Tuple[int, int]:
        """Longest-suffix match if `token` were appended to the query stream.
        Does not move the cursor (the reference calls this ``lookup``)."""
        return self.match_step(self.cur_state, self.cur_length, token)

    def advance_cursor(self, token: int) -> None:
        self.cur_state, self.cur_length = self.match_step(
            self.cur_state, self.cur_length, token)

    def feed(self, tokens: Sequence[int], *, grow: bool) -> None:
        """Advance the cursor over `tokens`; if `grow`, also index them.

        ``grow=True``  == reference ``add_tokens``  (dynamic SAM update)
        ``grow=False`` == reference ``transfer_tokens`` (static SAM cursor)
        """
        if grow:
            for t in tokens:
                self.advance_cursor(t)
                self.extend(t)
        else:
            for t in tokens:
                self.advance_cursor(t)

    def reset_cursor(self) -> None:
        self.cur_state = ROOT
        self.cur_length = 0

    def reset(self) -> None:
        """Drop the index entirely (per-request dynamic SAM reset)."""
        self._trans = [{}]
        self._link = [NO_LINK]
        self._len = [0]
        self._first_end = [NO_LINK]
        self._occ = [0]
        self._last = ROOT
        self.text = []
        self._topk = None
        self.reset_cursor()

    # ------------------------------------------------------------------
    # Sequence drafting (continuation retrieval)
    # ------------------------------------------------------------------
    def widen_for_continuation(self, state: int, min_tokens: int) -> int:
        """Climb suffix links (shortening the match) until at least
        `min_tokens` tokens follow the state's first occurrence, or the next
        hop would reach the root.  Reference ``to_anc``
        (samd/sam/dyn_sam.py:99-105)."""
        if state == ROOT:
            return state
        remaining = len(self.text) - 1 - self._first_end[state]
        while self._link[state] != ROOT and remaining < min_tokens:
            state = self._link[state]
            remaining = len(self.text) - 1 - self._first_end[state]
        return state

    def continuation(self, state: int, n: int) -> List[int]:
        """Up to `n` tokens that followed the first occurrence of `state`."""
        if not self.track_text:
            raise RuntimeError("continuation requires track_text=True")
        start = self._first_end[state] + 1
        return self.text[start:start + n]

    def sequence_draft(self, state: int, start_token: int, n_predicts: int,
                       *, widen: bool = False, pad: bool = False) -> List[int]:
        """Draft = [start_token] + continuation, at most `n_predicts` long.

        ``widen=True, pad=True``   == hybrid-variant semantics
            (samd/sam/dyn_sam.py:107-113: climbs to_anc and
             zero-pads to exactly n_predicts)
        ``widen=False, pad=False`` == sam_only-variant semantics
            (samd_sam_only/sam/dyn_sam.py:115-121: adaptive
             length, no padding)
        """
        if widen:
            state = self.widen_for_continuation(state, n_predicts)
        draft = [start_token] + self.continuation(state, n_predicts - 1)
        if pad and len(draft) < n_predicts:
            draft.extend([0] * (n_predicts - len(draft)))
        return draft

    # ------------------------------------------------------------------
    # Frequency-tree drafting (corpus SAM)
    # ------------------------------------------------------------------
    def finalize_topk(self, k: int = 8) -> None:
        """Precompute per-state transitions ordered by child occurrence count
        (descending), truncated to `k`.  Reference ``init_topk_next``
        (samd_sam_only/sam/static_sam.py:137-146)."""
        occ = self._occ
        # Deterministic tie-break: count descending, then token ascending
        # (the reference relies on dict insertion order,
        # samd_sam_only/sam/static_sam.py:140-145; a value
        # order makes Python and C++ engines bit-identical).
        self._topk = [
            sorted(t.items(), key=lambda kv: (-occ[kv[1]], kv[0]))[:k]
            for t in self._trans
        ]

    def tree_draft(self, state: int, start_token: int, n_nodes: int,
                   k: int) -> Tuple[List[int], List[int]]:
        """Best-first expansion of the automaton into a draft tree.

        Nodes are expanded in decreasing path probability, where an edge's
        probability is occ(child)/occ(parent); at most `k` nodes are kept per
        depth and at most `n_nodes` in total.  Returns ``(tokens, parents)``
        with ``parents[0] == -1``.  Reference ``gen_draft``
        (samd_sam_only/sam/static_sam.py:182-215)."""
        if self._topk is None:
            self.finalize_topk(k)
        tokens: List[int] = []
        parents: List[int] = []
        depth_budget: Dict[int, int] = {}
        # heap entries: (-prob, tiebreak, token, state, parent_node, depth)
        counter = 0
        heap: List[Tuple[float, int, int, int, int, int]] = [
            (-1.0, counter, start_token, state, -1, 0)]
        while tokens_left := (n_nodes - len(tokens)):
            if not heap:
                break
            neg_prob, _, token, s, parent, depth = heapq.heappop(heap)
            used = depth_budget.get(depth, 0)
            if used >= k:
                continue
            depth_budget[depth] = used + 1
            node = len(tokens)
            tokens.append(token)
            parents.append(parent)
            if tokens_left == 1:
                break
            # Root keeps occ=0 (its "string" is empty); guard the ratio so a
            # root-anchored draft is still well-defined.
            denom = max(self._occ[s], 1)
            for child_token, child_state in self._topk[s][:k]:
                counter += 1
                p = (-neg_prob) * (self._occ[child_state] / denom)
                heapq.heappush(heap, (-p, counter, child_token, child_state,
                                      node, depth + 1))
        return tokens, parents

    # ------------------------------------------------------------------
    # Corpus building
    # ------------------------------------------------------------------
    def index_corpus(self, sequences: Sequence[Sequence[int]],
                     eos_token: int) -> None:
        """Index a corpus, terminating every sequence with `eos_token`
        (reference ``add_batch_tokens``,
        samd/sam/static_sam.py:32-36)."""
        for seq in sequences:
            self.feed(seq, grow=True)
            if len(seq) == 0 or seq[-1] != eos_token:
                self.feed([eos_token], grow=True)


class SamCursor:
    """Per-request cursor over a shared (read-only) automaton.

    Continuous batching runs many requests against ONE corpus SAM; the
    automaton index is immutable at serving time, only the match cursor is
    per-request.  Duck-types the cursor/drafting subset of SuffixAutomaton
    that AdaptiveSelector uses (works over both the Python and C++ engines —
    both expose a stateless ``match_step``)."""

    def __init__(self, sam):
        self.sam = sam
        self.cur_state = ROOT
        self.cur_length = 0

    def reset_cursor(self) -> None:
        self.cur_state = ROOT
        self.cur_length = 0

    def peek(self, token: int) -> Tuple[int, int]:
        return self.sam.match_step(self.cur_state, self.cur_length, token)

    def advance_cursor(self, token: int) -> None:
        self.cur_state, self.cur_length = self.sam.match_step(
            self.cur_state, self.cur_length, token)

    def feed(self, tokens: Sequence[int], *, grow: bool) -> None:
        if grow:
            raise ValueError("SamCursor is read-only; cannot grow the index")
        for t in tokens:
            self.advance_cursor(t)

    def sequence_draft(self, state, start_token, n_predicts, *, widen=False,
                       pad=False):
        return self.sam.sequence_draft(state, start_token, n_predicts,
                                       widen=widen, pad=pad)

    def tree_draft(self, state, start_token, n_nodes, k):
        return self.sam.tree_draft(state, start_token, n_nodes, k)

    def finalize_topk(self, k: int = 8) -> None:
        self.sam.finalize_topk(k)

    @property
    def _topk(self):
        return self.sam._topk


def build_corpus_sam(sequences: Sequence[Sequence[int]], eos_token: int,
                     *, topk: int = 8) -> SuffixAutomaton:
    """Build a static corpus SAM with occurrence counts and top-k tables."""
    sam = SuffixAutomaton(track_text=True, track_counts=True)
    sam.index_corpus(sequences, eos_token)
    sam.finalize_topk(topk)
    sam.reset_cursor()
    return sam
