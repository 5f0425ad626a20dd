"""Drafter interface for the host side of the decode loop (counterpart of
``samd_tpu/drafters/base.py``).

A drafter consumes the token stream (prompt + accepted generations) and the
per-step verify feedback, and produces a packed draft for the next verify
step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, Union

import numpy as np
import torch


@dataclass(frozen=True)
class Draft:
    """A drafter's proposal for one verify step, in the packed layout:
    ``packed[0]`` = node tokens, ``packed[1]`` = parent indices (-1 for the
    root, self-parent for padding nodes).  The mask, positions and retrieval
    paths are derived from it by ``ops.treeops.unpack_draft``; a draft
    built on the device (a torch tensor, the EAGLE drafters') by
    ``ops.treeops.unpack_draft_device``, over its ``depth`` levels."""
    packed: Union[np.ndarray, torch.Tensor]  # [2, M] int32
    num_nodes: int
    source: str  # e.g. "ar", "sam_dyn", "sam_static", "token_recycle"
    depth: Optional[int] = None   # a device draft's deepest real node


class Drafter(Protocol):
    """Host-side draft provider."""

    #: whether this drafter consumes the [M, K] top-K verify harvest
    #: (computing and fetching it costs a sort and a device→host copy per
    #: step)
    wants_harvest: bool = False

    def reset(self) -> None:
        """Start a new request."""

    def observe_prompt(self, tokens: Sequence[int],
                       topk: Optional[np.ndarray] = None) -> None:
        """Prompt tokens after prefill; ``topk`` is the [len(tokens), K]
        per-position top-k token harvest from the prefill logits."""

    def observe_accepted(self, tokens: Sequence[int]) -> None:
        """Tokens committed this step (start token + accepted draft)."""

    def observe_verify(self, block_tokens: np.ndarray, block_topk: np.ndarray,
                       num_nodes: int) -> None:
        """Full verify-block feedback: the M draft-block tokens and their
        [M, K] top-k continuations from the verify logits (the Token-Recycle
        harvest).  ``num_nodes`` bounds the real (non-padding) entries."""

    def lookup(self, start_token: int) -> Draft:
        """Produce the next draft given the sampled start token."""
