"""Configuration dataclasses (counterpart of ``samd_tpu/config.py``).

``GenerationConfig`` is a copy.  ``SamdConfig`` holds the policy knobs the
host engines and their drafters read (``samd_tpu/config.py:17-63``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional


@dataclass
class SamdConfig:
    """Speculative-decoding policy knobs read by ``engine.SamdEngine``, the
    batched engines and ``drafters.make_drafter``.

    draft_source:
      * "sam_hybrid" – SAM sequence drafts when the suffix match is long,
        otherwise a model-based tree drafter (Token Recycle, EAGLE-1 or
        EAGLE-2);
      * "sam_only"  – SAM drafts always: dynamic-SAM sequence draft vs
        static-SAM frequency tree by match-length comparison.
    """

    draft_source: Literal["sam_hybrid", "sam_only"] = "sam_only"

    # --- shared ---
    len_bias: int = 5            # distrust margin subtracted from static match
    max_predicts: int = 60       # verify-block size M

    # --- sam_hybrid knobs ---
    n_predicts: int = 40         # sequence-draft length for hybrid mode
    len_threshold: int = 5       # min match length to prefer SAM over the tree
    tree_method: Literal["token_recycle", "eagle", "eagle2"] = "token_recycle"
    tree_adjacency: Optional[list] = None   # static tree topology (BFS adjacency)

    # --- sam_only knobs ---
    alpha: float = 4.0           # adaptive draft length = 1 + match_len * alpha
    tree_topk: int = 8           # K: frequency-tree branching / per-depth cap

    # --- EAGLE-2 knobs (tree_method "eagle2") ---
    eagle_depth: int = 5
    eagle_topk: int = 8
    eagle_total_tokens: int = 63  # tree size = total_tokens + 1 (root)

    # --- verify shapes ---
    max_tree_paths: Optional[int] = None    # R; defaults to max_predicts
    max_tree_depth: Optional[int] = None    # D; defaults to max_predicts

    # --- host-engine knobs ---
    # the C++ SAM engine (built with g++ at first use; a failed build
    # raises); False asks for the Python automaton, which drafts the same
    use_native_sam: bool = True

    def __post_init__(self):
        if self.max_tree_paths is None:
            self.max_tree_paths = self.max_predicts
        if self.max_tree_depth is None:
            self.max_tree_depth = self.max_predicts


@dataclass
class GenerationConfig:
    """Per-request generation knobs (reference ``SamdGenerationConfig``)."""

    max_new_tokens: int = 512
    max_steps: int = 512
    max_cache_len: int = 2048
    greedy: bool = True
    temperature: float = 0.0
    top_p: float = 0.0
    top_k: int = 0
    seed: int = 0
    # Acceptance rule for sampling mode: "rejection", "typical", "nucleus"
    # (chain rules in the fused engines, tree rules in the host engines)
    accept_mode: Literal["rejection", "typical", "nucleus"] = "rejection"
    posterior_threshold: float = 0.3
    posterior_alpha: float = 0.09

    def __post_init__(self):
        if not self.greedy and self.temperature < 1e-5:
            raise ValueError("sampling requires temperature >= 1e-5")
        if self.accept_mode == "nucleus" and not self.greedy \
                and not (0.0 < self.top_p <= 1.0):
            raise ValueError("nucleus acceptance requires 0 < top_p <= 1")

    @property
    def sampling_signature(self) -> tuple:
        return (self.temperature, self.top_p, self.top_k, self.accept_mode,
                self.posterior_threshold, self.posterior_alpha)

