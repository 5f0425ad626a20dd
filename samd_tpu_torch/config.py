"""Configuration dataclasses (counterpart of ``samd_tpu/config.py``).

``GenerationConfig`` is a copy.  ``SamdConfig`` keeps the fields the greedy
``SamdEngine`` reads; the draft-source, tree-drafter and EAGLE knobs come
with the host drafters (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional


@dataclass
class SamdConfig:
    """Speculative-decoding policy knobs read by ``engine.SamdEngine``."""

    max_predicts: int = 60       # verify-block size M
    max_tree_depth: Optional[int] = None    # D; defaults to max_predicts

    def __post_init__(self):
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
    # (the fused engines run all three; the host SamdEngine raises on
    # sampling, ROADMAP queue 1 item 12)
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


def require_greedy(gen: GenerationConfig) -> None:
    """Only the host ``engine.SamdEngine`` (and its ``ArBaseline``) still
    decodes greedily: its tree sampling paths are ROADMAP queue 1 item 12.
    The fused engines sample."""
    if not gen.greedy:
        raise NotImplementedError(
            "SamdEngine's sampling paths are not ported yet (ROADMAP queue "
            "1 item 12); the fused engines sample")
