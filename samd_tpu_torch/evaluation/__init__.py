"""Evaluation pipeline (counterpart of ``samd_tpu/evaluation``): the
Spec-Bench-style runner, its speed and equality harnesses, a synthetic
question suite, text codecs, the trained-weights demos and the near-tie
auditor."""

from .equal import compare
from .runner import (
    IdentityCodec,
    Question,
    load_questions,
    reorg_answer_file,
    run_eval,
)
from .speed import (
    mean_accepted_tokens,
    mean_report,
    speedup,
    tokens_per_second,
)
from .synthetic import make_questions, write_questions

__all__ = [
    "Question", "load_questions", "run_eval", "IdentityCodec",
    "reorg_answer_file",
    "speedup", "tokens_per_second", "mean_accepted_tokens", "mean_report",
    "compare", "make_questions", "write_questions",
]
