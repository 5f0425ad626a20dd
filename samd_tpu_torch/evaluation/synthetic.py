"""Synthetic Spec-Bench-shaped task suite (counterpart of
``samd_tpu/evaluation/synthetic.py``).

Without public datasets or checkpoints at hand, this module generates a
token-level suite with the *structural* properties of the six Spec-Bench
tasks: categories differ in how much of the target
continuation overlaps retrievable context —

  * summarization / rag: the prompt embeds long spans the model will reuse
    (high retrieval overlap; the reference's strongest tasks)
  * mt_bench: multi-turn with shared context
  * translation / qa / math_reasoning: little verbatim overlap (cold)

Generation targets come from the engine-under-test's own AR oracle, so
accept-length/speedup statistics are meaningful for engine comparisons even
with random weights.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from .runner import Question

TASKS = {
    "summarization": dict(turns=1, prompt_len=192, overlap=True),
    "rag": dict(turns=1, prompt_len=160, overlap=True),
    "mt_bench": dict(turns=2, prompt_len=64, overlap=False),
    "translation": dict(turns=1, prompt_len=64, overlap=False),
    "qa": dict(turns=1, prompt_len=48, overlap=False),
    "math_reasoning": dict(turns=1, prompt_len=80, overlap=False),
}


def make_questions(vocab_size: int, *, per_task: int = 2,
                   seed: int = 0, tasks: Optional[List[str]] = None,
                   corpus=None) -> List[Question]:
    """When ``corpus`` (a 1-D token array, e.g. the training corpus of a
    trained demo model) is given, overlap-task prompts are corpus slices —
    the document-grounded regime (summarization/RAG) where the reference's
    retrieval speedups are largest; cold tasks stay
    fresh-random."""
    rng = np.random.default_rng(seed)
    out = []
    qid = 0
    for task, spec in TASKS.items():
        if tasks is not None and task not in tasks:
            continue
        for _ in range(per_task):
            turns = []
            for _t in range(spec["turns"]):
                if spec["overlap"] and corpus is not None:
                    start = int(rng.integers(
                        0, len(corpus) - spec["prompt_len"]))
                    ids = [int(t) for t in
                           corpus[start:start + spec["prompt_len"]]]
                else:
                    ids = rng.integers(3, vocab_size,
                                       size=spec["prompt_len"]).tolist()
                if spec["overlap"] and corpus is None:
                    # repeat a span inside the prompt: retrieval fodder
                    span = ids[:spec["prompt_len"] // 3]
                    ids = ids + span
                turns.append(ids)
            out.append(Question(question_id=qid, category=task, turns=turns))
            qid += 1
    return out


def write_questions(questions: List[Question], path: str) -> None:
    with open(path, "w") as f:
        for q in questions:
            f.write(json.dumps({
                "question_id": q.question_id,
                "category": q.category,
                "turns": q.turns,
            }) + "\n")
