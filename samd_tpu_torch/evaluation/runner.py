"""Spec-Bench-style evaluation runner (counterpart of
``samd_tpu/evaluation/runner.py``).

Load a question file (Spec-Bench JSONL: ``question_id``, ``category``,
``turns``), run warmups, generate each turn with wall-clock timing, and
write an answer JSONL with per-turn token, step and accept statistics.
The answer schema is the reference's field for field, so ``speed`` and
``equal`` of either package read the other's files.

It takes any engine with ``generate(input_ids, gen)`` and a tokenizer-like
codec (``IdentityCodec`` for token-id questions, ``codecs`` for text).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..config import GenerationConfig


@dataclass
class Question:
    question_id: int
    category: str
    turns: List[object]  # str (needs a codec) or List[int] token ids


def load_questions(path: str) -> List[Question]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(Question(
                question_id=d["question_id"],
                category=d.get("category", "unknown"),
                turns=d["turns"]))
    return out


class IdentityCodec:
    """Codec for questions whose turns are already token-id lists."""

    def encode(self, turn) -> List[int]:
        return list(turn)

    def decode(self, ids: Sequence[int]):
        return list(ids)

    def encode_conversation(self, turns, answers) -> List[int]:
        """Token-id transcript: raw alternating concatenation."""
        out: List[int] = []
        for i, t in enumerate(turns):
            out.extend(t)
            if i < len(answers):
                out.extend(answers[i])
        return out


def run_eval(engine, questions: Sequence[Question], out_path: str, *,
             gen_config: Optional[GenerationConfig] = None,
             codec=None, warmup: int = 3,
             multi_turn_context: bool = True,
             model_id: str = "samd_tpu_torch",
             append: bool = False) -> Dict:
    """Evaluate ``engine`` over ``questions``, writing answer JSONL to
    ``out_path``; returns aggregate stats.

    Each row: {question_id, category, model_id, choices: [{turns, idxs
    (decode steps), new_tokens, wall_time, accept_lengths}], tstamp}.

    A multi-turn prompt is the codec's whole transcript
    (``encode_conversation(turns_so_far, answers_so_far)``), as FastChat
    threads a conversation.  A question whose generation raises records
    ``"ERROR"`` turns, and the run goes on.
    """
    gen = gen_config or GenerationConfig()
    codec = codec or IdentityCodec()

    # Warm up before timing: the first ``warmup`` questions, and the first
    # question of every later category (its prompt length may reach a
    # prefill bucket no earlier question did).
    warm_qs = list(questions)[:warmup]
    seen_cats = {q.category for q in warm_qs}
    for q in questions:
        if q.category not in seen_cats:
            seen_cats.add(q.category)
            warm_qs.append(q)
    for q in warm_qs:
        try:
            engine.generate(codec.encode(q.turns[0]), gen)
        except Exception:  # the timed run below records the failure
            pass
    errors = 0

    total_tokens = 0
    total_steps = 0
    total_time = 0.0
    accept_all: List[int] = []
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "a" if append else "w") as fout:
        for q in questions:
            turns_out, idxs, new_tokens, wall_time = [], [], [], []
            accepts = []
            answers: List[object] = []
            try:
                for i in range(len(q.turns)):
                    if multi_turn_context:
                        prompt = codec.encode_conversation(
                            q.turns[:i + 1], answers)
                    else:
                        prompt = codec.encode(q.turns[i])
                    t0 = time.perf_counter()
                    out = engine.generate(prompt, gen)
                    dt = time.perf_counter() - t0
                    gen_ids = out.output_ids[len(prompt):]
                    answer = codec.decode(gen_ids)
                    answers.append(answer)
                    turns_out.append(answer)
                    idxs.append(out.decode_steps)
                    new_tokens.append(out.decode_tokens)
                    wall_time.append(dt)
                    accepts.append(out.accept_length_per_step)
                    accept_all.extend(out.accept_length_per_step)
                    total_tokens += out.decode_tokens
                    total_steps += out.decode_steps
                    total_time += dt
            except Exception as e:  # record the failure, keep evaluating
                print(f"ERROR on question {q.question_id}: {e!r}")
                errors += 1
                turns_out.append("ERROR")
                idxs.append(0)
                new_tokens.append(0)
                wall_time.append(0.0)
                accepts.append([])
            fout.write(json.dumps({
                "question_id": q.question_id,
                "category": q.category,
                "model_id": model_id,
                "choices": [{
                    "turns": turns_out,
                    "idxs": idxs,
                    "new_tokens": new_tokens,
                    "wall_time": wall_time,
                    "accept_lengths": accepts,
                }],
                "tstamp": time.time(),
            }) + "\n")
    mean_accept = (sum(accept_all) / len(accept_all)) if accept_all else 0.0
    return {
        "total_tokens": total_tokens,
        "total_steps": total_steps,
        "total_time": total_time,
        "tokens_per_s": total_tokens / total_time if total_time else 0.0,
        "mean_accepted_tokens": mean_accept,
        "errors": errors,
    }


def reorg_answer_file(path: str) -> None:
    """Deduplicate (the last answer wins) and sort an answer JSONL by
    question_id: how an interrupted evaluation resumes."""
    answers = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                answers[json.loads(line)["question_id"]] = line
    with open(path, "w") as f:
        for qid in sorted(answers):
            f.write(answers[qid])
