"""Speedup calculator over answer JSONL files (counterpart of
``samd_tpu/evaluation/speed.py``).

As the reference's ``evaluation/speed.py``: tokens/s per Spec-Bench task
vs a baseline answer file, plus overall; ``mean_report`` averages repeated
runs with std.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

SPEC_BENCH_TASKS = ("mt_bench", "translation", "summarization", "qa",
                    "math_reasoning", "rag")


def _per_task_tokens_time(path: str) -> Dict[str, Tuple[float, float]]:
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            task = d.get("category", "unknown")
            for choice in d["choices"]:
                agg[task][0] += sum(choice["new_tokens"])
                agg[task][1] += sum(choice["wall_time"])
    return {k: (v[0], v[1]) for k, v in agg.items()}


def tokens_per_second(path: str) -> Dict[str, float]:
    per_task = _per_task_tokens_time(path)
    out = {}
    tot_tok = tot_t = 0.0
    for task, (tok, t) in per_task.items():
        out[task] = tok / t if t else 0.0
        tot_tok += tok
        tot_t += t
    out["overall"] = tot_tok / tot_t if tot_t else 0.0
    return out


def speedup(answer_path: str, baseline_path: str) -> Dict[str, float]:
    """Per-task and overall speedup of `answer_path` vs `baseline_path`."""
    a = tokens_per_second(answer_path)
    b = tokens_per_second(baseline_path)
    return {task: (a[task] / b[task]) for task in a if task in b and b[task]}


def mean_accepted_tokens(path: str) -> float:
    """Mean accepted tokens per decode step.  Uses the per-step accept
    lists when present (host engines); fused device-loop engines return
    only aggregate counters, so fall back to new_tokens/idxs — the same
    ratio the reference's ``speed.py`` computes from its answer files."""
    total = count = 0
    tok = steps = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            for choice in d["choices"]:
                for accepts in choice.get("accept_lengths", []):
                    total += sum(accepts)
                    count += len(accepts)
                tok += sum(choice.get("new_tokens", []))
                steps += sum(choice.get("idxs", []))
    if count:
        return total / count
    return tok / steps if steps else 0.0


def mean_report(answer_paths: List[str], baseline_paths: List[str]) -> Dict:
    """Average speedups over repeated runs with std (the reference's
    ``get_mean_speedup``)."""
    import statistics

    runs = [speedup(a, b) for a, b in zip(answer_paths, baseline_paths)]
    tasks = sorted({t for r in runs for t in r})
    report = {}
    for t in tasks:
        vals = [r[t] for r in runs if t in r]
        report[t] = {
            "mean": statistics.mean(vals),
            "std": statistics.stdev(vals) if len(vals) > 1 else 0.0,
        }
    return report


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("answer")
    p.add_argument("baseline")
    args = p.parse_args()
    for task, s in sorted(speedup(args.answer, args.baseline).items()):
        print(f"{task}: {s:.2f}x")
    print(f"mean accepted tokens: {mean_accepted_tokens(args.answer):.2f}")


if __name__ == "__main__":
    main()
