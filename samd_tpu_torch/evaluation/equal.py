"""Output-equality harness (counterpart of ``samd_tpu/evaluation/equal.py``):
assert speculative decoding is lossless.

The reference's ``evaluation/equal.py`` converts two answer JSONL
files to per-turn text and diffs them ("Result totally Equal!").  Here the
comparison is structural (token-level when turns are token lists).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple


def load_turns(path: str) -> Dict[int, List]:
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out[d["question_id"]] = [
                turn for choice in d["choices"] for turn in choice["turns"]]
    return out


def compare(answer_path: str, baseline_path: str) -> Tuple[bool, List[int]]:
    """Returns (all_equal, list of mismatching question ids)."""
    a = load_turns(answer_path)
    b = load_turns(baseline_path)
    mismatches = []
    for qid in sorted(set(a) & set(b)):
        if a[qid] != b[qid]:
            mismatches.append(qid)
    return not mismatches and set(a) == set(b), mismatches


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("answer")
    p.add_argument("baseline")
    args = p.parse_args()
    equal, mismatches = compare(args.answer, args.baseline)
    if equal:
        print("Result totally Equal!")
    else:
        print(f"MISMATCH on question ids: {mismatches}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
