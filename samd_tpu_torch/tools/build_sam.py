"""Build a static corpus SAM from JSONL (counterpart of
``samd_tpu/tools/build_sam.py``), in the shared ``.npz`` format that both
packages load (``sam.serialize``):

    python -m samd_tpu_torch.tools.build_sam --input corpus.jsonl \\
        --output sam.npz [--tokenizer DIR] [--eos-token 2] \\
        [--add-vocab 32000]

Input rows: ``{"tokens": [...]}``, or ``{"text": ...}`` /
``{"prompt": ..., "response": ...}`` with ``--tokenizer`` (an HF tokenizer
directory; transformers is imported only then).  Each sequence is fed with
an end token after it; ``--add-vocab N`` also feeds ``[i, eos]`` for every
i < N, so every token has a transition.  The automaton is the native C++
engine (``sam.native``), which the port builds with g++ at first use.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, List, Optional


def load_text_tokenizer(path: str):
    """An HF tokenizer for text rows; a clear error when transformers is
    not installed."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(f"--tokenizer {path}: text rows need the "
                         f"transformers package, which does not import "
                         f"({e}); give token rows instead") from e
    return AutoTokenizer.from_pretrained(path)


def iter_token_sequences(path: str, tokenizer) -> Iterator[List[int]]:
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            if "tokens" in row:
                yield list(row["tokens"])
            elif "text" in row or ("prompt" in row and "response" in row):
                if tokenizer is None:
                    raise SystemExit("--tokenizer required for text input")
                text = row["text"] if "text" in row \
                    else row["prompt"] + row["response"]
                yield tokenizer.encode(text)
            else:
                raise SystemExit(f"unrecognized row keys: {sorted(row)}")


def build(args) -> dict:
    """Build and save the automaton; returns its counts."""
    from ..sam.native import NativeSuffixAutomaton
    from ..sam.serialize import save_sam

    tokenizer = None
    if args.tokenizer:
        tokenizer = load_text_tokenizer(args.tokenizer)
        if args.eos_token is None:
            args.eos_token = tokenizer.eos_token_id
    eos = args.eos_token if args.eos_token is not None else 2
    sam = NativeSuffixAutomaton(track_text=True, track_counts=True)
    n_seqs = n_tokens = 0
    for seq in iter_token_sequences(args.input, tokenizer):
        sam.feed(seq, grow=True)
        if not seq or seq[-1] != eos:
            sam.feed([eos], grow=True)
        n_seqs += 1
        n_tokens += len(seq)
        if args.verbose and n_seqs % 1000 == 0:
            print(f"  {n_seqs} sequences / {n_tokens} tokens...",
                  file=sys.stderr)
    for i in range(args.add_vocab):
        sam.feed([i, eos], grow=True)
    save_sam(sam, args.output)
    print(f"built SAM: {n_seqs} sequences, {n_tokens} tokens, "
          f"{sam.num_states} states -> {args.output}", file=sys.stderr)
    return {"sequences": n_seqs, "tokens": n_tokens,
            "states": sam.num_states}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="corpus JSONL")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer directory (for text input)")
    p.add_argument("--eos-token", type=int, default=None)
    p.add_argument("--add-vocab", type=int, default=0,
                   help="also feed [i, eos] for every i < N")
    p.add_argument("--verbose", action="store_true")
    return build(p.parse_args(argv))


if __name__ == "__main__":
    main()
