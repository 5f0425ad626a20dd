"""Retrieval parity: the fused engines' windowed and indexed matches against
the exact automaton (counterpart of ``samd_tpu/evaluation/parity.py``).

The fused engines find suffix matches through a bounded window
(``max_ngram + ext`` tokens, ``fused_sam.suffix_match``) and, at corpus
scale, through an n-gram hash index with bounded buckets
(``ops.ngram_index``).  Both approximate the exact suffix automaton
(``sam.automaton``): greedy outputs stay exact through verification, but
drafting can differ where matches are long.  This walks one trajectory
through both, compares (match_len, end_pos) step by step, and reports the
agreement rates and the adaptive draft length's change that the match
change implies (draft_n = 1 + match * alpha, capped).

    python -m samd_tpu_torch.evaluation.parity [--corpus-size N]
        [--steps N] [--indexed] [--cpu]

The matches run on the CUDA card unless ``--cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device


def exact_corpus_matches(corpus: Sequence[int],
                         trajectory: Sequence[int]) -> List[tuple]:
    """(match_len, end_pos) of the exact automaton at every step of
    ``trajectory``: the cursor walk of the host engine, end_pos the end
    index of the matched string's first occurrence."""
    from ..sam.automaton import SuffixAutomaton

    sam = SuffixAutomaton(track_text=True, track_counts=False)
    sam.feed(list(corpus), grow=True)
    sam.reset_cursor()
    out = []
    for tok in trajectory:
        s, m = sam.peek(int(tok))
        out.append((m, sam._first_end[s]))
        sam.feed([int(tok)], grow=False)
    return out


def windowed_corpus_matches(corpus: Sequence[int],
                            trajectory: Sequence[int], *,
                            max_ngram: int = 8, ext: int = 56, index=None,
                            device: Union[str, torch.device] = "cuda"
                            ) -> List[tuple]:
    """(match_len, end_pos) of the fused windowed scan, or of the index
    probe when ``index`` (an ``ops.ngram_index.NgramIndex`` on ``device``)
    is given, at every step of ``trajectory``."""
    from ..fused_sam import suffix_match
    from ..ops.ngram_index import indexed_suffix_match

    dev = resolve_device(device)
    Q, E = max_ngram, ext
    corpus_dev = torch.as_tensor(np.asarray(corpus, np.int32), device=dev)
    clen = torch.tensor(len(corpus), dtype=torch.int32, device=dev)
    out = []
    hist: List[int] = []
    for tok in trajectory:
        q = np.full(Q, -1, np.int32)
        q[-1] = tok
        ctx = hist[-(Q - 1):] if Q > 1 else []
        if ctx:
            q[Q - 1 - len(ctx):Q - 1] = ctx
        pre = hist[:len(hist) - len(ctx)]
        tail = np.full(E, -1, np.int32)
        tl = min(E, len(pre))
        if tl:
            tail[E - tl:] = pre[-tl:]
        query = torch.from_numpy(q).to(dev)[None]
        tail_t = torch.from_numpy(tail).to(dev)[None]
        tl_t = torch.tensor([tl], dtype=torch.int32, device=dev)
        if index is not None:
            m, e = indexed_suffix_match(corpus_dev, clen, index, query,
                                        tail_t, tl_t, max_ngram=Q, ext=E)
        else:
            m, e = suffix_match(corpus_dev[None], clen, query, tail_t, tl_t,
                                max_ngram=Q, ext=E)
        out.append((int(m[0]), int(e[0])))
        hist.append(int(tok))
    return out


def parity_report(corpus: Sequence[int], trajectory: Sequence[int], *,
                  max_ngram: int = 8, ext: int = 56, alpha: float = 4.0,
                  max_predicts: int = 60, index=None,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """The exact against the windowed (or indexed) matches on one
    trajectory: agreement rates, and the match and draft-length changes
    (the window cannot see past ``max_ngram + ext``, so the exact match is
    capped there)."""
    exact = exact_corpus_matches(corpus, trajectory)
    fused = windowed_corpus_matches(corpus, trajectory, max_ngram=max_ngram,
                                    ext=ext, index=index, device=device)
    cap = max_ngram + ext
    n = len(trajectory)
    match_eq = end_eq = 0
    draft_deltas, match_deltas = [], []
    for (me, ee), (mf, ef) in zip(exact, fused):
        me_c = min(me, cap)
        match_eq += int(mf == me_c)
        end_eq += int(mf == me_c and (mf == 0 or ef == ee))
        de = min(max_predicts, 1 + int(me * alpha))
        df = min(max_predicts, 1 + int(mf * alpha))
        draft_deltas.append(de - df)
        match_deltas.append(me_c - mf)
    return {
        "steps": n,
        "match_agreement": round(match_eq / max(n, 1), 4),
        "match_and_end_agreement": round(end_eq / max(n, 1), 4),
        "mean_match_delta_capped": round(float(np.mean(match_deltas)), 4),
        "max_match_delta_capped": int(np.max(match_deltas)) if n else 0,
        "mean_draft_len_delta": round(float(np.mean(draft_deltas)), 4),
        "window_cap": cap,
    }


def make_workload(corpus_size: int, steps: int, vocab: int, seed: int):
    """The reference CLI's workload: a corpus of 200-token documents, each
    repeated 1-3 times (so long matches exist), and a trajectory of
    40-token corpus slices interleaved with 20 tokens of noise."""
    rng = np.random.default_rng(seed)
    chunks = []
    while sum(len(c) for c in chunks) < corpus_size:
        doc = rng.integers(0, vocab, size=200).tolist()
        chunks.append(doc * int(rng.integers(1, 4)))
    corpus = [t for c in chunks for t in c][:corpus_size]
    traj = []
    while len(traj) < steps:
        if rng.random() < 0.5 and len(corpus) > 100:
            s = int(rng.integers(0, len(corpus) - 80))
            traj += corpus[s:s + 40]
        else:
            traj += rng.integers(0, vocab, size=20).tolist()
    return corpus, traj[:steps]


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus-size", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--indexed", action="store_true")
    p.add_argument("--bucket-cap", type=int, default=8)
    p.add_argument("--grams", type=int, nargs="+", default=[8, 4, 2, 1],
                   help="gram sizes; sizes > max_ngram hash the query and "
                        "tail window")
    p.add_argument("--keep-latest", type=int, default=0,
                   help="a second table per bucket of its latest N "
                        "positions")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    corpus, traj = make_workload(args.corpus_size, args.steps, args.vocab,
                                 args.seed)
    index = None
    if args.indexed:
        from ..ops.ngram_index import build_ngram_index

        index = build_ngram_index(corpus, bucket_cap=args.bucket_cap,
                                  grams=args.grams,
                                  keep_latest=args.keep_latest,
                                  device=device)
    rep = parity_report(corpus, traj, index=index, device=device)
    rep.update(mode="indexed" if args.indexed else "windowed",
               grams=args.grams if args.indexed else None,
               keep_latest=args.keep_latest if args.indexed else None,
               corpus_size=len(corpus), device=device)
    print(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
