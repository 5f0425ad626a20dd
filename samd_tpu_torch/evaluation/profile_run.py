"""Profiling runner: per-phase wall time and draft-source statistics of
the host ``SamdEngine`` (counterpart of
``samd_tpu/evaluation/profile_run.py``).

    python -m samd_tpu_torch.evaluation.profile_run [--trace DIR]
        [--mode sam_only|sam_hybrid] [--cpu] [--new-tokens 64]

Runs the synthetic suite on random weights (llama_1b on the card; with
``--cpu`` a tiny config of 2048 tokens), sets a ``profiling.PhaseTimer`` on
the engine after one warm-up request, and prints the phase table, the
draft-source histogram and the mean accept per source.  ``--trace DIR``
also writes a ``torch.profiler`` trace (``DIR/trace.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trace", default=None,
                   help="write a torch.profiler trace into this directory")
    p.add_argument("--mode", default="sam_only",
                   choices=["sam_only", "sam_hybrid"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--new-tokens", type=int, default=64)
    args = p.parse_args(argv)

    import torch

    from ..config import GenerationConfig, SamdConfig
    from ..drafters import make_drafter
    from ..engine import SamdEngine
    from ..models import init_params, llama_1b, tiny_config
    from ..profiling import PhaseTimer, torch_trace
    from .synthetic import make_questions

    device = "cpu" if args.cpu else "cuda"
    cfg = tiny_config(vocab_size=2048) if args.cpu else llama_1b()
    gen_w = torch.Generator(device=device)
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.3, device=device)
    samd_cfg = SamdConfig(draft_source=args.mode)
    engine = SamdEngine(
        cfg, params, samd_cfg,
        make_drafter(samd_cfg, cfg.vocab_size, model_cfg=cfg, params=params),
        max_cache_len=1024, eos_token_id=-1, prefill_buckets=(256,),
        device=device)
    gen = GenerationConfig(max_new_tokens=args.new_tokens, max_cache_len=1024)
    questions = make_questions(cfg.vocab_size, per_task=1, seed=0)

    engine.generate(questions[0].turns[0], gen)     # warm-up
    engine.profiler = PhaseTimer()
    engine.stats.source_counts.clear()
    engine.stats.accept_by_source.clear()

    ctx = (torch_trace(args.trace) if args.trace
           else contextlib.nullcontext())
    with ctx:
        for q in questions:
            for turn in q.turns:
                engine.generate(turn, gen)

    print("\n== phase breakdown (normalized by device_step) ==")
    for row in engine.profiler.report(normalize_by="device_step"):
        print(f"  {row['phase']:<14} total {row['total_s']:>8.3f}s  "
              f"calls {row['calls']:>5}  mean {row['mean_ms']:>8.3f}ms  "
              f"frac {row['frac']}")
    print("\n== draft sources ==")
    print(json.dumps(engine.stats.source_counts, indent=2))
    print("\n== mean accept length per source ==")
    for src, total in engine.stats.accept_by_source.items():
        print(f"  {src}: {total / engine.stats.source_counts[src]:.2f}")
    print(f"\noverall mean accepted tokens: {engine.stats.mean_accept():.2f}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
