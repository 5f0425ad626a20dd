"""The Spec-Bench pipeline end to end, with trained weights (counterpart of
``samd_tpu/evaluation/specbench_demo.py``).

The reference's headline artifact is a per-task speedup table from its
evaluation stack: questions → answer JSONL → ``speed.py`` → ``equal.py``.
Without public checkpoints or Spec-Bench data at hand, this module runs the
same pipeline (a question file on disk → ``load_questions`` → ``run_eval``
with warmup, multi-turn threading and fault tolerance → answer JSONL →
``reorg_answer_file`` → ``speed.speedup`` per task → ``equal.compare``)
with a tiny model trained here (``training``) over the synthetic
Spec-Bench-shaped suite (``synthetic``).

    python -m samd_tpu_torch.evaluation.specbench_demo [--cpu]
        [--steps 400] [--per-task 2] [--new-tokens 64] [--out-dir DIR]

Engines, each against the block-1 AR speed baseline and, for losslessness,
the AR oracle of its own block: the host ``SamdEngine`` with ``sam_only``
drafts (exact suffix automata) and ``FusedSamEngine``.  Logs one row per
(engine, task) on stderr and prints a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(steps: int = 400, vocab: int = 64, per_task: int = 2,
        new_tokens: int = 64, seed: int = 0, out_dir: str = None,
        device: str = "cuda") -> dict:
    from ..config import GenerationConfig, SamdConfig
    from ..drafters import make_drafter
    from ..engine import ArBaseline, SamdEngine
    from ..fused_sam import FusedSamConfig, FusedSamEngine
    from ..models import tiny_config
    from ..sam import build_corpus_sam
    from ..training import markov_corpus, train_lm
    from . import equal as equal_mod
    from .runner import load_questions, reorg_answer_file, run_eval
    from .speed import SPEC_BENCH_TASKS, mean_accepted_tokens, speedup
    from .synthetic import make_questions, write_questions

    cfg = tiny_config(vocab_size=vocab)
    # an order-1 chain: one token of context carries the transition (the
    # natural-text regime; see accept_demo's Token-Recycle rows)
    corpus = markov_corpus(vocab, 20000, peak=0.9, branch=2, order=1,
                           seed=seed)
    log(f"training target LM ({steps} steps)...")
    params, lm_tail = train_lm(cfg, corpus, steps=steps, batch=16,
                               seq_len=64, seed=seed, device=device)
    log(f"  final LM loss {lm_tail[-1]:.3f}")
    static_sam = build_corpus_sam([corpus.tolist()], eos_token=0, topk=8)

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        questions_path = os.path.join(out_dir, "question.jsonl")
        write_questions(
            make_questions(vocab, per_task=per_task, seed=seed + 1,
                           corpus=corpus),
            questions_path)
        questions = load_questions(questions_path)
        log(f"{len(questions)} questions over "
            f"{len({q.category for q in questions})} tasks -> "
            f"{questions_path}")

        max_cache = 512
        kw = dict(max_cache_len=max_cache, eos_token_id=-1,
                  prefill_buckets=(64, 128, 256, 512), device=device)
        gen = GenerationConfig(max_new_tokens=new_tokens,
                               max_cache_len=max_cache)
        m_host = 40   # the host sam_only verify block (n_predicts 40)
        fs_cfg = FusedSamConfig()

        def evaluate(name, engine):
            path = os.path.join(out_dir, f"{name}.jsonl")
            stats = run_eval(engine, questions, path, gen_config=gen,
                             warmup=2, model_id=name)
            reorg_answer_file(path)
            log(f"{name}: {stats['tokens_per_s']:.1f} tok/s, "
                f"accept {stats['mean_accepted_tokens']:.2f}, "
                f"errors {stats['errors']}")
            return path, stats

        # the speed baseline and the two block oracles
        base_path, base_stats = evaluate(
            "baseline", ArBaseline(cfg, params, block_size=1, **kw))
        oracle_host_path, _ = evaluate(
            f"oracle_block{m_host}",
            ArBaseline(cfg, params, block_size=m_host, **kw))
        oracle_fused_path, _ = evaluate(
            f"oracle_block{fs_cfg.block}",
            ArBaseline(cfg, params, block_size=fs_cfg.block, **kw))

        scfg = SamdConfig(draft_source="sam_only", max_predicts=m_host,
                          alpha=4.0)
        sam_path, sam_stats = evaluate(
            "sam_only",
            SamdEngine(cfg, params, scfg,
                       make_drafter(scfg, vocab, static_sam=static_sam),
                       **kw))
        fused_path, fused_stats = evaluate(
            "fused_sam",
            FusedSamEngine(cfg, params, fs_cfg, corpus=corpus.tolist(),
                           **kw))

        # speed.py and equal.py, the reference's post-processing
        result = {"lm_loss": round(float(lm_tail[-1]), 4),
                  "n_questions": len(questions), "engines": {}}
        for name, path, stats, oracle_path in (
                ("sam_only", sam_path, sam_stats, oracle_host_path),
                ("fused_sam", fused_path, fused_stats, oracle_fused_path)):
            per_task_speedup = speedup(path, base_path)
            eq, mismatches = equal_mod.compare(path, oracle_path)
            row = {
                "speedup": {t: round(per_task_speedup[t], 3)
                            for t in (*SPEC_BENCH_TASKS, "overall")
                            if t in per_task_speedup},
                "mean_accept": round(mean_accepted_tokens(path), 3),
                "tokens_per_s": round(stats["tokens_per_s"], 2),
                "outputs_equal_vs_block_oracle": eq,
                "mismatch_qids": mismatches,
                "errors": stats["errors"],
            }
            result["engines"][name] = row
            tasks = " ".join(f"{t}={row['speedup'][t]:.2f}x"
                             for t in row["speedup"])
            log(f"{name}: {tasks} | accept {row['mean_accept']} | "
                f"equal={eq}{'' if eq else ' qids=' + str(mismatches)}")
        result["baseline_tokens_per_s"] = round(base_stats["tokens_per_s"],
                                                2)
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--per-task", type=int, default=2)
    p.add_argument("--new-tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=None,
                   help="keep the question and answer JSONL files here")
    args = p.parse_args(argv)
    out = run(steps=args.steps, vocab=args.vocab, per_task=args.per_task,
              new_tokens=args.new_tokens, seed=args.seed,
              out_dir=args.out_dir, device="cpu" if args.cpu else "cuda")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
