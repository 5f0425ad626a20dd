"""Trained-weights acceptance demonstration (counterpart of
``samd_tpu/evaluation/accept_demo.py``).

Random weights pin an engine's mechanics but say nothing of its accept
lengths.  This runner trains a small target LM and an EAGLE draft net on a
peaked Markov corpus (``training``), round-trips the target through the
port's checkpoint format (``models.checkpoint``) and serves the restored
copy, then measures the mean accepted tokens per verify step of each
drafter family: the quantity the reference's results tables report (4.62
for EAGLE-2, 2.83 for Token Recycle).

    python -m samd_tpu_torch.evaluation.accept_demo [--cpu] [--steps 400]
        [--vocab 64] [--new-tokens 48]

Logs one row per (drafter, weights) on stderr and prints a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

# the reference's published mean accepted tokens (its README), for context
REFERENCE_ACCEPT = {
    "samd_sam_only_mean_accept": 2.30,
    "samd_token_recycle_mean_accept": 3.03,
    "token_recycle_mean_accept": 2.83,
    "eagle2_mean_accept": 4.62,
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(steps: int = 400, vocab: int = 64, new_tokens: int = 48,
        seed: int = 0, device: str = "cuda") -> dict:
    import numpy as np

    from ..config import GenerationConfig, SamdConfig
    from ..drafters import make_drafter
    from ..engine import SamdEngine
    from ..fused_hybrid import (BatchedFusedHybridEagleEngine,
                                FusedHybridEagleConfig)
    from ..models import tiny_config
    from ..models.checkpoint import load_params, save_params
    from ..sam import build_corpus_sam
    from ..training import markov_corpus, train_eagle, train_lm

    cfg = tiny_config(vocab_size=vocab)
    corpus = markov_corpus(vocab, 20000, peak=0.9, branch=2, order=2,
                           seed=seed)
    log(f"training target LM ({steps} steps)...")
    params, lm_curve = train_lm(cfg, corpus, steps=steps, batch=16,
                                seq_len=64, seed=seed,
                                log_every=max(steps - 1, 1), device=device)
    log(f"  LM loss {lm_curve[0]:.3f} -> {lm_curve[-1]:.3f}")
    log(f"training EAGLE draft net ({steps} steps)...")
    net, eg_tail = train_eagle(cfg, params, corpus, steps=steps, batch=16,
                               seq_len=64, seed=seed, device=device)
    log(f"  final distill loss {eg_tail[-1]:.3f}")

    # what serves below is the restored copy of the target
    with tempfile.TemporaryDirectory() as d:
        save_params(d, params, cfg)
        cfg, params = load_params(d, device=device)

    static_sam = build_corpus_sam([corpus.tolist()], eos_token=0, topk=8)
    gen = GenerationConfig(max_new_tokens=new_tokens, max_cache_len=256)
    rng = np.random.default_rng(seed + 1)
    prompts = [corpus[s:s + 32].tolist()
               for s in rng.integers(0, len(corpus) - 64, size=4)]

    def measure(scfg: SamdConfig, *, eagle_net=None, sam=None,
                target=params, reqs=prompts):
        eng = SamdEngine(
            cfg, target, scfg,
            make_drafter(scfg, cfg.vocab_size, static_sam=sam,
                         model_cfg=cfg, params=target,
                         eagle_net_params=eagle_net),
            max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,),
            device=device)
        tok = steps_n = 0
        for p in reqs:
            o = eng.generate(p, gen)
            tok += o.decode_tokens
            steps_n += o.decode_steps
        return round(tok / max(steps_n, 1), 3), dict(eng.stats.source_counts)

    rows = {}
    # dynamic and static SAM retrieval: the corpus holds the model's
    # near-deterministic continuations (the reference's RAG and
    # summarization regime)
    rows["sam_only_trained"], src = measure(
        SamdConfig(draft_source="sam_only", max_predicts=40, alpha=4.0),
        sam=static_sam)
    log(f"sam_only (trained, corpus SAM): accept {rows['sam_only_trained']}"
        f" sources {src}")
    rows["sam_only_dyn_trained"], _ = measure(
        SamdConfig(draft_source="sam_only", max_predicts=40, alpha=4.0))
    log(f"sam_only (trained, dynamic only): accept "
        f"{rows['sam_only_dyn_trained']}")
    tr_cfg = SamdConfig(draft_source="sam_hybrid",
                        tree_method="token_recycle", max_predicts=64,
                        len_threshold=1000)
    rows["token_recycle_trained"], _ = measure(tr_cfg)
    log(f"token_recycle (trained): accept {rows['token_recycle_trained']}")

    # Token Recycle's harvest table is keyed by ONE token, so it drafts from
    # order-1 context; on the order-2 corpus above the last token leaves
    # about two contexts of two branches each, which caps its accept near
    # 1.5.  The same model trained on an order-1 corpus (where one token
    # carries the transition, as in natural text) is the comparable row.
    corpus1 = markov_corpus(vocab, 20000, peak=0.9, branch=2, order=1,
                            seed=seed + 7)
    log(f"training order-1 target LM ({steps} steps)...")
    params1, _ = train_lm(cfg, corpus1, steps=steps, batch=16, seq_len=64,
                          seed=seed + 7, device=device)
    prompts1 = [corpus1[s:s + 32].tolist()
                for s in rng.integers(0, len(corpus1) - 64, size=4)]
    rows["token_recycle_trained_order1"], _ = measure(
        tr_cfg, target=params1, reqs=prompts1)
    log(f"token_recycle (trained, order-1 corpus): accept "
        f"{rows['token_recycle_trained_order1']} "
        f"(order-2 ceiling row: {rows['token_recycle_trained']})")
    eagle_cfg = SamdConfig(draft_source="sam_hybrid", tree_method="eagle2",
                           max_predicts=64, len_threshold=1000)
    rows["eagle2_trained"], _ = measure(eagle_cfg, eagle_net=net)
    log(f"eagle2 (trained net): accept {rows['eagle2_trained']}")
    rows["eagle2_random_net"], _ = measure(eagle_cfg)
    log(f"eagle2 (random net): accept {rows['eagle2_random_net']}")
    # the flagship hybrid: SAM retrieval when the automaton is confident,
    # the EAGLE tree otherwise
    rows["sam_eagle2_trained"], src = measure(
        SamdConfig(draft_source="sam_hybrid", tree_method="eagle2",
                   max_predicts=64, len_threshold=5, len_bias=5),
        eagle_net=net, sam=static_sam)
    log(f"SAM[eagle2] hybrid (trained): accept {rows['sam_eagle2_trained']}"
        f" sources {src}")

    # the same net through the batched SAM[EAGLE-2] engine, with the
    # single-stream rows' tree (depth 5, top-8, 63 nodes)
    beng = BatchedFusedHybridEagleEngine(
        cfg, params,
        FusedHybridEagleConfig(steps_per_call=8, len_threshold=1000),
        net_params=net, batch_size=2, max_cache_len=256, eos_token_id=-1,
        prefill_buckets=(32,), device=device)
    for p in prompts:
        beng.add_request(p, gen)
    bres = beng.run()
    tok = sum(r.decode_tokens for r in bres.values())
    stp = sum(r.decode_steps for r in bres.values())
    rows["eagle2_trained_batched"] = round(tok / max(stp, 1), 3)
    log(f"eagle2 (trained net, batched engine B=2): accept "
        f"{rows['eagle2_trained_batched']}")

    return {
        "lm_loss_first": round(lm_curve[0], 4),
        "lm_loss": round(lm_curve[-1], 4),
        "eagle_loss": round(eg_tail[-1], 4),
        "accept": rows,
        "reference_targets": REFERENCE_ACCEPT,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--new-tokens", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out = run(steps=args.steps, vocab=args.vocab,
              new_tokens=args.new_tokens, seed=args.seed,
              device="cpu" if args.cpu else "cuda")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
