"""Streaming chat CLI over the port's engines (counterpart of
``samd_tpu/cli.py``).

A plain stdin REPL that streams accepted-token chunks as they commit:

    python -m samd_tpu_torch.cli --model DIR [--sam corpus.npz] \\
        [--engine samd|fused_sam|pld|token_recycle|fused_hybrid|
                  fused_sam_eagle2|eagle2] [--quantize int8|fp8|int4]
        [--kv-quant] [--cpu]
    python -m samd_tpu_torch.cli --random-model [--tiny] [--cpu]

``--model`` loads a local HF directory (``models.loader.load_llama``).
Text goes through the directory's tokenizer when it has one and
transformers imports; otherwise the REPL reads and writes space-separated
token ids.  ``--random-model`` serves random weights (llama_1b, or with
``--tiny`` a tiny config) in token-id mode.  Commands: ``!!reset`` clears
the conversation, ``!!remove`` drops the last exchange, ``!!regen`` redoes
it, ``!!save`` / ``!!load <path>`` keep the turns in a JSON file,
``!!exit`` quits.  The engines run on the CUDA card unless ``--cpu`` asks
for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

ENGINES = ("samd", "fused_sam", "pld", "token_recycle", "fused_hybrid",
           "fused_sam_eagle2", "eagle2")


def build_engine(args):
    """(engine, tokenizer or None, eos token id) for the parsed
    arguments."""
    import torch

    from .config import SamdConfig
    from .drafters import make_drafter
    from .engine import SamdEngine
    from .models.loader import build_params, quant_dtype
    from .ops.quant import quantize_eagle_params

    device = "cpu" if args.cpu else "cuda"
    static_sam = None
    if args.sam:
        from .sam import load_sam

        static_sam = load_sam(args.sam, topk=8)

    cfg, params, eos, tokenizer = build_params(args, device)
    if args.kv_quant:
        cfg = replace(cfg, kv_quant=True)

    # big-KV models (7B-class: >= 8 KB a token): per-request cache buckets,
    # so attention reads each request's reachable length, not the padded
    # maximum
    kv_bytes_per_tok = 2 * cfg.num_kv_heads * cfg.head_dim * 2
    cache_buckets = ()
    if kv_bytes_per_tok >= 8192:
        cache_buckets = tuple(
            b for b in (256, 384, 512, 768, 1024, 1536, 2048, 3072)
            if b < args.max_cache_len)
    qdtype = quant_dtype(args.quantize)

    def quantized_net():
        """The engines' default draft net (a generator seeded 7),
        quantized to the serving type; None keeps the engine's own."""
        if qdtype is None:
            return None
        from .drafters.eagle.net import EagleNetConfig, init_eagle_params

        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        net = init_eagle_params(EagleNetConfig.from_target(cfg), gen,
                                device=device)
        return quantize_eagle_params(net, dtype=qdtype)

    kw = dict(max_cache_len=args.max_cache_len, eos_token_id=eos,
              device=device)
    corpus = static_sam.text if static_sam is not None else None
    if args.engine == "fused_sam":
        from .fused_sam import FusedSamConfig, FusedSamEngine

        engine = FusedSamEngine(cfg, params,
                                FusedSamConfig(cache_buckets=cache_buckets),
                                corpus=corpus, **kw)
    elif args.engine == "pld":
        from .pld import PldEngine

        engine = PldEngine(cfg, params, **kw)
    elif args.engine == "token_recycle":
        from .token_recycle_fused import FusedTokenRecycleEngine

        engine = FusedTokenRecycleEngine(cfg, params, **kw)
    elif args.engine == "fused_hybrid":
        from .fused_hybrid import FusedHybridConfig, FusedHybridEngine

        engine = FusedHybridEngine(
            cfg, params, FusedHybridConfig(cache_buckets=cache_buckets),
            corpus=corpus, **kw)
    elif args.engine == "fused_sam_eagle2":
        from .fused_hybrid import (FusedHybridEagleConfig,
                                   FusedHybridEagleEngine)

        engine = FusedHybridEagleEngine(cfg, params, FusedHybridEagleConfig(),
                                        corpus=corpus,
                                        net_params=quantized_net(), **kw)
    elif args.engine == "eagle2":
        from .eagle_fused import FusedEagle2Engine

        engine = FusedEagle2Engine(cfg, params, net_params=quantized_net(),
                                   **kw)
    else:
        samd_cfg = SamdConfig(draft_source=args.mode)
        engine = SamdEngine(
            cfg, params, samd_cfg,
            make_drafter(samd_cfg, cfg.vocab_size, static_sam=static_sam),
            **kw)
    return engine, tokenizer, eos


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="samd_tpu_torch chat CLI")
    p.add_argument("--model", default=None, help="local HF model directory")
    p.add_argument("--sam", default=None, help="static corpus SAM (.npz)")
    p.add_argument("--mode", default="sam_only",
                   choices=["sam_only", "sam_hybrid"])
    p.add_argument("--engine", default="samd", choices=ENGINES,
                   help="samd = host SAM automata; the others run their "
                        "draft loop on the device; fused_hybrid = "
                        "SAM[Token Recycle]; fused_sam_eagle2 = "
                        "SAM[EAGLE-2]")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (single-stream engines)")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "fp8", "int4"],
                   help="weight-only quantization of the projections and "
                        "the head")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--random-model", action="store_true")
    p.add_argument("--family", default="llama",
                   choices=("llama", "qwen2", "moe"),
                   help="with --random-model: the model family (a "
                        "checkpoint's follows its config.json)")
    p.add_argument("--tiny", action="store_true",
                   help="with --random-model: a tiny config (smoke tests)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.random_model and not args.model:
        p.error("--model required (or --random-model for smoke testing)")
    return args


def main(argv=None):
    from .config import GenerationConfig

    args = parse_args(argv)
    engine, tokenizer, _ = build_engine(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           max_cache_len=args.max_cache_len)
    # the conversation: [user ids, assistant ids] per exchange
    turns = []

    def history_ids():
        out = []
        for u, a in turns:
            out += u + a
        return out

    def run_turn(ids):
        """Generate and stream one reply; returns its token ids."""
        print("ASSISTANT> ", end="", flush=True)
        out_ids = []
        if hasattr(engine, "stream_generate"):
            chunks = engine.stream_generate(ids, gen)
        else:  # the device-loop engines return whole requests
            chunks = [engine.generate(ids, gen).output_ids[len(ids):]]
        for chunk in chunks:
            out_ids.extend(chunk)
            if tokenizer is not None:
                print(tokenizer.decode(chunk, skip_special_tokens=True),
                      end="", flush=True)
            else:
                print(" ".join(map(str, chunk)), end=" ", flush=True)
        print()
        return out_ids

    print("samd_tpu_torch chat: !!reset clears context, !!remove drops the "
          "last exchange, !!regen redoes it, !!save/!!load <path> keep the "
          "conversation, !!exit quits", file=sys.stderr)
    while True:
        try:
            line = input("USER> ")
        except (EOFError, KeyboardInterrupt):
            break
        cmd = line.strip()
        if cmd == "!!exit":
            break
        if cmd == "!!reset":
            turns = []
            continue
        if cmd == "!!remove":
            if turns:
                turns.pop()
            else:
                print("(nothing to remove)", file=sys.stderr)
            continue
        if cmd == "!!regen":
            if not turns:
                print("(nothing to regenerate)", file=sys.stderr)
                continue
            user_ids, _ = turns.pop()
            turns.append([user_ids, run_turn(history_ids() + user_ids)])
            continue
        if cmd.startswith("!!save"):
            path = cmd[len("!!save"):].strip() or "conversation.json"
            with open(path, "w") as f:
                json.dump(turns, f)
            print(f"(saved {len(turns)} turns to {path})", file=sys.stderr)
            continue
        if cmd.startswith("!!load"):
            path = cmd[len("!!load"):].strip() or "conversation.json"
            try:
                with open(path) as f:
                    turns = [list(t) for t in json.load(f)]
                print(f"(loaded {len(turns)} turns from {path})",
                      file=sys.stderr)
            except (OSError, ValueError) as e:
                print(f"(load failed: {e})", file=sys.stderr)
            continue
        if tokenizer is not None:
            user_ids = tokenizer.encode(line)
        else:
            try:
                user_ids = [int(x) for x in line.split()]
            except ValueError:
                print("(token-id mode: enter space-separated ints)",
                      file=sys.stderr)
                continue
        try:
            reply = run_turn(history_ids() + user_ids)
        except ValueError as e:   # a request the engine cannot serve
            print()
            print(f"(refused: {e})", file=sys.stderr)
            continue
        turns.append([user_ids, reply])


if __name__ == "__main__":
    main()
