"""Corpus generation: instruction rows → templated prompts → this model's
responses → JSONL for ``tools.build_sam`` (counterpart of
``samd_tpu/tools/gen_corpus.py``).

The drafts a static SAM serves should look like this model's output, so
the responses come from the port's own ``BatchedFusedSamEngine``:

    python -m samd_tpu_torch.tools.gen_corpus --input instructions.jsonl \\
        --output corpus.jsonl [--model-dir HF_DIR | --synthetic] \\
        [--tokenizer DIR] [--template vicuna|alpaca|none] \\
        [--max-new-tokens 1024] [--temperature 0.8] [--top-p 0.95] \\
        [--batch 4] [--cpu]

Input rows: ``{"instruction": ..., ["input": ...]}`` (the alpaca schema),
``{"prompt": ...}``, or ``{"tokens": [...]}``.  Output rows:
``{"prompt": ..., "response": ...}`` when a tokenizer decodes them, else
``{"tokens": [...]}`` (prompt and response ids).  ``--model-dir`` loads a
local HF directory (``models.loader.load_llama``) and its tokenizer when
it has one; ``--synthetic`` a random tiny model for pipeline tests.  The
engine runs on the CUDA card unless ``--cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

ALPACA_TEMPLATE = (
    "Below is an instruction that describes a task. Write a response that "
    "appropriately completes the request.\n\n### Instruction:\n{instruction}"
    "\n\n### Response:\n")
ALPACA_INPUT_TEMPLATE = (
    "Below is an instruction that describes a task, paired with an input "
    "that provides further context. Write a response that appropriately "
    "completes the request.\n\n### Instruction:\n{instruction}\n\n"
    "### Input:\n{input}\n\n### Response:\n")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def template_prompt(row: dict, template: str) -> str:
    """The reference's prompt conventions (vicuna, alpaca, or the bare
    instruction); a ``prompt`` row passes through."""
    if "prompt" in row:
        return row["prompt"]
    instruction = row["instruction"]
    if template == "vicuna":
        from ..evaluation.codecs import VicunaCodec

        body = instruction
        if row.get("input"):
            body += "\n" + row["input"]
        return f"{VicunaCodec.SYSTEM} USER: {body} ASSISTANT:"
    if template == "alpaca":
        if row.get("input"):
            return ALPACA_INPUT_TEMPLATE.format(
                instruction=instruction, input=row["input"])
        return ALPACA_TEMPLATE.format(instruction=instruction)
    return instruction


def build_model(args, device):
    """(config, parameters, tokenizer or None) for the arguments."""
    import torch

    tokenizer = None
    if args.model_dir:
        from ..models.loader import load_llama, load_tokenizer

        cfg, params = load_llama(args.model_dir, device=device)
        tokenizer = load_tokenizer(args.model_dir)
    else:
        from ..models import init_params, tiny_config

        cfg = tiny_config(vocab_size=256)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, scale=0.4, device=device)
    if args.tokenizer:
        from .build_sam import load_text_tokenizer

        tokenizer = load_text_tokenizer(args.tokenizer)
    return cfg, params, tokenizer


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model-dir", default=None,
                   help="local HF directory (models.loader.load_llama)")
    p.add_argument("--synthetic", action="store_true",
                   help="a random tiny model (pipeline tests)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--template", default="vicuna",
                   choices=["vicuna", "alpaca", "none"])
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--eos-token-id", type=int, default=2)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.model_dir and not args.synthetic:
        p.error("--model-dir or --synthetic required")

    from ..config import GenerationConfig
    from ..fused_sam import BatchedFusedSamEngine, FusedSamConfig

    device = "cpu" if args.cpu else "cuda"
    with open(args.input) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if args.limit:
        rows = rows[:args.limit]
    log(f"{len(rows)} instruction rows")
    cfg, params, tokenizer = build_model(args, device)
    engine = BatchedFusedSamEngine(
        cfg, params, FusedSamConfig(), batch_size=args.batch,
        max_cache_len=args.max_cache_len, eos_token_id=args.eos_token_id,
        device=device)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, max_cache_len=args.max_cache_len,
        greedy=args.temperature <= 0.0,
        temperature=max(args.temperature, 0.0), top_p=args.top_p)

    prompts, id_lists = [], []
    for row in rows:
        if "tokens" in row:
            prompts.append(None)
            id_lists.append(list(row["tokens"]))
            continue
        if tokenizer is None:
            raise SystemExit("text rows need a tokenizer (--tokenizer, or "
                             "a --model-dir that holds one); or give token "
                             "rows")
        text = template_prompt(row, args.template)
        prompts.append(text)
        id_lists.append(tokenizer.encode(text))

    rids = [engine.add_request(ids, gen) for ids in id_lists]
    log("generating responses (batched fused engine)...")
    results = engine.run()
    with open(args.output, "w") as out:
        for text, ids, rid in zip(prompts, id_lists, rids):
            res = results[rid]
            if text is None or tokenizer is None:
                out.write(json.dumps({"tokens": list(res.output_ids)})
                          + "\n")
            else:
                out.write(json.dumps({
                    "prompt": text,
                    "response": tokenizer.decode(
                        res.output_ids[len(ids):], skip_special_tokens=True),
                }) + "\n")
    log(f"wrote {len(rows)} rows to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
