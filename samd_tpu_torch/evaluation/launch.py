"""Multi-process evaluation fan-out (counterpart of
``samd_tpu/evaluation/launch.py``).

Each worker is this module run again with ``--worker-id i``: it evaluates
its round-robin share of the questions (``shard_requests``) into
``<out>.shard{i}``, and the parent merges the shards into one answer file,
deduplicated and sorted by question_id (``runner.reorg_answer_file``).

    python -m samd_tpu_torch.evaluation.launch --question-file q.jsonl \\
        --out answers.jsonl --num-workers 2 --engine sam_only \\
        [--model-dir DIR] [--sam corpus.npz] [--cpu]

Without ``--model-dir`` the workers serve a random tiny model.  Workers
run on the CUDA card unless ``--cpu`` asks for the CPU; on one card they
share it.  Spreading workers over several cards or hosts is ROADMAP queue
1 item 16.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence, TypeVar

T = TypeVar("T")


def shard_requests(items: Sequence[T], process_id: int,
                   num_processes: int) -> List[T]:
    """Process ``process_id``'s round-robin share of ``items`` among
    ``num_processes`` (``samd_tpu/parallel/multihost.py:44-50`` with the
    ids given)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    return [x for i, x in enumerate(items) if i % num_processes == process_id]


def build_engine(args):
    """The engine a worker (or a single-process run) evaluates."""
    import torch

    from ..config import SamdConfig
    from ..drafters import make_drafter
    from ..engine import ArBaseline, SamdEngine

    device = "cpu" if args.cpu else "cuda"
    if args.model_dir:
        from ..models.loader import load_llama

        cfg, params = load_llama(args.model_dir, device=device)
    else:
        from ..models import init_params, tiny_config

        cfg = tiny_config(vocab_size=args.vocab_size)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, scale=0.4, device=device)
    kw = dict(max_cache_len=args.max_cache_len,
              eos_token_id=args.eos_token_id,
              prefill_buckets=(128, 256, 512, 1024, 2048), device=device)
    if args.engine == "ar":
        return ArBaseline(cfg, params, **kw)
    samd_cfg = SamdConfig(
        draft_source=args.engine, max_predicts=args.max_predicts,
        alpha=args.alpha, len_bias=args.len_bias,
        n_predicts=args.n_predicts, len_threshold=args.len_threshold,
        tree_method=args.tree_method)
    static_sam = None
    if args.sam:
        from ..sam import load_sam

        static_sam = load_sam(args.sam)
    drafter = make_drafter(samd_cfg, cfg.vocab_size, static_sam=static_sam,
                           model_cfg=cfg, params=params)
    return SamdEngine(cfg, params, samd_cfg, drafter, **kw)


def run_worker(args) -> dict:
    from ..config import GenerationConfig
    from .runner import load_questions, run_eval

    questions = shard_requests(load_questions(args.question_file),
                               args.worker_id, args.num_workers)
    engine = build_engine(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           max_cache_len=args.max_cache_len)
    out_path = (args.out if args.num_workers == 1
                else f"{args.out}.shard{args.worker_id}")
    return run_eval(engine, questions, out_path, gen_config=gen,
                    warmup=args.warmup, model_id=args.model_id)


def merge_shards(out: str, num_workers: int) -> None:
    from .runner import reorg_answer_file

    with open(out, "w") as fout:
        for i in range(num_workers):
            shard = f"{out}.shard{i}"
            with open(shard) as f:
                fout.write(f.read())
            os.remove(shard)
    reorg_answer_file(out)


def worker_command(args, i: int) -> List[str]:
    """The command line of worker ``i``: this module with the parent's
    arguments."""
    cmd = [sys.executable, "-m", "samd_tpu_torch.evaluation.launch",
           "--worker-id", str(i)]
    for k, v in vars(args).items():
        if k in ("worker_id", "retention_check") or v in (None, False):
            continue
        flag = "--" + k.replace("_", "-")
        cmd += [flag] if v is True else [flag, str(v)]
    return cmd


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--question-file", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--worker-id", type=int, default=None,
                   help="(internal) run as worker i instead of launching")
    p.add_argument("--engine", default="sam_only",
                   choices=["ar", "sam_only", "sam_hybrid"])
    p.add_argument("--model-dir", default=None)
    p.add_argument("--sam", default=None, help="static corpus SAM (.npz)")
    p.add_argument("--vocab-size", type=int, default=256)
    # the reference's canonical policy (scripts/inference_samd*.sh)
    p.add_argument("--max-predicts", type=int, default=60)
    p.add_argument("--alpha", type=float, default=4.0)
    p.add_argument("--len-bias", type=int, default=5)
    p.add_argument("--n-predicts", type=int, default=40)
    p.add_argument("--len-threshold", type=int, default=5)
    p.add_argument("--tree-method", default="token_recycle",
                   choices=["token_recycle", "eagle", "eagle2"])
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--max-cache-len", type=int, default=512)
    p.add_argument("--eos-token-id", type=int, default=-1)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--model-id", default="samd_tpu_torch")
    p.add_argument("--cpu", action="store_true",
                   help="run every worker on the CPU (default: the CUDA "
                        "card)")
    p.add_argument("--retention-check", action="store_true",
                   help="also run one process over every question and "
                        "report each worker's throughput against it")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.worker_id is not None or args.num_workers == 1:
        stats = run_worker(argparse.Namespace(
            **{**vars(args), "worker_id": args.worker_id or 0}))
        print(json.dumps(stats))
        return stats

    single = None
    if args.retention_check:
        single = run_worker(argparse.Namespace(
            **{**vars(args), "worker_id": 0, "num_workers": 1,
               "out": args.out + ".single"}))
        os.remove(args.out + ".single")
    procs = [subprocess.Popen(worker_command(args, i),
                              stdout=subprocess.PIPE, text=True)
             for i in range(args.num_workers)]
    outs = [q.communicate()[0] for q in procs]
    rcs = [q.returncode for q in procs]
    if any(rcs):
        raise SystemExit(f"worker failures: rcs={rcs}")
    merge_shards(args.out, args.num_workers)
    worker_stats = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    report = {"merged": args.out, "workers": args.num_workers,
              "per_worker_tokens_per_s": [
                  round(s["tokens_per_s"], 2) for s in worker_stats]}
    if single is not None:
        base = single["tokens_per_s"]
        per = [s["tokens_per_s"] for s in worker_stats]
        report.update({
            "single_process_tokens_per_s": round(base, 2),
            "aggregate_tokens_per_s": round(sum(per), 2),
            "per_worker_retention": [round(t / base, 3) if base else 0.0
                                     for t in per],
        })
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
