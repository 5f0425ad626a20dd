"""Where a fused-SAM decode step's time goes on one GPU.

    python3 -m samd_tpu_torch.tools.profile_step [--model llama_1b]
        [--new-tokens 128]

``--model llama_1b``: llama_1b at full width, bf16, random weights from
torch.Generator seed 0, ``FusedSamConfig()`` (block 60) over a 2048-slot
cache.  ``--model llama_7b_int4``: llama_7b at full width with packed-int4
weights requantized from an int8 base drawn from seed 0 and an int8 KV
cache, ``FusedSamConfig(n_predicts=15, corpus_capacity=4096,
cache_buckets=(256, 384, 512, 768))`` over 1024 slots.  Both take the
kernels by default; the tool runs one warm-up request, then one request of
a repetitive 96-token prompt under ``torch.profiler``.

``--model llama_7b_int4_paged``: the same llama_7b weights in batched
serving, ``PagedBatchedFusedSamEngine`` at B = 12, M = 16, 16 steps per
segment, 52 int8 pages of 128 over 1024 slots, twelve random prompts of
40-128 tokens with 128 new tokens each; the first segment (16 steps, after
the twelve prefills) is the warm-up, the second is profiled.

Prints one JSON line: per decode step the wall time, the device-busy time
(union of the kernels' intervals), the device's idle share and the kernel
launches; the device time and share of each of the port's kernels (the
int4 matmul, the verify attention, the paged attention K4); and the kernels
with the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict

# substrings of the port's own kernels' names in a profiler trace
OWN_KERNELS = {"int4_matmul": "int4_matmul_",
               "verify_attention": "flash_block_attention_kernel",
               "paged_attention": "paged_block_attention_kernel"}


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def build(model: str):
    """(label, model config, params, FusedSamConfig, max_cache_len)."""
    import torch

    from samd_tpu_torch.fused_sam import FusedSamConfig
    from samd_tpu_torch.models import init_params, llama_1b, llama_7b
    from samd_tpu_torch.ops.quant import (init_quantized_llama_params,
                                          int4_from_int8_params)

    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    if model == "llama_1b":
        cfg = llama_1b()
        return ("llama_1b bf16 flash", cfg,
                init_params(cfg, gen_w, scale=0.02, device="cuda"),
                FusedSamConfig(), 2048)
    paged = model == "llama_7b_int4_paged"
    cfg = llama_7b() if paged else dataclasses.replace(llama_7b(),
                                                       kv_quant=True)
    base = init_quantized_llama_params(cfg, gen_w, scale=0.02,
                                       dtype=torch.int8, device="cuda")
    params = int4_from_int8_params(base)
    del base
    if paged:
        return ("llama_7b int4 kernel, paged B=12 M=16, 52 int8 pages of "
                "128", cfg, params,
                FusedSamConfig(n_predicts=15, steps_per_call=16,
                               corpus_capacity=4096), 1024)
    return ("llama_7b int4 kernel, int8 KV, flash", cfg, params,
            FusedSamConfig(n_predicts=15, corpus_capacity=4096,
                           cache_buckets=(256, 384, 512, 768)), 1024)


def summarize(prof, wall_us: float, steps: int, top_n: int) -> dict:
    """Per-step figures of a profiled window of ``steps`` decode steps."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    own = {k: sum(t for n, (t, _) in by_name.items() if sub in n)
           for k, sub in OWN_KERNELS.items()}
    calls = {k: sum(c for n, (_, c) in by_name.items() if sub in n)
             for k, sub in OWN_KERNELS.items()}
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_events_per_step": len(kernels) / steps,
        "kernel_ms_per_step": {k: t / steps / 1e3 for k, t in own.items()},
        "kernel_launches_per_step": {k: c / steps for k, c in calls.items()},
        "kernel_share_of_device_time": {k: t / total if total else 0.0
                                        for k, t in own.items()},
        "top_kernels": [{"name": n[:90], "ms_per_step": t / steps / 1e3,
                         "calls_per_step": c / steps}
                        for n, (t, c) in top],
    }


def profile_paged(cfg, params, fc, S: int, top_n: int) -> dict:
    """Profile the second segment of a B = 12 paged batched run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.fused_sam import PagedBatchedFusedSamEngine

    eng = PagedBatchedFusedSamEngine(
        cfg, params, fc, batch_size=12, max_cache_len=S, eos_token_id=-1,
        prefill_buckets=(128, 256), n_pages=52, page_size=128,
        quantized_kv=True)
    rng = np.random.default_rng(0)
    for n in rng.integers(40, 129, size=12):
        eng.add_request(rng.integers(3, cfg.vocab_size, size=int(n)).tolist(),
                        GenerationConfig(max_new_tokens=128, max_cache_len=S))
    segment = eng._segment
    seen = {"segments": 0}

    def profiled_segment(*args, **kwargs):
        seen["segments"] += 1
        if seen["segments"] != 2:
            return segment(*args, **kwargs)
        torch.cuda.synchronize()
        steps0 = eng.steps_run
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = segment(*args, **kwargs)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        seen["result"] = (prof, wall_us, eng.steps_run - steps0)
        return out

    eng._segment = profiled_segment
    eng.run()
    prof, wall_us, steps = seen["result"]
    return {"batch": 12, "decode_steps": steps,
            "note": "one profiled segment of B = 12 slots, after a warm-up "
                    "segment; per-step figures are per [12, 16] forward",
            "peak_pages": eng.peak_pages,
            **summarize(prof, wall_us, steps, top_n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama_1b", "llama_7b_int4",
                                        "llama_7b_int4_paged"),
                    default="llama_1b")
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is available", file=sys.stderr)
        return 1
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.fused_sam import FusedSamEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the port's f32 products need full f32; forward raises under TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label, cfg, params, fc, S = build(args.model)
    if args.model == "llama_7b_int4_paged":
        print(json.dumps({"card": card, "model": label,
                          **profile_paged(cfg, params, fc, S, args.top)}))
        return 0
    eng = FusedSamEngine(cfg, params, fc, max_cache_len=S, eos_token_id=-1)
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab_size, size=8).tolist() * 12
    eng.generate(prompt, GenerationConfig(max_new_tokens=16))   # warm-up
    torch.cuda.synchronize()

    gen = GenerationConfig(max_new_tokens=args.new_tokens, max_cache_len=S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = eng.generate(prompt, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(json.dumps({
        "card": card, "model": label, "prompt": len(prompt),
        "new_tokens": out.decode_tokens, "decode_steps": out.decode_steps,
        "note": "per-step figures divide the whole request (prefill "
                "included) by its decode steps",
        **summarize(prof, wall_us, out.decode_steps, args.top)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
