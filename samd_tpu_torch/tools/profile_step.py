"""Where a fused-SAM decode step's time goes on one GPU.

    python3 -m samd_tpu_torch.tools.profile_step [--model llama_1b]
        [--new-tokens 128]

``--model llama_1b``: llama_1b at full width, bf16, random weights from
torch.Generator seed 0, ``FusedSamConfig()`` (block 60) over a 2048-slot
cache.  ``--model llama_7b_int4``: llama_7b at full width with packed-int4
weights requantized from an int8 base drawn from seed 0 and an int8 KV
cache, ``FusedSamConfig(n_predicts=15, corpus_capacity=4096,
cache_buckets=(256, 384, 512, 768))`` over 1024 slots.  Both take the
kernels by default.  The tool runs one warm-up request, then one request of
a repetitive 96-token prompt under ``torch.profiler``, and prints one JSON
line: per decode step the wall time, the device-busy time (union of the
kernels' intervals), the device's idle share and the kernel launches; the
share of device time in the int4 matmul and the verify attention kernels;
and the kernels with the most device time.  Needs a CUDA device.
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
OWN_KERNELS = {"int4_matmul": "int4_matmul_kernel",
               "verify_attention": "flash_block_attention_kernel"}


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
    cfg = dataclasses.replace(llama_7b(), kv_quant=True)
    base = init_quantized_llama_params(cfg, gen_w, scale=0.02,
                                       dtype=torch.int8, device="cuda")
    params = int4_from_int8_params(base)
    del base
    return ("llama_7b int4 kernel, int8 KV, flash", cfg, params,
            FusedSamConfig(n_predicts=15, corpus_capacity=4096,
                           cache_buckets=(256, 384, 512, 768)), 1024)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama_1b", "llama_7b_int4"),
                    default="llama_1b")
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    total = sum(t for t, _ in by_name.values())
    steps = out.decode_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    own = {k: sum(t for n, (t, _) in by_name.items() if sub in n)
           for k, sub in OWN_KERNELS.items()}
    print(json.dumps({
        "card": card, "model": label, "prompt": len(prompt),
        "new_tokens": out.decode_tokens, "decode_steps": steps,
        "note": "per-step figures divide the whole request (prefill "
                "included) by its decode steps",
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_events_per_step": len(kernels) / steps,
        "kernel_ms_per_step": {k: t / steps / 1e3 for k, t in own.items()},
        "kernel_share_of_device_time": {k: t / total if total else 0.0
                                        for k, t in own.items()},
        "top_kernels": [{"name": n[:90], "ms_per_step": t / steps / 1e3,
                         "calls_per_step": c / steps}
                        for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
