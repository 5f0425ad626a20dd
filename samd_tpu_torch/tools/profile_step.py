"""Where a decode step's time goes on one GPU.

    python3 -m samd_tpu_torch.tools.profile_step [--model llama_1b]
        [--new-tokens 128]

``--model llama_1b``: llama_1b at full width, bf16, random weights from
torch.Generator seed 0, ``FusedSamConfig()`` (block 60) over a 2048-slot
cache.  ``--model llama_7b_int4``: llama_7b at full width with packed-int4
weights requantized from an int8 base drawn from seed 0 and an int8 KV
cache, ``FusedSamConfig(n_predicts=15, corpus_capacity=4096,
cache_buckets=(256, 384, 512, 768))`` over 1024 slots.  Both take the
kernels by default; the tool runs one warm-up request of a repetitive
96-token prompt (it captures the step's CUDA graph for the request's cache
bucket), then the same request again, whose first segment of graph
replays (``device_loop``) runs under ``torch.profiler``.

``--model llama_7b_int4_paged``: the same llama_7b weights in batched
serving, ``PagedBatchedFusedSamEngine`` at B = 12, M = 16, at most 16 steps
per segment, 52 int8 pages of 128 over 1024 slots, twelve random prompts of
40-128 tokens with 128 new tokens each; the first segment (after the twelve
prefills: the eager warm-up step, the graph's capture and its first
replays) is the warm-up, the second, all replays, is profiled.
``--model llama_7b_int4_paged_hybrid``: the same weights and prompts
through ``PagedBatchedFusedHybridEngine`` with the server's block (M 24,
a 23-node Token-Recycle tree, chains of 20, 16 steps per segment) over 64
int8 pages of 128, its harvest tables warm as a long-served engine's
(every token holds a seeded random top-8 of distinct tokens, so every tree
draft has its 23 nodes); the line adds the retrieval-chain share of the
slot-steps and the time of the harvest's top-8 over one step's [12, 24,
32000] logits by CUDA events.
``--model llama_7b_int4_paged_eagle``: the same weights and prompts through
``PagedBatchedFusedHybridEagleEngine`` with the server's block (M 24, an
EAGLE-2 tree of 23 nodes, depth 4, top-4, chains of 20) over 64 int8 pages
and a random draft net drawn from seed 7, quantized to int8; the line adds
the device time and the launches of the draft net's expansion and extension
(``torch.profiler.record_function`` ranges) per step.
``--model llama_7b_int4_tree``: the same single-stream llama_7b (int4
weights, int8 KV, 1024 slots) through the host-automaton
``engine.SamdEngine`` with ``SamdConfig(draft_source="sam_hybrid",
max_predicts=60)`` and the Token-Recycle tree drafter, its cache warm
as a long-served engine's (every token holds a harvest, seeded random
top-8 from seed 0), so every tree draft has its full 60 nodes: one
warm-up request, then the same repetitive 96-token prompt under the
profiler (chain drafts from the request's SAM where it matches, else
trees); the line gives the draft nodes per step.

The fused engines' figures are one segment of graph replays: a single
stream's without the segment's one control read, a batch's with its
upload and read; ``SamdEngine`` runs one eager step per host read.

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

# the record_function ranges around the paged SAM[EAGLE-2]'s expansion and
# extension
EAGLE_RANGES = ("eagle_expand", "eagle_extend")
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
    paged = model.startswith("llama_7b_int4_paged")
    if model == "llama_7b_int4_tree":
        model = "llama_7b_int4"
    cfg = llama_7b() if paged else dataclasses.replace(llama_7b(),
                                                       kv_quant=True)
    base = init_quantized_llama_params(cfg, gen_w, scale=0.02,
                                       dtype=torch.int8, device="cuda")
    params = int4_from_int8_params(base)
    del base
    if model == "llama_7b_int4_paged_eagle":
        from samd_tpu_torch.fused_hybrid import FusedHybridEagleConfig

        return ("llama_7b int4 kernel, paged SAM[EAGLE-2] B=12 M=24 tree 23 "
                "(depth 4, top-4), int8 draft net, 64 int8 pages of 128",
                cfg, params,
                FusedHybridEagleConfig(steps_per_call=16, eagle_depth=4,
                                       eagle_topk=4, eagle_total=23,
                                       max_block=24, n_predicts=20,
                                       corpus_capacity=4096), 1024)
    if model == "llama_7b_int4_paged_hybrid":
        from samd_tpu_torch.fused_hybrid import FusedHybridConfig

        return ("llama_7b int4 kernel, paged hybrid B=12 M=24 tree 23, 64 "
                "int8 pages of 128", cfg, params,
                FusedHybridConfig(steps_per_call=16, tree_nodes=23,
                                  n_predicts=20, max_block=24,
                                  corpus_capacity=4096), 1024)
    if paged:
        return ("llama_7b int4 kernel, paged B=12 M=16, 52 int8 pages of "
                "128", cfg, params,
                FusedSamConfig(n_predicts=15, steps_per_call=16,
                               corpus_capacity=4096), 1024)
    return ("llama_7b int4 kernel, int8 KV, flash", cfg, params,
            FusedSamConfig(n_predicts=15, corpus_capacity=4096,
                           cache_buckets=(256, 384, 512, 768)), 1024)


def device_kernels(prof, ranges=()) -> list:
    """The profile's device kernels: the CUDA events, less the device-side
    spans the profiler records for ``record_function`` ranges named in
    ``ranges``."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in ranges]


def summarize(prof, wall_us: float, steps: int, top_n: int,
              ranges=()) -> dict:
    """Per-step figures of a profiled window of ``steps`` decode steps
    (the spans of the ``record_function`` ranges in ``ranges`` are not
    kernels)."""
    kernels = device_kernels(prof, ranges)
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


def warm_harvest(harvests, seens, rng) -> None:
    """Fill Token-Recycle harvest tables [B, V + 1, K] / [B, V + 1] as a
    long-served engine holds them: every token seen, each row K distinct
    tokens from ``rng`` (a random start and stride), so every tree draft
    has its full node count; the sink row V stays unseen."""
    import numpy as np
    import torch

    B, V1, K = harvests.shape
    first = rng.integers(0, V1 - 4, size=(B, V1, 1))
    stride = rng.integers(1, (V1 - 4) // K, size=(B, V1, 1))
    harvests.copy_(torch.from_numpy(
        (3 + (first + stride * np.arange(K)) % (V1 - 4)).astype(np.int32)))
    seens.fill_(True)
    seens[:, V1 - 1] = False


def harvest_topk_ms(V: int, iters: int = 20) -> float:
    """Device ms of ``engine.harvest_topk`` (top-8 by a stable sort) over
    one B = 12, M = 24 step's f32 logits, by CUDA events."""
    import torch

    from samd_tpu_torch.engine import HARVEST_TOPK, harvest_topk

    logits = torch.randn((12, 24, V), device="cuda")
    harvest_topk(logits, HARVEST_TOPK)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        harvest_topk(logits, HARVEST_TOPK)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ranges_device(prof, names, steps: int) -> dict:
    """Per step, the device ms and the kernels of the work inside each
    ``record_function`` range of ``names``: the kernels that start within
    the range's device-side spans (one stream runs them in order)."""
    from torch.autograd import DeviceType

    kernels = device_kernels(prof, names)
    out = {}
    for name in names:
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name == name]
        inside = [k for k in kernels if any(
            s <= k.time_range.start < t for s, t in spans)]
        out[name] = {
            "device_ms_per_step": sum(k.time_range.elapsed_us()
                                      for k in inside) / steps / 1e3,
            "kernels_per_step": len(inside) / steps,
            "device_spans_found": len(spans)}
    return out


def profile_paged(cfg, params, fc, S: int, top_n: int) -> dict:
    """Profile the second segment of a B = 12 paged batched run (the
    hybrid engine for a ``FusedHybridConfig``, SAM[EAGLE-2] for a
    ``FusedHybridEagleConfig``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.fused_hybrid import (
        FusedHybridConfig, FusedHybridEagleConfig,
        PagedBatchedFusedHybridEagleEngine, PagedBatchedFusedHybridEngine)
    from samd_tpu_torch.fused_sam import PagedBatchedFusedSamEngine

    hybrid = isinstance(fc, FusedHybridConfig)
    eagle = isinstance(fc, FusedHybridEagleConfig)
    kw = dict(batch_size=12, max_cache_len=S, eos_token_id=-1,
              prefill_buckets=(128, 256), n_pages=64 if hybrid or eagle
              else 52, page_size=128, quantized_kv=True)
    if eagle:
        from samd_tpu_torch.drafters.eagle.net import (EagleNetConfig,
                                                       init_eagle_params)
        from samd_tpu_torch.ops.quant import quantize_eagle_params

        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        net = quantize_eagle_params(init_eagle_params(
            EagleNetConfig.from_target(cfg), gen, device="cuda"))
        eng = PagedBatchedFusedHybridEagleEngine(cfg, params, fc,
                                                 net_params=net, **kw)
        for name in ("_eagle_tree", "_net_extend"):
            def ranged(*a, _f=getattr(eng, name), _n=name, **k):
                with record_function(EAGLE_RANGES[name == "_net_extend"]):
                    return _f(*a, **k)
            setattr(eng, name, ranged)
    else:
        eng = (PagedBatchedFusedHybridEngine if hybrid
               else PagedBatchedFusedSamEngine)(cfg, params, fc, **kw)
    if hybrid:
        warm_harvest(eng.harvests, eng.seens, np.random.default_rng(0))
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
    outs = eng.run()
    prof, wall_us, steps = seen["result"]
    extra = {}
    if eagle:
        extra = {"retrieval_chain_share": eng.sam_steps_total
                 / max(eng.steps_total, 1),
                 "mean_accept_whole_run": sum(
                     o.decode_tokens for o in outs.values())
                 / max(eng.steps_total, 1),
                 "draft_net": ranges_device(prof, EAGLE_RANGES, steps)}
    if hybrid:
        extra = {"retrieval_chain_share": eng.sam_steps_total
                 / max(eng.steps_total, 1),
                 "mean_accept_whole_run": sum(
                     o.decode_tokens for o in outs.values())
                 / max(eng.steps_total, 1),
                 "harvest_topk_ms_12x24": harvest_topk_ms(cfg.vocab_size)}
    return {"batch": 12, "decode_steps": steps,
            "note": "one profiled segment of B = 12 slots, after a warm-up "
                    f"segment; per-step figures are per [12, {fc.block}] "
                    "forward",
            "peak_pages": eng.peak_pages, **extra,
            **summarize(prof, wall_us, steps, top_n, EAGLE_RANGES)}


def profile_segment(eng, prompt, gen, top_n: int) -> dict:
    """Profile the first segment of graph replays (at least two steps, of
    a key captured before) of one request through a single-stream engine:
    the segment's k steps from their enqueue to the device's end, without
    the segment's one control read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graphs, run, seen = eng.graphs, eng.graphs.run, {}

    def profiled_run(key, step, k):
        if seen or key not in graphs or k < 2:
            return run(key, step, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = run(key, step, k)
            torch.cuda.synchronize()
            seen["result"] = (prof, (time.perf_counter() - t0) * 1e6, k)
        return n

    graphs.run = profiled_run
    try:
        out = eng.generate(prompt, gen)
    finally:
        del graphs.run
    if "result" not in seen:
        raise RuntimeError("the request ran no segment of graph replays")
    prof, wall_us, steps = seen["result"]
    st = eng.loop_stats
    return {"prompt": len(prompt), "new_tokens": out.decode_tokens,
            "decode_steps": out.decode_steps, "segment_steps": steps,
            "host_reads": st.segments, "replays": st.replays,
            "noop_steps": st.noop_steps,
            "note": "per-step figures: one profiled segment of graph "
                    "replays (chip_smoke.py times whole requests)",
            **summarize(prof, wall_us, steps, top_n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama_1b", "llama_7b_int4",
                                        "llama_7b_int4_paged",
                                        "llama_7b_int4_paged_hybrid",
                                        "llama_7b_int4_paged_eagle",
                                        "llama_7b_int4_tree"),
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
    if args.model.startswith("llama_7b_int4_paged"):
        print(json.dumps({"card": card, "model": label,
                          **profile_paged(cfg, params, fc, S, args.top)}))
        return 0
    if args.model == "llama_7b_int4_tree":
        from samd_tpu_torch.config import SamdConfig
        from samd_tpu_torch.drafters import make_drafter
        from samd_tpu_torch.engine import SamdEngine

        label = ("llama_7b int4 kernel, int8 KV, flash, SamdEngine "
                 "sam_hybrid + Token Recycle, M = 60")
        scfg = SamdConfig(draft_source="sam_hybrid", max_predicts=60)
        drafter = make_drafter(scfg, cfg.vocab_size)
        V, K = cfg.vocab_size, drafter.tree_drafter.topk
        drafter.tree_drafter.harvest(np.arange(V), np.random.default_rng(
            0).integers(3, V, size=(V, K)))
        nodes = []
        lookup = drafter.lookup

        def counted_lookup(start_token):
            d = lookup(start_token)
            nodes.append(d.num_nodes)
            return d
        drafter.lookup = counted_lookup
        eng = SamdEngine(cfg, params, scfg, drafter, max_cache_len=S,
                         eos_token_id=-1)
    else:
        eng = FusedSamEngine(cfg, params, fc, max_cache_len=S,
                             eos_token_id=-1)
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab_size, size=8).tolist() * 12
    gen = GenerationConfig(max_new_tokens=args.new_tokens, max_cache_len=S)
    if args.model != "llama_7b_int4_tree":
        # the warm-up request captures the step's graph for this request's
        # cache bucket; the profiled request's first segment replays it
        eng.generate(prompt, gen)
        torch.cuda.synchronize()
        print(json.dumps({"card": card, "model": label,
                          **profile_segment(eng, prompt, gen, args.top)}))
        return 0
    eng.generate(prompt, GenerationConfig(max_new_tokens=16))   # warm-up
    torch.cuda.synchronize()
    nodes.clear()
    stats0 = dict(eng.stats.source_counts)
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
        "draft_steps_by_source": {
            k: v - stats0.get(k, 0)
            for k, v in eng.stats.source_counts.items()},
        "draft_nodes_per_step": {str(n): nodes.count(n)
                                 for n in sorted(set(nodes))},
        **summarize(prof, wall_us, out.decode_steps, args.top)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
