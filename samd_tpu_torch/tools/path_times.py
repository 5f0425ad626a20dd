"""The serving paths of a checkout's ``chip_smoke.py`` (phases 4-8), timed
on one card, to set two trees side by side in one call.

    python3 samd_tpu_torch/tools/path_times.py --root DIR [--out FILE]

Imports ``DIR/chip_smoke.py`` and ``DIR``'s ``samd_tpu_torch`` (run it as a
file, not with ``-m``, so that no other tree's package is imported first),
builds that tree's kernels and runs its phases 4 (llama_1b), 5 (llama_7b
int4, int8 KV), 6 (the paged B = 12 engine), 8 (the server; it needs 6's
requests) and 7 (llama_1b at B = 4), with every check they hold.  Each
phase prints its own lines (ms/step, tok/s, launches).  Then, with the
same code for either tree (``waves_1b``), llama_1b at B = 4 through the
dense and the paged batched engine: phase 7's six requests greedy, then
sampled (three prompts under rejection, each twice with one seed), each
wave run twice and the second timed, with its host reads and decode
steps.  The last line is one JSON object: the card, each phase's wall
seconds, the waves and the tree's detail numbers (``chip_smoke.DETAIL``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def waves_1b() -> dict:
    """llama_1b bf16 at B = 4 (phase 7's weights, requests and engines,
    without a corpus): for the dense and the paged engine, a greedy wave of
    the six requests and a sampled one (requests 0-2 under rejection at
    temperature 0.8, top_k 50, each twice with one seed), each run twice
    (the first captures the step graphs) and the second timed: ms/step
    (the wall, prefills included, over the [B, M] steps), and the host
    reads and decode steps summed over its requests."""
    import numpy as np
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine,
                                          FusedSamConfig,
                                          PagedBatchedFusedSamEngine)
    from samd_tpu_torch.models import init_params, llama_1b

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    kw = dict(batch_size=4, max_cache_len=1024, eos_token_id=-1,
              prefill_buckets=(128, 256))
    rng = np.random.default_rng(13)
    fresh = [(rng.integers(3, cfg.vocab_size, size=int(n)).tolist(), 64)
             for n in rng.integers(40, 101, size=4)]
    greedy = [(p, GenerationConfig(max_new_tokens=n, max_cache_len=1024))
              for p, n in fresh + fresh[:2]]
    sampled = [(p, GenerationConfig(
        max_new_tokens=n, max_cache_len=1024, greedy=False, temperature=0.8,
        top_k=50, seed=400 + i, accept_mode="rejection"))
        for i, (p, n) in enumerate(fresh[:3]) for _ in range(2)]
    fc = FusedSamConfig(n_predicts=15, steps_per_call=16,
                        corpus_capacity=4096)
    out = {}
    for name, make in (
            ("dense", lambda: BatchedFusedSamEngine(cfg, params, fc, **kw)),
            ("paged", lambda: PagedBatchedFusedSamEngine(
                cfg, params, fc, n_pages=32, page_size=128, **kw))):
        eng = make()
        for wave, reqs in (("greedy", greedy), ("sampled", sampled)):
            for _ in range(2):
                s0 = eng.steps_run
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ids = [eng.add_request(p, g) for p, g in reqs]
                res = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            steps = eng.steps_run - s0
            loops = [eng.loop_stats[i] for i in ids]
            row = dict(ms_per_step=wall / steps * 1e3, steps=steps,
                       new_tokens=sum(res[i].decode_tokens for i in ids),
                       host_reads=sum(st.segments for st in loops),
                       decode_steps=sum(res[i].decode_steps for i in ids),
                       replays=sum(st.replays for st in loops))
            print(f"waves_1b {name} {wave}: {row}", flush=True)
            out[f"{name}_{wave}"] = row
        del eng
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None  # before chdir
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    if "samd_tpu_torch" in sys.modules:
        raise RuntimeError("samd_tpu_torch was imported before --root")
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from samd_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.nvidia_smi()
    _build.build_all()
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        print(f"wall: {name} {walls[name]:.1f} s", flush=True)
        return out

    timed("phase 4", smoke.main_path_1b, card)
    cfg7, params7 = smoke.llama_7b_int4_params()
    timed("phase 5", smoke.main_path_7b, card, cfg7, params7)
    _, requests, oracle = timed("phase 6", smoke.main_path_7b_paged, card,
                                cfg7, params7)
    timed("phase 8", smoke.main_path_server, card, cfg7, params7, requests,
          oracle)
    del params7
    timed("phase 7", smoke.main_path_1b_batched, card)
    waves = timed("waves_1b", waves_1b)
    line = json.dumps({"root": root, "card": card, "walls_s": walls,
                       "waves_1b": waves, "detail": smoke.DETAIL},
                      default=float)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
