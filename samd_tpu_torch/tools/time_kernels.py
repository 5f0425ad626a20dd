"""Time the port's kernels at llama_7b's and llama_1b's path shapes with two
timers, for this checkout or another one.

    python3 samd_tpu_torch/tools/time_kernels.py [--root DIR] [--label NAME]
        [--only k3|attention]

Imports ``samd_tpu_torch`` from DIR (default: the checkout holding this
script), so one call can time two checkouts' kernels in turns with the same
timers.  Two sets, each beside one PyTorch library call as a yardstick:

- the int4 matmul (K3) at every llama_7b projection and head shape
  (4096→4096, 4096→11008, 11008→4096; the head 4096→32000 with f32 out) and
  R = 16, 128, 192 and 256 bf16 rows; library: one bf16 ``torch.matmul`` on
  the weight dequantized beforehand.  The weights cycle over enough stacked
  layers to exceed the L2 cache, as a forward finds each weight cold;
- the verify attention and its paged mode (K1/K2, the int8-KV mode, K4) at
  the six shapes of ``ATTENTION`` and ``PAGED`` (bf16 q); library:
  ``scaled_dot_product_attention`` over the same live columns (per active
  slot in paged mode, on its gathered KV, dequantized in int8 mode).

Timers:

- ``event_ms``: CUDA events around 50 calls, the stream held by a sleep
  kernel while the host enqueues them (the timer behind every time
  ``chip_smoke.py`` prints);
- ``device_ms``: the device time of every kernel those calls ran, summed
  from ``torch.profiler`` (CUPTI) over 20 calls, per call.

Prints a line per shape and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = (("wq/wk/wv/wo", 4096, 4096, "bfloat16"),
          ("w_gate/w_up", 4096, 11008, "bfloat16"),
          ("w_down", 11008, 4096, "bfloat16"),
          ("lm_head", 4096, 32000, "float32"))
ROWS = (16, 128, 192, 256)
L2_BYTES = 50 << 20                       # H100 L2 cache
SLEEP_CYCLES = 100_000_000                # ~50 ms at the H100's clocks


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms of ``fn(i)`` between two CUDA events, the stream held by a
    sleep kernel while the host enqueues the calls."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 20, warmup: int = 5):
    """(device ms per call of the kernels ``fn(i)`` ran, kernels per call),
    from the profiler's CUDA kernel records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / iters / 1e3, len(kernels) / iters


# verify attention, bf16 q: (label, T, NH, KH, D, S, cache_len, prefill,
# int8 k/v) -- K2's shape off the paths, then the paths' own
ATTENTION = (
    ("K2 KH 32 T 60 cache_len 700, bf16", 60, 32, 32, 128, 2048, 700, False,
     False),
    ("int8-KV llama_7b T 16 cache_len 200", 16, 32, 32, 128, 1024, 200, False,
     True),
    ("K1 llama_1b T 60 cache_len 160", 60, 32, 4, 64, 2048, 160, False, False),
    ("K2 T 128 prefill over S 128", 128, 32, 32, 128, 128, 0, True, False),
)
# paged (K4), bf16 q: (label, B, T, NH, KH, D, page, committed lengths, int8)
PAGED = (
    ("K4 bf16 pool llama_1b B 4", 4, 16, 32, 4, 64, 128,
     [300, None, 64, 1008], False),
    ("K4 int8 pool llama_7b B 12", 12, 16, 32, 32, 128, 128,
     [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700, 1008], True),
)


def attention_case(T, NH, KH, D, S, cache_len, dtype, seed, prefill=False,
                   parents=None):
    """q, k, v, mask, kv_limit of the verify attention on the card: normal
    values from ``seed``, a tree block at ``cache_len`` (random, or the
    tree of ``parents``, self-parent padding allowed), or the prefill
    mask."""
    import numpy as np
    import torch

    from samd_tpu_torch.models.llama import block_decode_mask, prefill_mask
    from samd_tpu_torch.ops.treeops import tree_mask_from_parents

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = normal(1, T, NH, D), normal(1, KH, S, D), normal(1, KH, S, D)
    if prefill:
        mask = prefill_mask(1, T, S, "cuda").contiguous()
    else:
        if parents is None:
            rng = np.random.default_rng(seed)
            parents = [-1] + [int(rng.integers(0, i)) for i in range(1, T)]
        tree = tree_mask_from_parents(torch.tensor(parents)).cuda()
        mask = block_decode_mask(tree, cache_len, S).contiguous()
    kv_limit = torch.tensor(cache_len + T, dtype=torch.int32, device="cuda")
    return q, k, v, mask, kv_limit


def library_attention(q, k, v, mask, kv_limit):
    """scaled_dot_product_attention over the same live columns (a
    yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    _, T, NH, D = q.shape
    KH = k.shape[1]
    lim = int(kv_limit)
    col = torch.arange(lim, device=q.device)
    allowed = (col < lim - T) | mask[0, :, :lim]
    ql = q.transpose(1, 2)
    kl = k[:, :, :lim].repeat_interleave(NH // KH, dim=1)
    vl = v[:, :, :lim].repeat_interleave(NH // KH, dim=1)
    m = allowed[None, None]
    return lambda i: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m)


def paged_case(B, T, NH, KH, D, page, committed, dtype, int8, seed,
               parents=None):
    """A page pool on the card with shuffled tables: slot b holds
    ``committed[b]`` tokens plus its block of T (None: an inactive slot,
    table all -1, kv_limit T), a random tree block mask per slot (or the
    tree of ``parents`` in every slot).  Returns
    (the arguments of paged_block_attention, the active slots, the pages in
    no table plus the scratch page)."""
    import numpy as np
    import torch

    from samd_tpu_torch.cache import quantize_kv_block
    from samd_tpu_torch.ops.paged_attention import boundary_mask_window
    from samd_tpu_torch.ops.treeops import tree_mask_from_parents

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    lims = [T + (c or 0) for c in committed]
    # table width: a 1024-slot cache or the longest slot, with pad
    P = -(-max([1024] + lims) // page) + -(-T // page) + 1
    used = sum(-(-lim // page) for c, lim in zip(committed, lims)
               if c is not None)
    n_pages = used + 5

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    kp = normal(n_pages + 1, KH, page, D)
    vp = normal(n_pages + 1, KH, page, D)
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = (quantize_kv_block(t) for t in (kp, vp))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    perm = rng.permutation(n_pages)
    tables = np.full((B, P), -1, np.int32)
    at = 0
    for b, (c, lim) in enumerate(zip(committed, lims)):
        if c is not None:
            npg = -(-lim // page)
            tables[b, :npg] = perm[at:at + npg]
            at += npg
    wins = []
    for b in range(B):
        par = parents if parents is not None else \
            [-1] + [int(rng.integers(0, i)) for i in range(1, T)]
        tree = tree_mask_from_parents(torch.tensor(par)).cuda()
        wins.append(boundary_mask_window(tree, committed[b] or 0, page))
    args = (normal(B, T, NH, D).to(dtype), kp, vp,
            torch.from_numpy(tables).cuda(), torch.stack(wins).contiguous(),
            torch.tensor(lims, dtype=torch.int32, device="cuda"), ks, vs)
    active = [b for b, c in enumerate(committed) if c is not None]
    spare = sorted(set(range(n_pages)) - set(perm[:at].tolist()))
    return args, active, spare + [n_pages]


def library_paged(args, active, page):
    """scaled_dot_product_attention per active slot on its gathered live KV
    (dequantized from an int8 pool): the paged kernel's yardstick."""
    import torch
    import torch.nn.functional as F

    from samd_tpu_torch.ops.paged_attention import (gather_pages,
                                                    window_to_mask)

    q, kp, vp, tables, win, lims, ks, vs = args
    T, NH = q.shape[1], q.shape[2]
    G = NH // kp.shape[1]
    dense = []
    for b in active:
        tb = tables[b:b + 1]
        kd, vd = gather_pages(kp, tb), gather_pages(vp, tb)
        if ks is not None:
            kd = (kd.float() * gather_pages(ks, tb)[..., None]).to(q.dtype)
            vd = (vd.float() * gather_pages(vs, tb)[..., None]).to(q.dtype)
        mask = window_to_mask(win[b:b + 1], lims[b:b + 1], T, page,
                              kd.shape[2])
        lim = int(lims[b])
        dense.append((q[b:b + 1].transpose(1, 2),
                      kd[:, :, :lim].repeat_interleave(G, dim=1),
                      vd[:, :, :lim].repeat_interleave(G, dim=1),
                      mask[:, None, :, :lim]))

    def run(i):
        for ql, kl, vl, m in dense:
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m)
    return run


def time_pair(label, kernel, library, card, extra=None):
    """Both timers on a kernel and its library yardstick; prints a line and
    returns the row."""
    k_dev, k_n = device_ms(kernel)
    lib_dev, lib_n = device_ms(library)
    row = {"shape": label, **(extra or {}),
           "kernel_event_ms": event_ms(kernel), "kernel_device_ms": k_dev,
           "kernel_kernels_per_call": k_n,
           "library_event_ms": event_ms(library),
           "library_device_ms": lib_dev, "library_kernels_per_call": lib_n}
    print(f"{label}: kernel event {row['kernel_event_ms']:.4f} device "
          f"{k_dev:.4f} ms ({k_n:g} kernels/call); library event "
          f"{row['library_event_ms']:.4f} device {lib_dev:.4f} ms [{card}]",
          flush=True)
    return row


def time_k3(card: str, label: str) -> list:
    import torch

    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.quant import Int4Tensor, dequant

    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name, IN, OUT, out_name in SHAPES:
        out_dtype = getattr(torch, out_name)
        L = max(2, math.ceil(2 * L2_BYTES / (IN * OUT // 2)))
        packed = torch.randint(0, 256, (L, IN, OUT // 2), generator=gen,
                               dtype=torch.uint8, device="cuda")
        scale = torch.rand((L, OUT), generator=gen, device="cuda") * 4e-3 \
            + 1e-3
        w16 = [dequant(Int4Tensor(packed[l], scale[l]), torch.bfloat16)
               for l in range(L)]
        for R in ROWS:
            x = torch.randn((R, IN), generator=gen, device="cuda").to(
                torch.bfloat16)

            def k3(i):
                return int4_matmul(x, packed, scale, i % L,
                                   out_dtype=out_dtype)

            def library(i):
                return torch.matmul(x, w16[i % L])

            rows.append(time_pair(f"{label} K3 {name} R={R}", k3, library,
                                  card, {"in": IN, "out": OUT, "R": R}))
        del packed, scale, w16
        torch.cuda.empty_cache()
    return rows


def time_attention(card: str, label: str) -> list:
    import torch

    from samd_tpu_torch.cache import QuantizedKV, dequantize_kv
    from samd_tpu_torch.cache import quantize_kv_block
    from samd_tpu_torch.ops.flash_attention import flash_block_attention
    from samd_tpu_torch.ops.paged_attention import paged_block_attention

    rows = []
    for i, (name, T, NH, KH, D, S, cl, pre, int8) in enumerate(ATTENTION):
        q, k, v, mask, lim = attention_case(T, NH, KH, D, S, cl,
                                            torch.float32, seed=200 + i,
                                            prefill=pre)
        q = q.to(torch.bfloat16)
        if int8:
            (kq, ks), (vq, vs) = (quantize_kv_block(t) for t in (k, v))
            args = (q, kq, vq, mask, lim, ks, vs)
            k = dequantize_kv(QuantizedKV(kq, ks), torch.bfloat16)
            v = dequantize_kv(QuantizedKV(vq, vs), torch.bfloat16)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            args = (q, k, v, mask, lim)
        rows.append(time_pair(
            f"{label} {name}", lambda i: flash_block_attention(*args),
            library_attention(q, k, v, mask, lim), card))
    for name, B, T, NH, KH, D, page, committed, int8 in PAGED:
        args, active, _ = paged_case(B, T, NH, KH, D, page, committed,
                                     torch.bfloat16, int8, seed=300 + B)
        rows.append(time_pair(
            f"{label} {name}", lambda i: paged_block_attention(*args),
            library_paged(args, active, page), card))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose samd_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--only", choices=("k3", "attention"), default=None,
                    help="time one set only")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "root": str(root), "card": card}
    if args.only in (None, "attention"):
        out["attention"] = time_attention(card, args.label)
    if args.only in (None, "k3"):
        out["k3"] = time_k3(card, args.label)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
