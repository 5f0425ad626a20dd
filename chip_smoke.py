#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (samd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card: name and power limit, torch and CUDA versions, TF32 flags;
  2. build: compile every kernel from samd_tpu_torch/csrc, one nvcc per
     source, all started together; print nvcc's seconds and ptxas's
     register and spill lines; cuobjdump -sass must show HMMA in each of
     the verify source's 32 bf16-q instantiations;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the main paths' shapes, check that two runs are bitwise equal, and
     time the kernel, the plain version and one PyTorch library call beside
     the least time the card could take:
     a. the verify attention, k/v of q's type, at llama_1b and llama_7b
        shapes (T = 16 at G = 1: the kernel's column-quarter layout), and
        llama_7b's bf16 T = 128 prefill into the paged engine's 128-slot
        cache; poison past kv_limit must change nothing, and the same live
        prefix in a cache cut to max(256, kv_limit rounded up to 64)
        columns must give the same bits;
     b. its int8-KV mode at llama_7b decode shapes, the T = 128 prefill
        shape, and one llama_1b shape; int8 bytes of 127 and scales of 1e30
        past kv_limit change nothing; the same cut-cache check;
     c. the int4 matmul at every llama_7b projection and head shape, at
        16, 128, 192 and 256 rows (decode, the prefill buckets 128 and 256,
        and B * M = 12 * 16 rows of batched serving), in bf16 and f32
        output; row invariance: a row alone, or placed at another row of
        another block, gives the same bits, and every 16-row block of an R
        = 192 call equals the same rows run at R = 16; ragged R = 1, 13
        and 200 (w_gate, head) and an f32 x (the CUDA-core body) within
        the bound; a model of the tensor-core kernel's order and rounding
        falls inside the bound, and two planted faults in it outside;
     d. the paged verify attention (K4) over a page pool with shuffled
        tables and inactive slots: llama_7b B = 12 over int8 pages and
        llama_1b B = 4 over pages of q's type, bf16 and f32 q; each active
        slot bitwise equal to the verify kernel on its gathered dense KV;
        poison past kv_limit, in pages outside the tables and in the
        scratch page changes nothing;
  4. llama_1b path: greedy FusedSamEngine at full width (bf16, random
     weights from torch.Generator seed 0) answers three requests of 128 new
     tokens, each equal to ArBaseline(block_size=60)'s bit for bit; every
     forward went through the verify kernel;
  5. llama_7b path: llama_7b at full width with packed-int4 weights
     (requantized from an int8 base drawn on the card from seed 0) and an
     int8 KV cache, FusedSamConfig(n_predicts=15, corpus_capacity=4096,
     cache_buckets=(256, 384, 512, 768)) over max_cache_len 1024, answers
     three requests of 128 new tokens, each equal to
     ArBaseline(block_size=16)'s bit for bit; every forward went through the
     int4 kernel (225 launches) and, at T <= 128, the int8-KV verify kernel
     (32 launches).  Before it, a prefill of request (a)'s 200-token prompt
     (bucket 256, through the plain attention) into a 384-slot and a
     1024-slot cache must agree bitwise;
  6. llama_7b paged batched path: the same weights, a kv_quant=False
     config, PagedBatchedFusedSamEngine at B = 12, M = 16, 16 steps per
     segment, 52 int8 pages of 128, buckets 128 and 256, answers 16 requests
     (budgets 32-128, one 200-token prompt, four repeats of earlier
     prompts whose corpus holds their oracle output), each equal to the same
     engine's alpha = 0 oracle bit for bit; every page comes back; K4 int8
     launches 32 per step, the bf16 verify 32 per P = 128 prefill, K3 225
     per forward;
  7. llama_1b batched paths: BatchedFusedSamEngine (dense) and
     PagedBatchedFusedSamEngine (bf16 pages of 128) at B = 4 answer six
     requests of 64 new tokens, each equal to its own alpha = 0 oracle.
Then a JSON line of kernels, the nvidia-smi line, and last the device line.
Without a CUDA device it exits 1 before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # f32 outside the tensor cores
L2_BYTES = 50 << 20                       # H100 L2 cache
# Kernel vs plain version is held per element:
#  - verify attention (both modes): ops.flash_attention.kernel_tolerance —
#    1e-4 in f32 (another summation order); in bf16, one rounding of the
#    output, 2^-7 |ref|, over a floor of two bf16 ulps of max |ref|;
#  - int4 matmul: ops.int4_matmul.kernel_tolerance — for x of independent
#    zero-mean entries, two f32 sums of the same products in different
#    orders: 2 * 8 * 2^-24 * sqrt(in) * sqrt(x^2 @ (q-8)^2) * scale, plus
#    the scale multiply's rounding, 2^-23 |ref|; a bf16 output adds one
#    rounding, 2^-7 (1.01 |ref| + that bound).  The tensor-core kernel's
#    order (16-k sums with the mma's alignment truncation modelled, eight
#    slices per CTA, k_splits CTAs: ops.int4_matmul.mma_order_sum) must
#    fall inside it and two planted faults (one k dropped per slice, each
#    slice's partial rounded to bf16) outside it at every llama_7b shape.


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms of ``fn(i)`` over ``iters`` calls (i = call index),
    the stream held by a sleep kernel while the host enqueues them:
    ``samd_tpu_torch.tools.time_kernels.event_ms``."""
    from samd_tpu_torch.tools.time_kernels import event_ms

    return event_ms(fn, iters, warmup)


def bound(nbytes: float, flops: float, dtype_name: str):
    """The least time for this work: bytes over the memory rate against
    operations over the peak rate for their type; (ms, which bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise SystemExit(msg)


def attention_bound(T, NH, KH, D, kv_limit, dtype_name, kv_bytes=None):
    """Each input byte read once (q, the live K/V and, in int8 mode, their
    scales, the mask's boundary window, kv_limit), the output written once,
    against the operations of both products."""
    isz = 2 if dtype_name == "bfloat16" else 4
    kvb = kv_bytes if kv_bytes is not None else 2 * kv_limit * KH * D * isz
    nbytes = (T * NH * D * isz + kvb + T * min(T, kv_limit) + 4
              + T * NH * D * isz)
    return bound(nbytes, 4 * NH * T * D * kv_limit, dtype_name)


def check_close(label, got, ref, tol, again=None):
    """Fail unless got is finite, within tol of ref per element and, when
    given, bitwise equal to a second run; returns max |got - ref|."""
    import torch

    diff = (got.float() - ref.float()).abs()
    fail_if(not torch.isfinite(got).all(), f"{label}: non-finite output")
    if (diff > tol).any():
        i = int(torch.argmax(diff - tol))
        raise SystemExit(f"{label}: |kernel - plain| {diff.flatten()[i].item()}"
                         f" > tolerance {tol.flatten()[i].item()} at flat "
                         f"index {i}")
    fail_if(again is not None and not torch.equal(got, again),
            f"{label}: two runs differ")
    return diff.max().item(), tol.flatten()[int(diff.argmax())].item()


def s_invariance(label, dname, got, S, kv, q, k, v, mask, lim,
                 scales=()) -> str:
    """Fail unless the same live prefix in a cache cut to S' = max(256,
    kv_limit rounded up to 64) columns gives ``got``'s bits (the single-
    stream engine moves a request between cache buckets); a note for the
    kernel's line, empty where S' is not below S."""
    import torch

    from samd_tpu_torch.ops.flash_attention import flash_block_attention

    cut = max(256, -(-kv // 64) * 64)
    if cut >= S:
        return ""
    small = flash_block_attention(
        q, k[:, :, :cut].contiguous(), v[:, :, :cut].contiguous(),
        mask[:, :, :cut].contiguous(), lim,
        *(t[:, :, :cut].contiguous() for t in scales))
    fail_if(not torch.equal(got, small),
            f"{label} {dname}: S = {cut} and S = {S} give different bits")
    return f" S-invariant (S = {cut} equals S = {S})"


def check_kernels(card: str) -> dict:
    """Phase 3a: the verify attention with k/v of q's type."""
    import torch

    from samd_tpu_torch.ops.flash_attention import (
        flash_block_attention, flash_block_attention_ref, kernel_tolerance)
    from samd_tpu_torch.tools.time_kernels import (attention_case,
                                                   library_attention)

    cases = []   # (label, T, NH, KH, D, S, cache_len, prefill)
    for cl in (0, 63, 64, 160, 700, 2048 - 60):
        cases.append((f"llama_1b T=60 cache_len={cl}", 60, 32, 4, 64, 2048,
                      cl, False))
    cases.append(("llama_1b T=1 cache_len=300", 1, 32, 4, 64, 2048, 300,
                  False))
    cases.append(("llama_1b T=128 prefill", 128, 32, 4, 64, 2048, 0, True))
    cases.append(("llama_7b T=60 cache_len=700 (KH>=8)", 60, 32, 32, 128,
                  2048, 700, False))
    # bf16 k/v at llama_7b decode: the column-quarter layout (R = 16)
    cases.append(("llama_7b T=16 cache_len=200 (KH>=8)", 16, 32, 32, 128,
                  1024, 200, False))
    # the paged engine's prefill: a bf16 batch-1 cache of P = 128 slots
    cases.append(("llama_7b T=128 prefill S=128 (KH>=8)", 128, 32, 32, 128,
                  128, 0, True))
    main_label = "llama_1b T=60 cache_len=160"
    row = None
    max_err_main = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (label, T, NH, KH, D, S, cl, pre) in enumerate(cases):
            q, k, v, mask, lim = attention_case(T, NH, KH, D, S, cl, dtype,
                                                seed=i, prefill=pre)
            got = flash_block_attention(q, k, v, mask, lim)
            ref = flash_block_attention_ref(q, k, v, mask, lim)
            again = flash_block_attention(q, k, v, mask, lim)
            torch.cuda.synchronize()
            err, tol_at = check_close(f"{label} {dname}", got, ref,
                                      kernel_tolerance(ref), again)
            kv = cl + T
            if kv < S:
                k2, v2 = k.clone(), v.clone()
                k2[:, :, kv:] = 1e30
                v2[:, :, kv:] = -1e30
                poisoned = flash_block_attention(q, k2, v2, mask, lim)
                fail_if(not torch.equal(got, poisoned),
                        f"{label} {dname}: poison past kv_limit changed the "
                        "result")
            s_note = s_invariance(label, dname, got, S, kv, q, k, v, mask,
                                  lim)
            ms = cuda_ms(lambda i: flash_block_attention(q, k, v, mask, lim))
            plain_ms = cuda_ms(
                lambda i: flash_block_attention_ref(q, k, v, mask, lim))
            library_ms = cuda_ms(library_attention(q, k, v, mask, lim))
            bound_ms, bound_by = attention_bound(T, NH, KH, D, kv, dname)
            print(f"kernel flash_block_attention {label} {dname}: max_abs_err "
                  f"{err:.3e} (tol at that element {tol_at:.3e}) kernel_ms "
                  f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})"
                  f"{s_note} [{card}]", flush=True)
            if dname == "bfloat16" and (label.startswith("llama_1b")
                                        or "S=128" in label):   # on paths
                max_err_main = max(max_err_main, err)
            if dname == "bfloat16" and label == main_label:
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
    row["max_abs_err"] = max_err_main
    return row


def check_int8_attention(card: str) -> dict:
    """Phase 3b: the verify attention's int8-KV mode."""
    import torch

    from samd_tpu_torch.cache import QuantizedKV, dequantize_kv
    from samd_tpu_torch.cache import quantize_kv_block
    from samd_tpu_torch.ops.flash_attention import (
        flash_block_attention, flash_block_attention_ref, kernel_tolerance)
    from samd_tpu_torch.tools.time_kernels import (attention_case,
                                                   library_attention)

    cases = [(f"llama_7b T=16 cache_len={cl}", 16, 32, 32, 128, 1024, cl,
              False) for cl in (0, 63, 200, 700, 1008)]
    cases.append(("llama_7b T=128 prefill", 128, 32, 32, 128, 1024, 0, True))
    cases.append(("llama_1b T=60 cache_len=700", 60, 32, 4, 64, 2048, 700,
                  False))
    main_label = "llama_7b T=16 cache_len=200"
    row, max_err = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (label, T, NH, KH, D, S, cl, pre) in enumerate(cases):
            q, k, v, mask, lim = attention_case(T, NH, KH, D, S, cl,
                                                torch.float32, seed=100 + i,
                                                prefill=pre)
            q = q.to(dtype)
            (kq, ks), (vq, vs) = (quantize_kv_block(t) for t in (k, v))
            args = (q, kq, vq, mask, lim, ks, vs)
            got = flash_block_attention(*args)
            ref = flash_block_attention_ref(*args)
            again = flash_block_attention(*args)
            torch.cuda.synchronize()
            err, tol_at = check_close(f"{label} int8-KV {dname}", got, ref,
                                      kernel_tolerance(ref), again)
            kv = cl + T
            if kv < S:
                kq2, vq2, ks2, vs2 = (t.clone() for t in (kq, vq, ks, vs))
                kq2[:, :, kv:] = 127
                vq2[:, :, kv:] = -127
                ks2[:, :, kv:] = 1e30
                vs2[:, :, kv:] = 1e30
                poisoned = flash_block_attention(q, kq2, vq2, mask, lim, ks2,
                                                 vs2)
                fail_if(not torch.equal(got, poisoned),
                        f"{label} int8-KV {dname}: poison past kv_limit "
                        "changed the result")
            s_note = s_invariance(f"{label} int8-KV", dname, got, S, kv, q,
                                  kq, vq, mask, lim, (ks, vs))
            ms = cuda_ms(lambda i: flash_block_attention(*args))
            plain_ms = cuda_ms(lambda i: flash_block_attention_ref(*args))
            kd = dequantize_kv(QuantizedKV(kq, ks), dtype)
            vd = dequantize_kv(QuantizedKV(vq, vs), dtype)
            library_ms = cuda_ms(library_attention(q, kd, vd, mask, lim))
            bound_ms, bound_by = attention_bound(
                T, NH, KH, D, kv, dname, kv_bytes=2 * kv * KH * (D + 4))
            print(f"kernel flash_block_attention int8-KV {label} {dname}: "
                  f"max_abs_err {err:.3e} (tol at that element {tol_at:.3e}) "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} (SDPA, dequantized live KV) bound_ms "
                  f"{bound_ms:.5f} ({bound_by}){s_note} [{card}]", flush=True)
            if dname == "bfloat16" and label.startswith("llama_7b"):
                max_err = max(max_err, err)
            if dname == "bfloat16" and label == main_label:
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
    row["max_abs_err"] = max_err
    return row


def check_int4_rows(name, packed, scale, out_dtype, x192, gen) -> None:
    """Phase 3c's row checks at one shape: each 16-row block of an R = 192
    call bitwise equal to the same rows run at R = 16 (one row tile against
    64-row tiles); ragged R = 1, 13 and 200 (w_gate and the head) and an
    f32 x (the CUDA-core body) within the bound, bitwise repeatable."""
    import torch

    from samd_tpu_torch.ops.int4_matmul import (int4_matmul,
                                                int4_matmul_ref,
                                                kernel_tolerance)

    IN = packed.shape[1]
    big = int4_matmul(x192, packed, scale, 0, out_dtype=out_dtype)
    for a in (0, 56, 176):
        small = int4_matmul(x192[a:a + 16].contiguous(), packed, scale, 0,
                            out_dtype=out_dtype)
        fail_if(not torch.equal(small, big[a:a + 16]),
                f"int4_matmul {name}: rows {a}..{a + 15} differ between R = "
                "16 and R = 192")
    cases = [(13, torch.float32), (16, torch.float32)]
    if name in ("w_gate/w_up", "lm_head"):
        cases += [(1, torch.bfloat16), (13, torch.bfloat16),
                  (200, torch.bfloat16)]
    for R, xdt in cases:
        x = torch.randn((R, IN), generator=gen, device="cuda").to(xdt)
        for dt in (torch.bfloat16, torch.float32):
            got = int4_matmul(x, packed, scale, 0, out_dtype=dt)
            again = int4_matmul(x, packed, scale, 0, out_dtype=dt)
            ref = int4_matmul_ref(x, packed, scale, 0, out_dtype=dt)
            torch.cuda.synchronize()
            err, _ = check_close(
                f"int4_matmul {name} R={R} {str(xdt).split('.')[1]} x "
                f"{str(dt).split('.')[1]} out", got, ref,
                kernel_tolerance(x, packed, scale, 0, ref), again)
        print(f"int4_matmul {name} R={R} {str(xdt).split('.')[1]} x: within "
              f"the bound in both output types (f32-out err {err:.3e})",
              flush=True)
    print(f"int4_matmul {name}: R = 16 blocks bitwise equal inside R = 192",
          flush=True)


def check_int4(card: str) -> dict:
    """Phase 3c: the int4 matmul at llama_7b's shapes.  Timing cycles over
    enough stacked layers to exceed the L2 cache, as the forward finds each
    weight cold."""
    import torch

    from samd_tpu_torch.ops.int4_matmul import (int4_matmul,
                                                int4_matmul_ref, k_splits,
                                                kernel_tolerance,
                                                mma_order_sum)
    from samd_tpu_torch.ops.quant import Int4Tensor, dequant, unpack4

    shapes = [("wq/wk/wv/wo", 4096, 4096, torch.bfloat16),
              ("w_gate/w_up", 4096, 11008, torch.bfloat16),
              ("w_down", 11008, 4096, torch.bfloat16),
              ("lm_head", 4096, 32000, torch.float32)]
    main_label = "w_gate/w_up R=16"
    row, max_err = None, 0.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name, IN, OUT, out_dtype in shapes:
        layer_bytes = IN * OUT // 2
        L = max(2, math.ceil(2 * L2_BYTES / layer_bytes))
        packed = torch.randint(0, 256, (L, IN, OUT // 2), generator=gen,
                               dtype=torch.uint8, device="cuda")
        scale = torch.rand((L, OUT), generator=gen, device="cuda") * 4e-3 \
            + 1e-3
        w16 = [dequant(Int4Tensor(packed[l], scale[l]), torch.bfloat16)
               for l in range(L)]
        xs = {}
        for R in (16, 128, 192, 256):
            label = f"{name} R={R}"
            x = torch.randn((R, IN), generator=gen, device="cuda").to(
                torch.bfloat16)
            xs[R] = x
            errs = {}
            for dt in (out_dtype, torch.float32 if out_dtype
                       == torch.bfloat16 else torch.bfloat16):
                got_dt = int4_matmul(x, packed, scale, 0, out_dtype=dt)
                again = int4_matmul(x, packed, scale, 0, out_dtype=dt)
                ref = int4_matmul_ref(x, packed, scale, 0, out_dtype=dt)
                torch.cuda.synchronize()
                tol = kernel_tolerance(x, packed, scale, 0, ref)
                errs[dt] = check_close(
                    f"int4_matmul {label} {str(dt).split('.')[1]} out",
                    got_dt, ref, tol, again)
                if dt == out_dtype:
                    got = got_dt
                if dt == torch.float32 and R == 16:     # planted faults
                    q = unpack4(packed[0]).float()
                    splits = k_splits(IN, OUT // 2)
                    order = mma_order_sum(x.float(), q, splits,
                                          cols=2048) * scale[0]
                    fail_if(((order - ref).abs() > tol).any(),
                            f"int4_matmul {label}: the bound rejects the "
                            "tensor-core kernel's summation order")
                    del order
                    for fault in ("skip_first", "round_partials"):
                        bad = mma_order_sum(x.float(), q, splits,
                                            cols=2048, **{fault: True}) \
                            * scale[0]
                        outside = (bad - ref).abs() > tol
                        fail_if(not outside.any(), f"int4_matmul {label}: "
                                f"the bound admits the planted fault {fault}")
                        print(f"int4_matmul {label}: planted fault {fault} "
                              f"outside the bound at {int(outside.sum())} of "
                              f"{outside.numel()} outputs", flush=True)
                    del q
            (err, tol_at), (err_o, tol_o) = errs.values()
            if R == 16:       # row invariance, bitwise
                for r in (0, 7, 15):
                    alone = int4_matmul(x[r:r + 1].contiguous(), packed,
                                        scale, 0, out_dtype=out_dtype)
                    other = torch.randn((5, IN), generator=gen,
                                        device="cuda").to(torch.bfloat16)
                    other[3] = x[r]
                    placed = int4_matmul(other, packed, scale, 0,
                                         out_dtype=out_dtype)
                    fail_if(not (torch.equal(alone[0], got[r])
                                 and torch.equal(placed[3], got[r])),
                            f"int4_matmul {label}: row {r} changes with the "
                            "rows beside it")
            ms = cuda_ms(lambda i: int4_matmul(x, packed, scale, i % L,
                                               out_dtype=out_dtype))
            plain_ms = cuda_ms(lambda i: int4_matmul_ref(
                x, packed, scale, i % L, out_dtype=out_dtype), iters=10)
            library_ms = cuda_ms(lambda i: torch.matmul(x, w16[i % L]))
            osz = 4 if out_dtype == torch.float32 else 2
            bound_ms, bound_by = bound(
                layer_bytes + OUT * 4 + R * IN * 2 + R * OUT * osz,
                2 * R * IN * OUT, "bfloat16")
            print(f"kernel int4_matmul {label} ({IN}->{OUT}, "
                  f"{str(out_dtype).split('.')[1]} out): max_abs_err "
                  f"{err:.3e} (tol at that element {tol_at:.3e}; other "
                  f"output type {err_o:.3e}, tol {tol_o:.3e}) kernel_ms "
                  f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} (bf16 matmul, weight dequantized "
                  f"beforehand) bound_ms {bound_ms:.5f} ({bound_by}) "
                  f"[{card}]", flush=True)
            if out_dtype == torch.bfloat16:
                max_err = max(max_err, err)
            if label == main_label:
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
        check_int4_rows(name, packed, scale, out_dtype, xs[192], gen)
        del packed, scale, w16, xs
        torch.cuda.empty_cache()
    row["max_abs_err"] = max_err
    return row


def poison_pages(args, active, spare, page):
    """Copies of the pools with 1e30 (int8: 127 with scales of 1e30) past
    each active slot's kv_limit in its last page, in every page outside the
    tables and in the scratch page."""
    q, kp, vp, tables, win, lims, ks, vs = args
    kp, vp = kp.clone(), vp.clone()
    ks, vs = (None, None) if ks is None else (ks.clone(), vs.clone())
    big = 127 if kp.dtype == __import__("torch").int8 else 1e30
    spots = [(p, 0) for p in spare]
    for b in active:
        lim = int(lims[b])
        if lim % page:
            spots.append((int(tables[b, lim // page]), lim % page))
    for p, r0 in spots:
        kp[p, :, r0:] = big
        vp[p, :, r0:] = -big
        if ks is not None:
            ks[p, :, r0:] = 1e30
            vs[p, :, r0:] = 1e30
    return (q, kp, vp, tables, win, lims, ks, vs)


def check_paged(card: str) -> dict:
    """Phase 3d: the paged verify attention, K4."""
    import torch

    from samd_tpu_torch.ops.flash_attention import (flash_block_attention,
                                                    kernel_tolerance)
    from samd_tpu_torch.ops.paged_attention import (gather_pages,
                                                    paged_block_attention,
                                                    paged_block_attention_ref,
                                                    window_to_mask)
    from samd_tpu_torch.tools.time_kernels import library_paged, paged_case

    # (name, label, B, T, NH, KH, D, page, committed lengths, int8 pool)
    cases = [
        ("paged_block_attention_int8kv", "llama_7b B=12 T=16 int8 pages",
         12, 16, 32, 32, 128, 128,
         [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700, 1008], True),
        ("paged_block_attention", "llama_1b B=4 T=16 q-typed pages", 4, 16,
         32, 4, 64, 128, [300, None, 64, 1008], False),
    ]
    rows = {}
    for name, label, B, T, NH, KH, D, page, committed, int8 in cases:
        row, max_err = None, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            tag = f"{label} {dname}"
            args, active, spare = paged_case(B, T, NH, KH, D, page, committed,
                                             dtype, int8, seed=300 + B)
            got = paged_block_attention(*args)
            again = paged_block_attention(*args)
            poisoned = paged_block_attention(*poison_pages(args, active,
                                                           spare, page))
            ref = paged_block_attention_ref(*args)
            torch.cuda.synchronize()
            err, tol_at = check_close(f"paged_block_attention {tag}",
                                      got[active], ref[active],
                                      kernel_tolerance(ref[active]),
                                      again[active])
            fail_if(not torch.equal(got[active], poisoned[active]),
                    f"paged_block_attention {tag}: poison changed the result")
            q, kp, vp, tables, win, lims, ks, vs = args
            for b in active:
                tb = tables[b:b + 1]
                kd, vd = gather_pages(kp, tb), gather_pages(vp, tb)
                sc = () if ks is None else (gather_pages(ks, tb),
                                            gather_pages(vs, tb))
                mask = window_to_mask(win[b:b + 1], lims[b:b + 1], T, page,
                                      kd.shape[2])
                one = flash_block_attention(q[b:b + 1].contiguous(), kd, vd,
                                            mask, lims[b], *sc)
                fail_if(not torch.equal(got[b], one[0]),
                        f"paged_block_attention {tag}: slot {b} differs from "
                        "the verify kernel on its gathered KV")
            torch.cuda.synchronize()
            library = library_paged(args, active, page)
            ms = cuda_ms(lambda i: paged_block_attention(*args))
            plain_ms = cuda_ms(lambda i: paged_block_attention_ref(*args),
                               iters=10)
            library_ms = cuda_ms(library)
            isz = 2 if dtype == torch.bfloat16 else 4
            per_col = KH * (D + 4 if int8 else D * isz)   # K or V, per column
            live = sum(int(lims[b]) for b in active)
            nbytes = (2 * live * per_col + 2 * q.numel() * isz + win.numel()
                      + tables.numel() * 4 + B * 4)
            bound_ms, bound_by = bound(nbytes, 4 * NH * T * D * live, dname)
            print(f"kernel paged_block_attention {tag}: max_abs_err {err:.3e}"
                  f" (tol at that element {tol_at:.3e}) kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                  f"(SDPA per active slot on its gathered live KV, "
                  f"dequantized) bound_ms {bound_ms:.5f} ({bound_by}; "
                  f"{live} live columns) bitwise equal to the verify kernel "
                  f"on gathered KV in {len(active)} slots [{card}]",
                  flush=True)
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
        row["max_abs_err"] = max_err
        rows[name] = row
    return rows


def reset_counts() -> None:
    from samd_tpu_torch.ops.flash_attention import flash_block_attention
    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.paged_attention import paged_block_attention

    flash_block_attention.launches = 0
    flash_block_attention.launches_int8 = 0
    int4_matmul.launches = 0
    paged_block_attention.launches = 0
    paged_block_attention.launches_int8 = 0


def read_counts() -> dict:
    from samd_tpu_torch.ops.flash_attention import flash_block_attention
    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.paged_attention import paged_block_attention

    return {"flash_block_attention": flash_block_attention.launches,
            "flash_block_attention_int8kv":
                flash_block_attention.launches_int8,
            "int4_matmul": int4_matmul.launches,
            "paged_block_attention": paged_block_attention.launches,
            "paged_block_attention_int8kv":
                paged_block_attention.launches_int8}


def serve(card, name_cfg, engines, prompts, refs, gen, vocab) -> list:
    """Run each request on its engine and check it against the oracle's
    tokens; returns each request's (prompt length, decode steps)."""
    import torch

    done = []
    for name, p in prompts.items():
        t0 = time.perf_counter()
        out = engines[name].generate(p, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = refs[name]
        if out.output_ids != ref.output_ids:
            diff = next(i for i, (a, b) in enumerate(
                zip(out.output_ids, ref.output_ids)) if a != b)
            raise SystemExit(f"{name_cfg} request {name}: tokens differ from "
                             f"the oracle at {diff}")
        fail_if(len(out.output_ids) != len(p) + gen.max_new_tokens
                or not all(0 <= t < vocab for t in out.output_ids),
                f"{name_cfg} request {name}: malformed output")
        print(f"{name_cfg} request {name}: prompt {len(p)} new "
              f"{out.decode_tokens} decode_steps {out.decode_steps} "
              f"mean_accept {out.decode_tokens / out.decode_steps:.3f} "
              f"ms_per_step {dt / out.decode_steps * 1e3:.3f} tok_per_s "
              f"{out.decode_tokens / dt:.2f} (request wall {dt:.3f} s, "
              f"prefill included) equal_to_oracle True [{card}]", flush=True)
        done.append((len(p), out.decode_steps))
    return done


def main_path_1b(card: str) -> int:
    """Phase 4: llama_1b, bf16, verify kernel."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
    from samd_tpu_torch.models import init_params, llama_1b

    cfg = llama_1b()                 # attention_impl "flash" by default
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    fc = FusedSamConfig()
    M, S, new = fc.block, 2048, 128
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    rng = np.random.default_rng(0)
    prompts = {
        "a_random": rng.integers(3, cfg.vocab_size, size=64).tolist(),
        "b_own_corpus": rng.integers(3, cfg.vocab_size, size=100).tolist(),
        "c_repetitive": rng.integers(3, cfg.vocab_size, size=8).tolist() * 12,
    }
    oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=M)
    refs = {name: oracle.generate(p, gen) for name, p in prompts.items()}
    plain_engine = FusedSamEngine(cfg, params, fc, max_cache_len=S,
                                  eos_token_id=-1)
    corpus_engine = FusedSamEngine(
        cfg, params, fc, corpus=refs["b_own_corpus"].output_ids + [0],
        max_cache_len=S, eos_token_id=-1)
    engines = {"a_random": plain_engine, "b_own_corpus": corpus_engine,
               "c_repetitive": plain_engine}
    plain_engine.generate(prompts["a_random"][:16],
                          GenerationConfig(max_new_tokens=8))   # warm-up
    torch.cuda.synchronize()

    reset_counts()                              # the path starts here
    done = serve(card, "llama_1b", engines, prompts, refs, gen,
                 cfg.vocab_size)
    counts = read_counts()                      # the path ends here
    expected = sum(cfg.num_layers * (1 + steps) for _, steps in done)
    launches = counts["flash_block_attention"]
    fail_if(launches != expected or launches == 0,
            f"llama_1b: flash_block_attention launched {launches} times, "
            f"expected {expected} (22 layers x every forward)")
    fail_if(any(v for k, v in counts.items()
                if k != "flash_block_attention"),
            f"llama_1b: launches of kernels off its path: {counts}")
    print(f"llama_1b path: flash_block_attention launches {launches} = "
          f"{cfg.num_layers} layers x (3 prefills + decode steps)",
          flush=True)
    return launches


def bucket_prefill_check(card, cfg, params, prompt) -> None:
    """The plain attention at a cache bucket: the 200-token prompt's
    prefill (bucket P = 256 > 128 rows, so the plain attention) into a
    W = 384 cache and into the S = 1024 cache gives the same logits and
    int8 cache bytes.  While a prefill reads only its live P columns this
    holds by construction, and guards that slice; for the record, how often
    the plain attention over all W against all S columns (masked columns
    included, the form without the slice) differs in the last bit."""
    import torch

    from samd_tpu_torch.cache import dequantize_kv, init_kv_cache
    from samd_tpu_torch.models.llama import _attention, forward, prefill_mask

    P, W, S = 256, 384, 1024
    toks = torch.zeros((1, P), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    toks, pos = toks.cuda(), torch.arange(P, device="cuda")[None]
    outs = []
    for size in (W, S):
        kv = init_kv_cache(cfg, 1, size, "cuda")
        logits, _ = forward(params, cfg, toks, pos, *kv, 0,
                            prefill_mask(1, P, size, "cuda"))
        outs.append((logits, kv))
    (lw, (kw, vw)), (ls, (ks, vs)) = outs
    fail_if(not torch.equal(lw, ls), "bucketed prefill: logits at W = 384 "
            "and S = 1024 differ")
    for a, b in ((kw, ks), (vw, vs)):
        fail_if(not (torch.equal(a.q[..., :P, :], b.q[..., :P, :])
                     and torch.equal(a.scale[..., :P], b.scale[..., :P])),
                "bucketed prefill: int8 cache bytes at W and S differ")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    q = torch.randn((1, P, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(cfg.dtype)
    k = dequantize_kv(ks[0], cfg.dtype)
    v = dequantize_kv(vs[0], cfg.dtype)
    mask = prefill_mask(1, P, S, "cuda")
    full = _attention(q, k, v, mask, cfg)
    bucket = _attention(q, k[:, :, :W], v[:, :, :W], mask[..., :W], cfg)
    live = _attention(q, k[:, :, :P], v[:, :, :P], mask[..., :P], cfg)
    n_diff = int((full != bucket).sum())
    print(f"bucketed prefill (P {P}, W {W}, S {S}): logits and int8 cache "
          f"bytes equal at W and S; plain attention over all W vs all S "
          f"columns: {n_diff} of {full.numel()} outputs differ (max abs "
          f"{(full.float() - bucket.float()).abs().max().item():.3e}); over "
          f"the live {P} columns vs all S: "
          f"{int((live != full).sum())} differ [{card}]", flush=True)


def llama_7b_int4_params():
    """llama_7b at full width, packed-int4 weights requantized from an int8
    base drawn on the card from seed 0 (shared by phases 5 and 6)."""
    import torch

    from samd_tpu_torch.models import llama_7b
    from samd_tpu_torch.ops.quant import (init_quantized_llama_params,
                                          int4_from_int8_params,
                                          quantized_bytes)

    cfg = llama_7b()
    fail_if(cfg.int4_impl != "kernel" or cfg.attention_impl != "flash",
            "llama_7b: the kernels are not the default routes")
    t0 = time.perf_counter()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    base = init_quantized_llama_params(cfg, gen_w, scale=0.02,
                                       dtype=torch.int8, device="cuda")
    params = int4_from_int8_params(base)
    del base
    gc.collect()
    torch.cuda.synchronize()
    print(f"llama_7b weights: int8 base drawn on the card and requantized "
          f"to packed int4 in {time.perf_counter() - t0:.1f} s; "
          f"{quantized_bytes(params) / 1e9:.3f} GB", flush=True)
    return cfg, params


def main_path_7b(card: str, cfg, params) -> tuple:
    """Phase 5: llama_7b, int4 weights, int8 KV."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine

    cfg = dataclasses.replace(cfg, kv_quant=True)
    fc = FusedSamConfig(n_predicts=15, corpus_capacity=4096,
                        cache_buckets=(256, 384, 512, 768))
    M, S, new = fc.block, 1024, 128
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    rng = np.random.default_rng(7)
    prompts = {
        "a_random_200": rng.integers(3, cfg.vocab_size, size=200).tolist(),
        "b_own_corpus": rng.integers(3, cfg.vocab_size, size=96).tolist(),
        "c_repetitive": rng.integers(3, cfg.vocab_size, size=8).tolist() * 12,
    }
    bucket_prefill_check(card, cfg, params, prompts["a_random_200"])
    oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=M)
    oracle.generate(prompts["c_repetitive"][:16],
                    GenerationConfig(max_new_tokens=4))        # warm-up
    refs = {name: oracle.generate(p, gen) for name, p in prompts.items()}
    plain_engine = FusedSamEngine(cfg, params, fc, max_cache_len=S,
                                  eos_token_id=-1)
    corpus_engine = FusedSamEngine(
        cfg, params, fc, corpus=refs["b_own_corpus"].output_ids + [0],
        max_cache_len=S, eos_token_id=-1)
    engines = {"a_random_200": plain_engine, "b_own_corpus": corpus_engine,
               "c_repetitive": plain_engine}
    plain_engine.generate(prompts["c_repetitive"][:16],
                          GenerationConfig(max_new_tokens=8))   # warm-up
    torch.cuda.synchronize()

    reset_counts()                              # the path starts here
    done = serve(card, "llama_7b int4 int8-KV", engines, prompts, refs, gen,
                 cfg.vocab_size)
    counts = read_counts()                      # the path ends here
    forwards = sum(1 + steps for _, steps in done)
    short = sum(steps + (n <= 128) for n, steps in done)  # T <= 128 forwards
    want = {"flash_block_attention": 0,
            "flash_block_attention_int8kv": cfg.num_layers * short,
            "int4_matmul": (7 * cfg.num_layers + 1) * forwards,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want or not counts["int4_matmul"]
            or not counts["flash_block_attention_int8kv"],
            f"llama_7b: launch counts {counts}, expected {want} (225 int4 "
            "launches per forward, 32 int8-KV verify launches per forward "
            "of T <= 128)")
    print(f"llama_7b path: int4_matmul launches {counts['int4_matmul']} = "
          f"225 x {forwards} forwards; int8-KV verify launches "
          f"{counts['flash_block_attention_int8kv']} = 32 x {short} forwards "
          f"of T <= 128", flush=True)
    return counts["int4_matmul"], counts["flash_block_attention_int8kv"]


def serve_batched(engine, requests, vocab):
    """Queue every (prompt, budget) request, run the engine to the end and
    check each output's form; returns (outputs in order, wall seconds,
    [B, M] forwards run)."""
    import torch

    from samd_tpu_torch.config import GenerationConfig

    steps0 = engine.steps_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [engine.add_request(p, GenerationConfig(max_new_tokens=n,
                                                  max_cache_len=engine.S))
           for p, n in requests]
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [out[i] for i in ids]
    for (p, n), o in zip(requests, outs):
        fail_if(len(o.output_ids) != len(p) + n or o.output_ids[:len(p)] != p
                or not all(0 <= t < vocab for t in o.output_ids),
                "batched serving: malformed output")
    return outs, wall, engine.steps_run - steps0


def report_batched(card, label, requests, outs, wall, steps, oracle):
    """Check every request against the oracle's tokens; print the run's
    numbers."""
    for i, (o, r) in enumerate(zip(outs, oracle)):
        if o.output_ids != r.output_ids:
            diff = next(j for j, (a, b) in enumerate(
                zip(o.output_ids, r.output_ids)) if a != b)
            raise SystemExit(f"{label} request {i}: tokens differ from the "
                             f"alpha = 0 oracle at {diff}")
    new = sum(o.decode_tokens for o in outs)
    slot_steps = sum(o.decode_steps for o in outs)
    print(f"{label}: {len(outs)} requests, {new} new tokens, {steps} steps "
          f"of [B, M], wall {wall:.3f} s (prefills included): "
          f"{new / wall:.2f} tok/s, {wall / steps * 1e3:.3f} ms/step, mean "
          f"accept {new / slot_steps:.3f} per live slot-step; every request "
          f"equal to the alpha = 0 oracle [{card}]", flush=True)


def main_path_7b_paged(card: str, cfg, params) -> int:
    """Phase 6: llama_7b int4 weights over int8 pages, B = 12."""
    import torch

    from samd_tpu_torch.fused_sam import (FusedSamConfig, FusedSamEngine,
                                          PagedBatchedFusedSamEngine)

    S, B, page, n_pages = 1024, 12, 128, 52
    kw = dict(batch_size=B, max_cache_len=S, eos_token_id=-1,
              prefill_buckets=(128, 256), n_pages=n_pages, page_size=page,
              quantized_kv=True)
    rng = np.random.default_rng(11)
    fresh = [(rng.integers(3, cfg.vocab_size, size=int(n)).tolist(),
              int(rng.integers(32, 129)))
             for n in rng.integers(40, 129, size=11)]
    fresh.append((rng.integers(3, cfg.vocab_size, size=200).tolist(),
                  int(rng.integers(32, 129))))
    requests = fresh + fresh[:4]          # four repeats of earlier prompts

    def engine(fc, corpus=None):
        return PagedBatchedFusedSamEngine(cfg, params, fc, corpus=corpus,
                                          **kw)

    oracle_eng = engine(FusedSamConfig(n_predicts=15, steps_per_call=16,
                                       corpus_capacity=4096, alpha=0.0))
    oracle, o_wall, o_steps = serve_batched(oracle_eng, requests,
                                            cfg.vocab_size)
    o_new = sum(o.decode_tokens for o in oracle)
    print(f"llama_7b paged oracle (alpha = 0): {o_new} new tokens, "
          f"{o_steps} steps, wall {o_wall:.3f} s: {o_new / o_wall:.2f} tok/s, "
          f"{o_wall / o_steps * 1e3:.3f} ms/step [{card}]", flush=True)
    del oracle_eng
    corpus = sum((o.output_ids + [0] for o in oracle[:4]), [])
    fc = FusedSamConfig(n_predicts=15, steps_per_call=16,
                        corpus_capacity=4096)
    eng = engine(fc, corpus)
    gc.collect()
    torch.cuda.synchronize()

    reset_counts()                              # the path starts here
    outs, wall, steps = serve_batched(eng, requests, cfg.vocab_size)
    counts = read_counts()                      # the path ends here
    report_batched(card, "llama_7b int4 paged int8 pages B=12", requests,
                   outs, wall, steps, oracle)
    fail_if(len(eng.pool._free) != n_pages or eng.live_kv_tokens() != 0,
            f"llama_7b paged: {n_pages - len(eng.pool._free)} pages not "
            "returned")
    p128 = sum(len(p) <= 128 for p, _ in requests)
    want = {"flash_block_attention": cfg.num_layers * p128,
            "flash_block_attention_int8kv": 0,
            "int4_matmul": (7 * cfg.num_layers + 1) * (steps + len(requests)),
            "paged_block_attention": 0,
            "paged_block_attention_int8kv": cfg.num_layers * steps}
    fail_if(counts != want or not steps,
            f"llama_7b paged: launch counts {counts}, expected {want} (K4 "
            "int8 32 per step, the bf16 verify 32 per P = 128 prefill, K3 225 "
            "per forward)")
    print(f"llama_7b paged path: K4 int8 launches "
          f"{counts['paged_block_attention_int8kv']} = 32 x {steps} steps; "
          f"bf16 verify {counts['flash_block_attention']} = 32 x {p128} "
          f"P = 128 prefills; int4_matmul {counts['int4_matmul']} = 225 x "
          f"{steps + len(requests)} forwards; peak_pages {eng.peak_pages} of "
          f"{n_pages}; all pages returned [{card}]", flush=True)
    del eng
    gc.collect()

    # for the record: the single-stream engine over a dense int8 cache (its
    # prefill attends int8 KV, the paged prefill bf16: another trajectory)
    single = FusedSamEngine(dataclasses.replace(cfg, kv_quant=True), params,
                            FusedSamConfig(n_predicts=15,
                                           corpus_capacity=4096),
                            corpus=corpus, max_cache_len=S, eos_token_id=-1,
                            prefill_buckets=(128, 256))
    from samd_tpu_torch.config import GenerationConfig
    same = sum(single.generate(p, GenerationConfig(
        max_new_tokens=n, max_cache_len=S)).output_ids == o.output_ids
        for (p, n), o in zip(requests, outs))
    print(f"llama_7b paged vs single-stream FusedSamEngine (dense int8 KV): "
          f"{same} of {len(requests)} requests equal (not required)",
          flush=True)
    return counts["paged_block_attention_int8kv"]


def main_path_1b_batched(card: str) -> int:
    """Phase 7: llama_1b bf16, B = 4, dense and paged batched engines."""
    import torch

    from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine,
                                          FusedSamConfig,
                                          PagedBatchedFusedSamEngine)
    from samd_tpu_torch.models import init_params, llama_1b

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    S = 1024
    kw = dict(batch_size=4, max_cache_len=S, eos_token_id=-1,
              prefill_buckets=(128, 256))
    rng = np.random.default_rng(13)
    fresh = [(rng.integers(3, cfg.vocab_size, size=int(n)).tolist(), 64)
             for n in rng.integers(40, 101, size=4)]
    requests = fresh + fresh[:2]

    def fcfg(alpha=4.0):
        return FusedSamConfig(n_predicts=15, steps_per_call=16,
                              corpus_capacity=4096, alpha=alpha)

    runs = {}
    for name, make in (
            ("dense", lambda fc, corpus=None: BatchedFusedSamEngine(
                cfg, params, fc, corpus=corpus, **kw)),
            ("paged", lambda fc, corpus=None: PagedBatchedFusedSamEngine(
                cfg, params, fc, corpus=corpus, n_pages=32, page_size=128,
                **kw))):
        oracle, _, _ = serve_batched(make(fcfg(0.0)), requests,
                                     cfg.vocab_size)
        corpus = sum((o.output_ids + [0] for o in oracle[:2]), [])
        eng = make(fcfg(), corpus)
        torch.cuda.synchronize()
        reset_counts()                          # the path starts here
        outs, wall, steps = serve_batched(eng, requests, cfg.vocab_size)
        counts = read_counts()                  # the path ends here
        report_batched(card, f"llama_1b bf16 {name} B=4", requests, outs,
                       wall, steps, oracle)
        want = {"flash_block_attention": cfg.num_layers * len(requests),
                "flash_block_attention_int8kv": 0, "int4_matmul": 0,
                "paged_block_attention":
                    cfg.num_layers * steps if name == "paged" else 0,
                "paged_block_attention_int8kv": 0}
        fail_if(counts != want or not steps,
                f"llama_1b {name}: launch counts {counts}, expected {want}")
        if name == "paged":
            fail_if(len(eng.pool._free) != 32,
                    "llama_1b paged: pages not returned")
        runs[name] = (outs, counts)
        del eng
        gc.collect()
    agree = sum(a.output_ids == b.output_ids
                for a, b in zip(runs["dense"][0], runs["paged"][0]))
    print(f"llama_1b batched: dense and paged engines agree on {agree} of "
          f"{len(requests)} requests (not required: the dense engine attends "
          f"plainly over all S columns, the paged one through K4); K4 bf16 "
          f"launches {runs['paged'][1]['paged_block_attention']} [{card}]",
          flush=True)
    return runs["paged"][1]["paged_block_attention"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from samd_tpu_torch.ops import _build

    # phase 1: card.  The port's f32 products (logits, the plain attention,
    # the plain versions) must run in full f32: forward raises on CUDA while
    # TF32 matmuls are on.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fail_if(torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32,
            "TF32 is on; the port's f32 products need it off")
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}"
          f"; allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {len(secs)} sources in parallel, "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    for name, s in secs.items():
        print(f"build: {name} nvcc {s:.2f} s", flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # the tensor-core bodies: HMMA in every bf16-q instantiation of the
    # verify source's two entry points (32), FFMA counted beside it
    sass = _build.sass_counts("flash_block_attention", ("HMMA", "FFMA"))
    bf16 = {f: c for f, c in sass.items()
            if "attention_kernelI13__nv_bfloat16" in f}
    fail_if(len(bf16) != 32 or min(c["HMMA"] for c in bf16.values()) == 0,
            f"sass: {len(bf16)} bf16-q attention kernels, HMMA counts "
            f"{sorted(c['HMMA'] for c in bf16.values())}")
    for f, c in sorted(sass.items()):
        print(f"sass: {f} HMMA {c['HMMA']} FFMA {c['FFMA']}")

    # phase 3: kernels against their plain versions
    rows = {"flash_block_attention": check_kernels(card),
            "flash_block_attention_int8kv": check_int8_attention(card),
            "int4_matmul": check_int4(card), **check_paged(card)}

    # phases 4 to 7: the paths, each with its counts read on its own
    launches = {"flash_block_attention": main_path_1b(card)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg7, params7 = llama_7b_int4_params()
    (launches["int4_matmul"],
     launches["flash_block_attention_int8kv"]) = main_path_7b(card, cfg7,
                                                             params7)
    gc.collect()
    torch.cuda.empty_cache()
    launches["paged_block_attention_int8kv"] = main_path_7b_paged(
        card, cfg7, params7)
    del params7
    gc.collect()
    torch.cuda.empty_cache()
    launches["paged_block_attention"] = main_path_1b_batched(card)

    meta = {
        "flash_block_attention": (
            "samd_tpu_torch/csrc/flash_block_attention.cu",
            "samd_tpu/ops/pallas_attention.py:49"),
        "flash_block_attention_int8kv": (
            "samd_tpu_torch/csrc/flash_block_attention.cu",
            "samd_tpu/ops/pallas_attention.py:171"),
        "int4_matmul": ("samd_tpu_torch/csrc/int4_matmul.cu",
                        "samd_tpu/ops/int4_matmul.py:168"),
        "paged_block_attention": (
            "samd_tpu_torch/csrc/flash_block_attention.cu",
            "samd_tpu/ops/paged_attention.py:40"),
        "paged_block_attention_int8kv": (
            "samd_tpu_torch/csrc/flash_block_attention.cu",
            "samd_tpu/ops/paged_attention.py:40"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name], **rows[name]}
        for name in meta]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
