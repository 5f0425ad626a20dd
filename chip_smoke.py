#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (samd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --isolate-11b   (phases 1-2, then ``isolate_11b``)
    python3 chip_smoke.py --mesh-rank RANK PORT DIR   (one of phase 19's
        two ranks, started by the script itself)

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
        cache, and phase 19's shapes over 1024-slot caches: llama_1b at
        T = 16 (KH 4 under NH 32), a tp-2 rank's heads of llama_1b (KH 2
        under NH 16) and of llama_7b (KH 16 under NH 16) at T = 16 and in
        the T = 128 prefill bucket; poison past kv_limit must change nothing, and
        the same live prefix in a cache cut to max(256, kv_limit rounded
        up to 64) columns must give the same bits;
     b. its int8-KV mode at llama_7b decode shapes, the T = 128 prefill
        shape, one llama_1b shape, and mixtral_8x7b's (KH 8 under NH 32, G
        4, D 128: T = 16 at cache_len 0, 200 and 700, and the T = 128
        prefill); int8 bytes of 127 and scales of 1e30 past kv_limit change
        nothing; the same cut-cache check;
     c. the int4 matmul at every llama_7b projection and head shape, at
        16, 60, 64, 128, 192, 256 and 288 rows (decode, the host engines'
        and the hybrid's blocks, the prefill buckets 128 and 256, and B * M
        = 12 * 16 and 12 * 24 rows of batched serving), in bf16 and f32
        output; row invariance: a row alone, or placed at another row of
        another block, gives the same bits, and every 16-row block of an R
        = 192 call equals the same rows run at R = 16; ragged R = 1, 13
        and 200 (w_gate, head) and an f32 x (the CUDA-core body) within
        the bound; a model of the tensor-core kernel's order and rounding
        falls inside the bound, and two planted faults in it outside;
        and mixtral_8x7b's wk/wv (4096 -> 1024) at R = 16, 128 and 192
        with the same checks (its wq/wo and head are llama_7b's shapes),
        and a tp-2 rank's slab of w_gate under int4_matmul_tp (4096 ->
        5504, out/2 2752) at R = 16 and 192;
     d. the paged verify attention (K4) over a page pool with shuffled
        tables and inactive slots: llama_7b B = 12 over int8 pages and
        llama_1b B = 4 over pages of q's type, bf16 and f32 q; each active
        slot bitwise equal to the verify kernel on its gathered dense KV;
        poison past kv_limit, in pages outside the tables and in the
        scratch page changes nothing;
     e. the host engines' tree masks at M = 60, the Token-Recycle topology
        (rank_probability_tree(61)'s first 60 nodes) and a native corpus
        SAM's frequency tree (at least 4 deep): the verify kernel at
        llama_1b T = 60 (bf16 and f32 q), its int8 mode at llama_7b KH 32,
        D 128, T = 60, and K4 over bf16 pages at llama_1b B = 4 with tree
        windows: within the tolerance, two runs bitwise equal, poison past
        kv_limit changing nothing, each K4 slot bitwise equal to the verify
        kernel on its gathered KV; each timed beside its plain version,
        SDPA with the boolean mask and the bound.  Phase 3c also holds the
        int4 matmul at R = 60, 64 and 288 (the host engines' block, the
        hybrid's, and B = 12 x 24 with a ragged fifth 64-row tile) at every
        llama_7b shape, each 16-row block bitwise equal to the same rows
        at R = 16;
     f. the fused drafters' shapes, with the same checks and timings: the
        int8 mode at llama_7b KH 32, D 128, T = 64 on the hybrid's
        relabelled 61-node tree and its self-parented padding; K4 over int8
        pages at llama_7b B = 12, T = 24 on the server block's 23-node tree
        in every window; the verify kernel at llama_1b T = 11 (PLD's
        chain) and T = 61 (the fused Token-Recycle tree);
     g. the EAGLE paths' shapes on trees from real EAGLE-2 expansions
        (``eagle_tree``), with the same checks and timings: the int8 mode
        at llama_7b KH 32, D 128, T = 64 (depth 5, top-8, 64 nodes), the
        verify kernel at llama_1b T = 64 on that tree, K4 over int8 pages
        at llama_7b B = 12, T = 24 (depth 4, top-4, 24 nodes) in every
        window; phase 3c also holds K3 on the head at the draft head's R
        = 8, 12 and 48;
  4. llama_1b path: greedy FusedSamEngine at full width (bf16, random
     weights from torch.Generator seed 0) answers three requests of 128 new
     tokens, each equal to ArBaseline(block_size=60)'s bit for bit; every
     forward went through the verify kernel.  Then one sampled request per
     accept mode (rejection at temperature 0.8 with top_k 50, typical,
     nucleus with top_p 0.9), each run twice with its seed, must give the
     same tokens both times, every forward through the verify kernel;
     point-mass sampled requests (top_k 1, or top_p 1e-6, at temperature
     1e-5: every draw forced) through the rejection and nucleus rules must
     equal the ArBaseline oracle token for token; and
     chain_sampling_accept over 4000 trials at V = 8 with the card's
     generator must stay within total variation 0.05 of the target, for a
     likely and an unlikely proposal;
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
  8. the server: samd_tpu_torch.server over HTTP (127.0.0.1, a free port)
     in front of phase 6's engine and weights with a 2^20-token corpus
     (random tokens, phase 6's four repeated requests' outputs in its last
     quarter) behind its n-gram index; the index probe must equal the scan
     on 64 queries.  Four client threads send phase 6's 16 greedy requests
     (each equal to phase 6's alpha = 0 oracle), 8 sampled ones (four
     prompts, each twice with one seed: equal in pairs), a batch mixing
     greedy (equal to the oracle) and sampled requests (another seed
     differs), a batch mixing greedy requests and point-mass sampled ones
     (top_k 1 at temperature 1e-5, each its own prompt and seed: all equal
     to the oracle), one SSE request on a prompt that commits over several
     segments (at least two chunks, equal to its blocking reply) and, while
     a sampled request is in flight, one of another signature (400), and
     bodies the engine cannot serve (400, the server serving on);
     /health answers ok; every page comes back; launches as in phase 6;
  7. llama_1b batched paths: BatchedFusedSamEngine (dense) and
     PagedBatchedFusedSamEngine (bf16 pages of 128) at B = 4 answer six
     requests of 64 new tokens, each equal to its own alpha = 0 oracle; at
     each request where the two engines differ, the logits of a plain
     prefill over the shared prefix, with bf16 and with f32 probabilities,
     give the top-2 gap by the near-tie rule; and the dense engine run again
     with f32 probabilities (a scratch copy of the plain attention) is
     compared with the paged engine.
  9. llama_7b host path (after 8): phase 5's weights and int8 KV through
     the host-automaton SamdEngine at max_predicts 60 over 1024 slots:
     (a) sam_hybrid with the Token-Recycle tree drafter, its cache warm
     (every token holds a harvest, so every draft is a 60-node tree; request
     a's oracle path harvested), three requests of 64 new tokens; (b)
     sam_only with a static corpus SAM built by the native engine over
     random tokens and request a's oracle output, saved and loaded back
     (every array equal); each request against ArBaseline(block_size=60) by
     the near-tie judge (``judge``): the engine's own logits for every token
     it emits are bitwise equal to the oracle's after chain drafts only and,
     once a tree draft was verified, drift from them (range over the
     oracle's top 16 tokens) no more than a plain prefill does at 64
     positions of the oracle's path; where the tokens first differ, a tree
     draft came first and the two tokens are within 0.08 in the oracle's
     own logits, a gap that neither the plain prefill nor the engine moves
     beyond that bound; anything else fails; node counts per step printed;
     int4 launches 225 per forward, int8-KV verify launches 32 per forward
     of T <= 128; three planted tree faults (rows that attend every earlier
     column, that skip their parent, or that take their column as
     position) must each be rejected; (c) one sampled request per tree
     accept mode (rejection at temperature 0.8 with top_k 50, typical,
     nucleus with top_p 0.9), each twice with its seed, equal; point-mass
     requests (top_k 1, temperature 1e-5) through both drafters equal to
     the same engine's greedy run, which the judge holds to the oracle;
 10. llama_1b host batching (after 7): BatchedSamdEngine (dense) and
     PagedBatchedSamdEngine (bf16 pages of 128) at B = 4, M = 60, sam_only
     and sam_hybrid over a static corpus of two requests' outputs, six
     requests of 64 new tokens (the Token-Recycle cache warm as in phase 9),
     each against the same engine driven by the single-token drafter by the
     judge of phase 9 (its bound measured on that oracle); every page back; K4
     launches 22 per step; InterleavedSamdEngine with 3 lanes bitwise equal
     to 3 sequential SamdEngine runs; the server with --engine batched and
     --sam FILE over 127.0.0.1 serving four greedy requests, each equal to
     the same engine called directly.
 11. llama_7b fused hybrid (after 9), phase 5's weights: (a)
     FusedHybridEngine over int8 KV with the default config (M 64, a
     61-node tree, chains of 40) and phase 5's cache buckets, its harvest
     warm (a random top-8 for every token, the oracle's own along request
     a's path), three requests of 128 new tokens, each against
     ArBaseline(block_size=64) by phase 9's judge; (c) on that engine, from
     one saved harvest, one sampled request per accept mode run twice with
     its seed (equal), and point-mass rejection and nucleus requests equal
     to the greedy run; (b) PagedBatchedFusedHybridEngine at B = 12 with
     the server's block (M 24, a 23-node tree, 16 steps per segment) over
     64 int8 pages of 128, buckets 128 and 256, warm, phase 6's 16 requests
     (the four repeats' oracle outputs in the corpus), each judged against
     the chain-only PagedBatchedFusedSamEngine at alpha = 0 with the same
     M = 24, every slot's harvest warm along every request's oracle path
     (it fails unless some tree slot-step accepts a path of depth >= 2);
     every page back; K3 225 launches per forward, K4 32 per step.  Over
     int8 KV (phases 9, 11, 13) the judge's near-tie bound tau is the
     larger of 0.08 and the largest change a plain prefill makes to the
     oracle's top-2 gap at the bound's positions (``near_tie_rule``),
     printed beside every verdict;
 12. llama_1b fused drafters (after 10): PldEngine, two requests of 128
     new tokens bitwise equal to ArBaseline(block_size=11);
     FusedTokenRecycleEngine (61 nodes, warm) judged against
     ArBaseline(block_size=61); the dense and paged BatchedFusedHybridEngine
     at B = 4, M = 24 (bf16 pages of 128), six requests of 64, each judged
     against its chain-only engine at alpha = 0; both --engine
     fused_hybrid_batched and paged_fused_hybrid over 127.0.0.1, four
     greedy replies each equal to the same engine called directly from the
     same empty harvest.
 13. llama_7b SAM[EAGLE-2] (after 11), phase 5's weights and a random
     int8 draft net (seed 7, ``quantize_eagle_params``): (a)
     FusedHybridEagleEngine over int8 KV (M 64, depth 5, top-8, 63 nodes,
     chains of 40) on phase 11a's three requests, judged against its
     ArBaseline(block_size=64) rows; (c) sampled pairs per tree accept
     mode, equal, and point-mass runs equal to greedy; (b)
     PagedBatchedFusedHybridEagleEngine at B = 12 with the server's block
     (M 24, depth 4, top-4, 23 nodes) over 64 int8 pages on phase 6's 16
     requests, judged against 11b's chain oracle; every page back; K3 225
     per forward plus the draft head's launches (one per tree level a
     step), K4 32 per step; the tree steps' committed lengths printed;
 14. llama_1b EAGLE (after 12), a random bf16 draft net:
     FusedEagle2Engine (depth 5, top-8, 63 nodes) and SamdEngine at M =
     64 with the EAGLE-2 and EAGLE-1 drafters against
     ArBaseline(block_size=64); the dense BatchedFusedHybridEagleEngine at
     B = 4 with the server's block against its chain engine at alpha = 0;
     --engine eagle2_hybrid_batched over 127.0.0.1, four greedy replies
     equal to the same engine called directly; all judged.
 15. llama_1b from disk (after 14): an HF directory at TinyLlama's widths
     (bf16 weights from torch.Generator seed 0, two safetensors shards
     written by ``write_safetensors`` with HF's index) loaded by
     ``models.loader.load_llama``, every leaf bitwise equal to what was
     written; ``models.checkpoint`` round trips of those weights, plain
     and int4, bitwise; ``python3 -m samd_tpu_torch.cli --model DIR``
     with stdin piped for --engine fused_sam, fused_sam --quantize int4
     --kv-quant and samd: two token-id turns, ``!!regen`` (the same
     reply), ``!!save``/``!!reset``/``!!load`` and a third turn over the
     restored history, each reply equal to the same engine's generate in
     this process (``cli.build_engine``) and to ArBaseline(block_size=60)
     bit for bit; ``python3 -m samd_tpu_torch.server --model DIR --engine
     paged_fused_sam`` over 127.0.0.1, four greedy replies equal to the
     engine called directly; the three CLI sessions and the server start
     together;
 16. training and evaluation (after 15): ``evaluation.accept_demo.run``
     at the reference bench's sizes (400 steps, vocabulary 64, 48 new
     tokens): the LM loss falls below half its first value and the
     trained EAGLE-2 net accepts more than a random one, each drafter's
     mean accept printed beside the reference's published lengths;
     ``evaluation.specbench_demo.run`` (300 steps, 2 questions per task,
     64 new tokens): every engine equal to its block oracle, no errors;
     ``training.train_eagle`` against phase 15's llama_1b for 30 steps of
     batch 8 by 64 tokens over a Markov corpus of its 32000 tokens at lr
     5e-4 (the tiny models' 3e-3 diverges at this width): the last loss
     below the first, every net parameter a finite gradient.
 17. mixtral_8x7b at full width (after 16, the earlier weights freed):
     each layer's bf16 leaves drawn on the card from torch.Generator seed
     0 with init_params's distribution, quantized to packed int4 by
     quantize_weight4 and freed before the next (about 23.6 GB; the embed
     bf16, the router bf16); FusedSamEngine at M 16 over int8 KV, cache
     buckets 256-768 over 1024 slots, with the oracle's own outputs as
     its corpus, serves phase 5's three prompts with 64 new tokens each,
     every request equal to ArBaseline(block_size=16) bit for bit; K3 129
     launches per forward (wq/wk/wv/wo and the head: the expert products
     stay plain matmuls over dequantized stacks, as in JAX), the int8 mode
     32 per forward of T <= 128, the path's verify outputs held against
     the plain version (``PathProbe``); prints ms/step, tok/s, mean
     accept, the peak allocated memory, how often each expert is selected
     and, at cache_len 200 and 700, one T = 16 forward's device time split
     by CUDA events between the expert side (dequantization, products)
     and the rest (K3, the int8 mode and its share), beside the bytes
     bound from the weights' measured bytes;
 18. item 15's corpus tooling on phase 15's directory (after 17):
     ``tools.gen_corpus --model-dir`` over 4 token-row instructions, 32 new
     tokens at batch 4 (each row its prompt and 32 tokens);
     ``tools.build_sam`` of its output; ``python3 -m samd_tpu_torch.cli
     --engine samd --sam`` with one reply equal to
     ArBaseline(block_size=60); ``evaluation.parity`` over a 2^20-token
     corpus on the card, windowed (match and end agreement 1.0) and
     indexed (never a longer match), its agreement rates printed;
     ``python3 -m samd_tpu_torch.evaluation.launch --num-workers 2`` on
     the card, the merged answers sorted and each equal to the engine
     called in this process;
 19. the mesh (after 18, the earlier weights freed): (1) a world of one
     over NCCL in this process, ``make_mesh(1)``: llama_7b int4 over bf16
     KV in ``SamdEngine(mesh=)`` with the SAM drafter (sam_only, the
     static corpus SAM of the oracle's outputs cut to one branch: chains,
     M 16) on phase 5's three prompts with 64 new tokens, each equal bit
     for bit to the unsharded engine and to ArBaseline(block_size=16)
     unsharded and on the mesh; tok/s, and the median, least and greatest
     tok/s ratio to the unsharded engine over seven rounds of the two in
     turn; then two ranks sharing the card over
     gloo, two processes of this script (``--mesh-rank``, the kernels
     built before): (a) llama_7b int4 at tp 2 (int4 whole on each rank,
     as in the reference), each request equal bit for bit to the
     unsharded engine, and the collectives' share of one T 16 forward
     (CUDA events around it, each collective synchronized and timed); (d)
     ``int4_matmul_tp`` on each rank's w_gate slab at R 16 and 192, the
     gathered columns within K3's bound of K3 on the whole weight and of
     the plain version; (b) llama_1b bf16 at tp 2 (32 new tokens a
     request), each request equal to
     ArBaseline(block_size=16) on the mesh bit for bit and to the
     unsharded engine up to a near-tie (``near_tie_rule`` on the gaps in
     the unsharded oracle's logits, a plain prefill's and the mesh's own);
     (c) ``make_sp_forward`` on llama_1b, S 512 over the two ranks, a
     300-token prompt (the prefill straddles the shards) and 16 greedy
     steps against the unsharded forward, by the same rule.  The ranks'
     path launches (K3, the verify kernel) join the kernels line.
``--isolate-11b`` reports phase 11b (every path warm) without failing on
the judge and, at the first rejected request, the diverging token (i)
over bf16 pages, (ii) through the dense int8 BatchedFusedHybridEngine,
(iii) re-verified as a chain over the engine's own cache at that step and
(iv) over the chain oracle's cache at that length, and how the two
caches' int8 values differ.
After each path phase (4-19) the phases' end-to-end numbers so far
(ms/step, tok/s, mean accept, requests equal to their oracle, peak pages,
each phase's wall seconds) go to ``chiprun_out/chip_smoke_detail.json``
through the port's ``evaluation.bench_emit.BenchEmitter``, which also
prints a compact JSON line; a run cut at phase N keeps phases 1 to N - 1.
Then a JSON line of kernels (launches summed over every path), the
nvidia-smi line, and last the device line.
Without a CUDA device it exits 1 before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

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
    # phase 19: the unsharded llama_1b engines at M 16; a rank's heads at
    # tp 2 (llama_1b KH 2 under NH 16, llama_7b KH 16 under NH 16) at M 16
    # and the 128-row prefill bucket, over its caches of 1024 slots
    for cl in (96, 700):
        cases.append((f"llama_1b T=16 S=1024 cache_len={cl}", 16, 32, 4,
                      64, 1024, cl, False))
    for cl in (96, 700):
        cases.append((f"llama_1b tp 2 T=16 cache_len={cl} (KH 2)", 16, 16,
                      2, 64, 1024, cl, False))
    cases.append(("llama_1b tp 2 T=128 prefill S=1024 (KH 2)", 128, 16, 2,
                  64, 1024, 0, True))
    cases.append(("llama_7b tp 2 T=16 cache_len=200 (KH 16)", 16, 16, 16,
                  128, 1024, 200, False))
    cases.append(("llama_7b tp 2 T=128 prefill S=1024 (KH 16)", 128, 16,
                  16, 128, 1024, 0, True))
    # f32 only: the trained tiny models of phase 16 (NH 4, KH 2, D 16):
    # the host block 40, the fused block 60, the prefill buckets 32 and
    # 64 and the block-1 baseline, over the demos' caches of 256 and 512
    tiny = [(f"tiny T={T} S={S} cache_len={cl}", T, 4, 2, 16, S, cl, pre)
            for T, S, cls, pre in ((40, 512, (0, 100, 472), False),
                                   (60, 512, (0, 250, 452), False),
                                   (60, 256, (37, 196), False),
                                   (1, 512, (300,), False),
                                   (32, 256, (0,), True),
                                   (64, 512, (0,), True))
            for cl in cls]
    main_label = "llama_1b T=60 cache_len=160"
    row = None
    max_err_main = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for i, (label, T, NH, KH, D, S, cl, pre) in enumerate(
                cases + (tiny if dtype == torch.float32 else [])):
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
            if label.startswith("tiny") or (
                    dname == "bfloat16" and (label.startswith("llama_1b")
                                             or "S=128" in label
                                             or "KH 16" in label)):
                max_err_main = max(max_err_main, err)   # on paths
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
    # mixtral_8x7b (phase 17): 8 KV heads of 128 under 32 query heads (G 4)
    cases += [(f"mixtral_8x7b T=16 cache_len={cl}", 16, 32, 8, 128, 1024,
               cl, False) for cl in (0, 200, 700)]
    cases.append(("mixtral_8x7b T=128 prefill", 128, 32, 8, 128, 1024, 0,
                  True))
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
            if dname == "bfloat16" and label.startswith(("llama_7b",
                                                         "mixtral")):
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

    every_r = (16, 60, 64, 128, 192, 256, 288)
    # the llama_7b shapes (mixtral_8x7b's wq/wo and head are the same), and
    # mixtral_8x7b's wk/wv at its block and prefill rows (and R 192 for the
    # row checks)
    shapes = [("wq/wk/wv/wo", 4096, 4096, torch.bfloat16, every_r),
              ("w_gate/w_up", 4096, 11008, torch.bfloat16, every_r),
              ("w_down", 11008, 4096, torch.bfloat16, every_r),
              ("lm_head", 4096, 32000, torch.float32, every_r),
              ("mixtral wk/wv", 4096, 1024, torch.bfloat16, (16, 128, 192)),
              # a rank's slab of w_gate under int4_matmul_tp at tp 2
              ("w_gate slab tp 2", 4096, 5504, torch.bfloat16, (16, 192))]
    main_label = "w_gate/w_up R=16"
    row, max_err = None, 0.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name, IN, OUT, out_dtype, rows in shapes:
        layer_bytes = IN * OUT // 2
        L = max(2, math.ceil(2 * L2_BYTES / layer_bytes))
        packed = torch.randint(0, 256, (L, IN, OUT // 2), generator=gen,
                               dtype=torch.uint8, device="cuda")
        scale = torch.rand((L, OUT), generator=gen, device="cuda") * 4e-3 \
            + 1e-3
        w16 = [dequant(Int4Tensor(packed[l], scale[l]), torch.bfloat16)
               for l in range(L)]
        xs = {}
        # the head also drafts: 8 rows a level in one stream (top-8), and
        # at B = 12 (top-4) 12 root and 48 level rows
        draft_rows = (8, 12, 48) if name == "lm_head" else ()
        for R in rows + draft_rows:
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
            if R in (48, 60, 64, 288):  # the engines' blocks, ragged
                for a in range(0, R - 15, 16 if R < 288 else 48):
                    a = min(a, R - 16)
                    small = int4_matmul(x[a:a + 16].contiguous(), packed,
                                        scale, 0, out_dtype=out_dtype)
                    fail_if(not torch.equal(small, got[a:a + 16]),
                            f"int4_matmul {label}: rows {a}..{a + 15} differ "
                            f"between R = 16 and R = {R}")
                small = int4_matmul(x[R - 16:].contiguous(), packed, scale,
                                    0, out_dtype=out_dtype)
                fail_if(not torch.equal(small, got[R - 16:]),
                        f"int4_matmul {label}: the last 16 rows differ "
                        f"between R = 16 and R = {R}")
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


def tree_parents(card: str) -> dict:
    """The host engines' two tree shapes at M = 60: the Token-Recycle
    topology (the first 60 nodes of rank_probability_tree(61)) and a
    static-SAM frequency tree (a native corpus SAM's best-first tree of 60
    nodes, self-parent padded where the SAM offers fewer), which must be
    at least 4 deep."""
    from samd_tpu_torch.drafters import rank_probability_tree
    from samd_tpu_torch.ops.treeops import pack_draft_host
    from samd_tpu_torch.sam.native import build_native_corpus_sam
    from samd_tpu_torch.sam.trees import node_depths

    rng = np.random.default_rng(0)
    sam = build_native_corpus_sam([rng.integers(0, 6, 4000).tolist()],
                                  eos_token=0, topk=8)
    sam.feed(rng.integers(0, 6, 2).tolist(), grow=False)
    toks, par = sam.tree_draft(sam.cur_state, 1, 60, 8)
    depth = int(node_depths(np.asarray(par)).max())
    fail_if(depth < 4, f"the static-SAM frequency tree is {depth} deep")
    trees = {"token_recycle": rank_probability_tree(61)[:60].tolist(),
             "sam_frequency": pack_draft_host(toks, par, 60)[1].tolist()}
    for name, par in trees.items():
        real = [p for i, p in enumerate(par) if p != i]
        print(f"tree {name}: {len(real)} real nodes of 60, depth "
              f"{int(node_depths(np.asarray(real)).max())} [{card}]",
              flush=True)
    return trees


def tree_attention_check(card, tag, T, NH, KH, D, S, cl, int8, dtype,
                         parents, seed) -> float:
    """The verify kernel (``int8``: its int8-KV mode) on the tree mask of
    ``parents`` at cache_len ``cl``: within kernel_tolerance, two runs
    bitwise equal, poison past kv_limit changing nothing; timed beside the
    plain version, SDPA with the boolean mask and the bound.  Returns the
    max |kernel - plain|."""
    import torch

    from samd_tpu_torch.cache import QuantizedKV, dequantize_kv
    from samd_tpu_torch.cache import quantize_kv_block
    from samd_tpu_torch.ops.flash_attention import (
        flash_block_attention, flash_block_attention_ref, kernel_tolerance)
    from samd_tpu_torch.tools.time_kernels import (attention_case,
                                                   library_attention)

    dname = str(dtype).split(".")[1]
    tag = f"{tag} {dname}"
    q, k, v, mask, lim = attention_case(
        T, NH, KH, D, S, cl, torch.float32 if int8 else dtype, seed=seed,
        parents=parents)
    q = q.to(dtype)
    if int8:
        (k, ks), (v, vs) = (quantize_kv_block(x) for x in (k, v))
        args = (q, k, v, mask, lim, ks, vs)
        kd = dequantize_kv(QuantizedKV(k, ks), dtype)
        vd = dequantize_kv(QuantizedKV(v, vs), dtype)
        poison = (127, 1e30)
    else:
        args, kd, vd = (q, k, v, mask, lim), k, v
        poison = (1e30, None)
    got = flash_block_attention(*args)
    again = flash_block_attention(*args)
    ref = flash_block_attention_ref(*args)
    torch.cuda.synchronize()
    err, tol_at = check_close(tag, got, ref, kernel_tolerance(ref), again)
    kv = cl + T
    bad = [x.clone() for x in args]
    bad[1][:, :, kv:] = poison[0]
    bad[2][:, :, kv:] = -poison[0]
    if int8:
        bad[5][:, :, kv:] = poison[1]
        bad[6][:, :, kv:] = poison[1]
    fail_if(not torch.equal(got, flash_block_attention(*bad)),
            f"{tag}: poison past kv_limit changed the result")
    ms = cuda_ms(lambda i: flash_block_attention(*args))
    plain_ms = cuda_ms(lambda i: flash_block_attention_ref(*args))
    library_ms = cuda_ms(library_attention(q, kd, vd, mask, lim))
    bound_ms, bound_by = attention_bound(
        T, NH, KH, D, kv, dname,
        kv_bytes=2 * kv * KH * (D + 4) if int8 else None)
    print(f"kernel flash_block_attention {tag}: max_abs_err {err:.3e} (tol "
          f"at that element {tol_at:.3e}) kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} (SDPA, boolean mask"
          f"{', dequantized live KV' if int8 else ''}) bound_ms "
          f"{bound_ms:.5f} ({bound_by}); two runs and poison bitwise equal "
          f"[{card}]", flush=True)
    return err


def tree_paged_check(card, tag, B, T, NH, KH, D, page, committed, int8,
                     parents, seed) -> float:
    """K4 over bf16 q (``int8``: int8 pages, else bf16 pages) with the tree
    of ``parents`` in every slot's window: within the tolerance, two runs
    and poisoned pools bitwise equal, every active slot bitwise equal to
    the verify kernel on its gathered KV; timed beside the plain version,
    SDPA per slot and the bound.  Returns the max |kernel - plain|."""
    import torch

    from samd_tpu_torch.ops.flash_attention import (flash_block_attention,
                                                    kernel_tolerance)
    from samd_tpu_torch.ops.paged_attention import (gather_pages,
                                                    paged_block_attention,
                                                    paged_block_attention_ref,
                                                    window_to_mask)
    from samd_tpu_torch.tools.time_kernels import library_paged, paged_case

    args, active, spare = paged_case(B, T, NH, KH, D, page, committed,
                                     torch.bfloat16, int8, seed=seed,
                                     parents=parents)
    got = paged_block_attention(*args)
    again = paged_block_attention(*args)
    poisoned = paged_block_attention(*poison_pages(args, active, spare,
                                                   page))
    ref = paged_block_attention_ref(*args)
    torch.cuda.synchronize()
    err, tol_at = check_close(f"paged_block_attention {tag}", got[active],
                              ref[active], kernel_tolerance(ref[active]),
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
        one = flash_block_attention(q[b:b + 1].contiguous(), kd, vd, mask,
                                    lims[b], *sc)
        fail_if(not torch.equal(got[b], one[0]),
                f"paged_block_attention {tag}: slot {b} differs from the "
                "verify kernel on its gathered KV")
    ms = cuda_ms(lambda i: paged_block_attention(*args))
    plain_ms = cuda_ms(lambda i: paged_block_attention_ref(*args), iters=10)
    library_ms = cuda_ms(library_paged(args, active, page))
    live = sum(int(lims[b]) for b in active)
    per_col = KH * (D + 4 if int8 else D * 2)       # K or V, per column
    nbytes = (2 * live * per_col + 2 * q.numel() * 2 + win.numel()
              + tables.numel() * 4 + B * 4)
    bound_ms, bound_by = bound(nbytes, 4 * NH * T * D * live, "bfloat16")
    print(f"kernel paged_block_attention {tag}: max_abs_err {err:.3e} (tol "
          f"at that element {tol_at:.3e}) kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} (SDPA per active slot "
          f"on its gathered live KV{', dequantized' if int8 else ''}) "
          f"bound_ms {bound_ms:.5f} ({bound_by}; {live} live columns); every "
          f"active slot bitwise equal to the verify kernel on its gathered "
          f"KV, poison changes nothing [{card}]", flush=True)
    return err


def check_tree_masks(card: str) -> None:
    """Phase 3e: the verify kernel (bf16 and f32 q at llama_1b T = 60), its
    int8 mode (llama_7b KH 32, D 128, T = 60) and K4 (bf16 pages, llama_1b
    B = 4) on the host engines' tree masks (``tree_attention_check``,
    ``tree_paged_check``)."""
    import torch

    for t, (tree, parents) in enumerate(tree_parents(card).items()):
        for label, NH, KH, D, S, cl, int8 in (
                ("llama_1b T=60 cache_len=700", 32, 4, 64, 2048, 700, False),
                ("llama_7b T=60 cache_len=700 int8-KV", 32, 32, 128, 1024,
                 700, True)):
            for dtype in (torch.bfloat16, torch.float32):
                tree_attention_check(card, f"{tree} tree {label}", 60, NH,
                                     KH, D, S, cl, int8, dtype, parents,
                                     500 + t)
        tree_paged_check(card, f"{tree} tree llama_1b B=4 T=60 bf16 pages",
                         4, 60, 32, 4, 64, 128, [300, None, 64, 900], False,
                         parents, 600 + t)


def check_hybrid_masks(card: str) -> dict:
    """Phase 3f: the fused drafters' new shapes (``tree_attention_check``,
    ``tree_paged_check``): the int8 mode at llama_7b KH 32, D 128, T = 64
    on the hybrid's relabelled 61-node tree with its self-parented
    padding; K4 over int8 pages at llama_7b B = 12, T = 24 on the server
    block's 23-node tree (one padding node) in every window; the verify
    kernel at llama_1b T = 11 (PLD's chain) and T = 61 (the fused
    Token-Recycle tree), bf16 and f32 q.  Returns the max errors."""
    import torch

    from samd_tpu_torch.fused_hybrid import build_tr_topology

    tree61 = build_tr_topology(61, 8)[0].tolist()
    tree23 = build_tr_topology(23, 8)[0].tolist()
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[("int8", dtype)] = tree_attention_check(
            card, "hybrid tree llama_7b T=64 cache_len=700 int8-KV", 64, 32,
            32, 128, 1024, 700, True, dtype, tree61 + [61, 62, 63], 700)
        errs[("pld", dtype)] = tree_attention_check(
            card, "PLD chain llama_1b T=11 cache_len=700", 11, 32, 4, 64,
            2048, 700, False, dtype, list(range(-1, 10)), 701)
        errs[("tr", dtype)] = tree_attention_check(
            card, "fused Token-Recycle tree llama_1b T=61 cache_len=700", 61,
            32, 4, 64, 2048, 700, False, dtype, tree61, 702)
    errs["k4"] = tree_paged_check(
        card, "hybrid tree llama_7b B=12 T=24 int8 pages", 12, 24, 32, 32,
        128, 128, [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700,
                   1000], True, tree23 + [23], 703)
    return errs


def eagle_tree(depth: int, topk: int, total: int, M: int, seed: int):
    """The parents of one real EAGLE-2 expansion on the card
    (``drafters.eagle.drafter.Eagle2Drafter``): a small bf16 target and
    draft net drawn from ``seed``, the stable KV of a 12-token prompt of
    random hidden states: packed in (depth, pool index) order and
    self-parent padded to M; returns the parents and the node count at
    each depth."""
    import torch

    from samd_tpu_torch.config import SamdConfig
    from samd_tpu_torch.drafters.eagle.drafter import make_eagle2
    from samd_tpu_torch.models import init_params, tiny_config
    from samd_tpu_torch.sam.trees import node_depths

    cfg = tiny_config(vocab_size=512, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, scale=0.5, device="cuda")
    d = make_eagle2(cfg, params, SamdConfig(
        max_predicts=M, eagle_depth=depth, eagle_topk=topk,
        eagle_total_tokens=total), generator=gen)
    d.observe_prompt_hidden(list(range(3, 15)), torch.randn(
        (12, cfg.hidden_size), generator=gen, device="cuda").to(cfg.dtype))
    parents = d.lookup(5).packed[1].tolist()
    width = np.bincount(node_depths(np.asarray(parents[:total + 1])))
    return parents, width.tolist()


def check_eagle_masks(card: str) -> dict:
    """Phase 3g: the EAGLE paths' new shapes (``tree_attention_check``,
    ``tree_paged_check``) on trees from real EAGLE-2 expansions
    (``eagle_tree``): the int8 mode at llama_7b KH 32, D 128, T = 64 on a
    64-node tree (depth 5, top-8: the single-stream SAM[EAGLE-2]), the
    verify kernel at llama_1b T = 64 on the same tree (FusedEagle2Engine,
    SamdEngine at M = 64), bf16 and f32 q, and K4 over int8 pages at
    llama_7b B = 12, T = 24 on a 24-node tree (depth 4, top-4: the
    server's block) in every window.  Returns the max errors."""
    import torch

    tree64, w64 = eagle_tree(5, 8, 63, 64, 801)
    tree24, w24 = eagle_tree(4, 4, 23, 24, 802)
    print(f"EAGLE-2 trees from real expansions: 64 nodes, {w64} per depth; "
          f"24 nodes, {w24} per depth [{card}]", flush=True)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[("int8", dtype)] = tree_attention_check(
            card, "EAGLE-2 tree llama_7b T=64 cache_len=700 int8-KV", 64, 32,
            32, 128, 1024, 700, True, dtype, tree64, 804)
        errs[("k1", dtype)] = tree_attention_check(
            card, "EAGLE-2 tree llama_1b T=64 cache_len=700", 64, 32, 4, 64,
            2048, 700, False, dtype, tree64, 805)
    errs["k4"] = tree_paged_check(
        card, "EAGLE-2 tree llama_7b B=12 T=24 int8 pages", 12, 24, 32, 32,
        128, 128, [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700,
                   1000], True, tree24, 806)
    return errs


def reset_counts() -> None:
    from samd_tpu_torch.ops.flash_attention import flash_block_attention
    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.paged_attention import paged_block_attention

    flash_block_attention.launches = 0
    flash_block_attention.launches_int8 = 0
    int4_matmul.launches = 0
    paged_block_attention.launches = 0
    paged_block_attention.launches_int8 = 0


# every path's launches, summed over the run for the kernels line
TOTALS: dict = {}

# every path phase's end-to-end numbers, written out after each phase
DETAIL: dict = {}


def note(prefix: str, **numbers) -> None:
    """Record a phase's end-to-end numbers as ``prefix_name`` keys (numpy
    scalars, nested too, as Python numbers, for the JSON file)."""
    for k, v in numbers.items():
        DETAIL[f"{prefix}_{k}"] = json.loads(json.dumps(
            v, default=lambda x: x.item()))


def run_numbers(runs) -> dict:
    """tok/s, ms/step and mean accept over (new tokens, steps, wall
    seconds) runs."""
    new, steps, wall = (sum(r[i] for r in runs) for i in range(3))
    return dict(tokens_per_s=new / wall, ms_per_step=wall / steps * 1e3,
                mean_accept=new / steps)


def read_counts() -> dict:
    """The launches since ``reset_counts``, added to ``TOTALS``."""
    from samd_tpu_torch.ops.flash_attention import flash_block_attention
    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.paged_attention import paged_block_attention

    counts = {"flash_block_attention": flash_block_attention.launches,
              "flash_block_attention_int8kv":
                  flash_block_attention.launches_int8,
              "int4_matmul": int4_matmul.launches,
              "paged_block_attention": paged_block_attention.launches,
              "paged_block_attention_int8kv":
                  paged_block_attention.launches_int8}
    for k, v in counts.items():
        TOTALS[k] = TOTALS.get(k, 0) + v
    return counts


def loop_line(stats, decode_steps: int) -> str:
    """A request's device loop: host reads against decode steps, graph
    replays and no-op steps (``device_loop.LoopStats``)."""
    return (f"host_reads {stats.segments}/{decode_steps} replays "
            f"{stats.replays} noop_steps {stats.noop_steps}")


def loop_check(card, label, key: str, stats, decode_steps,
               greedy: bool = True, every_step_reads: bool = False) -> None:
    """A path's device loop (``device_loop``): the steps replayed from CUDA
    graphs, each request's host reads against its decode steps, and the
    no-op steps run after a request stopped; recorded as ``key_loop_*``.
    A greedy path fails if it replayed no step, or, unless
    ``every_step_reads`` allows it (the tree engines' reruns, whose
    segments are short), if a request of more than one decode step read
    the host once per step."""
    reads = [st.segments for st in stats]
    replays = sum(st.replays for st in stats)
    noop = sum(st.noop_steps for st in stats)
    pairs = " ".join(f"{r}/{d}" for r, d in zip(reads, decode_steps))
    print(f"{label} device loop: {replays} steps replayed from graphs; host "
          f"reads / decode steps per request: {pairs}; noop_steps {noop} "
          f"[{card}]", flush=True)
    note(key, loop_replays=replays, loop_host_reads=sum(reads),
         loop_decode_steps=sum(decode_steps), loop_noop_steps=noop)
    if greedy:
        fail_if(not replays, f"{label}: no step was replayed from a graph")
        every = [i for i, (r, d) in enumerate(zip(reads, decode_steps))
                 if d > 1 and r >= d]
        fail_if(every and not every_step_reads, f"{label}: requests {every} "
                "read the host once per decode step")


class PerStep:
    """While active, ``engine`` runs its per-step route (one eager step and
    one control read per step): for recorders that read each step."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.engine.segmented = False
        return self

    def __exit__(self, *exc):
        self.engine.__dict__.pop("segmented", None)


def harvest_state(*engines) -> list:
    """Each engine's drafter state that outlives a request (the
    Token-Recycle harvest tables), to start a rerun where a judged run
    started."""
    return [(e, [(n, getattr(e, n).clone()) for n in ("harvests", "seens")
                 if hasattr(e, n)]) for e in engines]


def graph_rerun(card, label, key: str, state, run, judged, counts) -> None:
    """A path judged on the per-step route (its recorder reads every
    step), again on the graph route from the drafter ``state`` the judged
    run started from (``harvest_state``): ``run()`` serves the same
    requests and returns their (outputs, device loops).  Each output must
    equal the judged run's, with the same kernel launches; the path's
    device loop goes through ``loop_check``."""
    import torch

    for eng, saved in state:
        for name, t in saved:
            getattr(eng, name).copy_(t)
    torch.cuda.synchronize()
    reset_counts()                              # the path starts here
    t0 = time.perf_counter()
    outs, loops = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = read_counts()                       # the path ends here
    bad = [i for i, (o, j) in enumerate(zip(outs, judged)) if o != j]
    fail_if(bad or len(outs) != len(judged), f"{label}: requests {bad} "
            "differ on the graph route from the judged run")
    fail_if(again != counts, f"{label}: the graph route launched {again}, "
            f"the judged run {counts}")
    new = sum(o.decode_tokens for o in outs)
    print(f"{label}, graph route: every request equal to the judged run, "
          f"the same launches; {new / wall:.2f} tok/s (wall {wall:.3f} s, "
          f"prefills included) [{card}]", flush=True)
    note(key, graph_tokens_per_s=new / wall)
    loop_check(card, label, key, loops, [o.decode_steps for o in outs],
               every_step_reads=True)


def serve_single(engines, prompts, gen):
    """Each prompt through its single-stream engine: (outputs, device
    loops), for ``graph_rerun``."""
    outs, loops = [], []
    for name, p in prompts.items():
        outs.append(engines[name].generate(p, gen))
        loops.append(engines[name].loop_stats)
    return outs, loops


def serve_batched_loops(engine, requests, vocab):
    """``serve_batched``'s outputs and device loops, for ``graph_rerun``."""
    outs, _, _ = serve_batched(engine, requests, vocab)
    return outs, list(LAST_LOOPS)


def serve(card, name_cfg, engines, prompts, refs, gen, vocab, key: str,
          tps_key: str = "") -> list:
    """Run each request on its engine and check it against the oracle's
    tokens; returns each request's (prompt length, decode steps).  The
    requests' tok/s (request walls, prefills included; under ``tps_key``
    where given), ms/step and mean accept go to the detail as ``key_*``."""
    import torch

    done, runs, loops = [], [], []
    for name, p in prompts.items():
        t0 = time.perf_counter()
        out = engines[name].generate(p, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loops.append(engines[name].loop_stats)
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
              f"prefill included) {loop_line(loops[-1], out.decode_steps)} "
              f"equal_to_oracle True [{card}]", flush=True)
        done.append((len(p), out.decode_steps))
        runs.append((out.decode_tokens, out.decode_steps, dt))
    loop_check(card, name_cfg, key, loops, [d for _, d in done])
    numbers = run_numbers(runs)
    DETAIL[tps_key or f"{key}_tokens_per_s"] = numbers.pop("tokens_per_s")
    note(key, **numbers, equal_to_oracle=f"{len(done)}/{len(prompts)}")
    return done


def main_path_1b(card: str) -> int:
    """Phase 4: llama_1b, bf16, verify kernel."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
    from samd_tpu_torch.models import init_params, llama_1b, param_count

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

    print(f"param_count: llama_1b {param_count(params)}", flush=True)
    note("phase4_llama_1b", param_count=param_count(params))
    reset_counts()                              # the path starts here
    done = serve(card, "llama_1b", engines, prompts, refs, gen,
                 cfg.vocab_size, "phase4_llama_1b_fused_sam",
                 tps_key="fused_sam_tokens_per_s")
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
    sampled_1b(card, cfg, plain_engine, prompts["c_repetitive"])
    point_mass_1b(card, engines, prompts, refs)
    chain_rejection_tv(card)
    return launches


# every draw of a sampled request forced: top_k = 1 (or a nucleus of the
# top token alone) in the chain, and a temperature so low that the first
# token, drawn from last_logits / temperature without top-p/top-k as in the
# reference, is the argmax.  Such a request's answer is the greedy oracle's.
POINT_MASS = {"rejection": dict(temperature=1e-5, top_k=1),
              "nucleus": dict(temperature=1e-5, top_p=1e-6)}


def point_mass_1b(card, engines, prompts, refs) -> None:
    """Phase 4, sampled with an independent answer: point-mass requests
    through the sampling branch equal the ArBaseline oracle token for
    token, on prompts whose chains accept one token a step and many."""
    from samd_tpu_torch.config import GenerationConfig

    runs = (("rejection", "b_own_corpus"), ("rejection", "c_repetitive"),
            ("nucleus", "a_random"), ("nucleus", "b_own_corpus"))
    for i, (mode, name) in enumerate(runs):
        ref = refs[name]
        gen = GenerationConfig(
            max_new_tokens=ref.decode_tokens, max_cache_len=2048,
            greedy=False, seed=60 + i, accept_mode=mode, **POINT_MASS[mode])
        out = engines[name].generate(prompts[name], gen)
        if out.output_ids != ref.output_ids:
            diff = next((j for j, (a, b) in enumerate(
                zip(out.output_ids, ref.output_ids)) if a != b),
                min(len(out.output_ids), len(ref.output_ids)))
            raise SystemExit(f"llama_1b point-mass {mode} request {name}: "
                             f"tokens differ from the oracle at {diff}")
        print(f"llama_1b point-mass sampled {mode} {POINT_MASS[mode]} "
              f"request {name}: new {out.decode_tokens} decode_steps "
              f"{out.decode_steps} mean_accept "
              f"{out.decode_tokens / out.decode_steps:.3f}; "
              f"{loop_line(engines[name].loop_stats, out.decode_steps)}; "
              f"equal to the ArBaseline oracle [{card}]", flush=True)


def sampled_1b(card, cfg, engine, prompt) -> None:
    """Phase 4, sampled: one request per accept mode, each twice with its
    seed, must give the same tokens both times (and tokens of the
    vocabulary, within budget); every forward through the verify kernel."""
    import torch

    from samd_tpu_torch.config import GenerationConfig

    modes = {"rejection": dict(temperature=0.8, top_k=50),
             "typical": dict(temperature=0.8),
             "nucleus": dict(temperature=0.8, top_p=0.9)}
    new = 64
    for mode, knobs in modes.items():
        gen = GenerationConfig(max_new_tokens=new, max_cache_len=2048,
                               greedy=False, seed=17, accept_mode=mode,
                               **knobs)
        reset_counts()                          # this request's path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = engine.generate(prompt, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        loop = engine.loop_stats
        b = engine.generate(prompt, gen)
        fail_if(a.output_ids != b.output_ids,
                f"llama_1b sampled {mode}: the same seed gave other tokens")
        with PerStep(engine):
            c = engine.generate(prompt, gen)
        fail_if(c != a, f"llama_1b sampled {mode}: the per-step route gave "
                "other tokens or steps than the graph route")
        fail_if(a.decode_tokens != new or not all(
            0 <= t < cfg.vocab_size for t in a.output_ids),
                f"llama_1b sampled {mode}: malformed output")
        want = cfg.num_layers * (1 + a.decode_steps)
        fail_if(counts["flash_block_attention"] != want or any(
            v for k, v in counts.items() if k != "flash_block_attention"),
                f"llama_1b sampled {mode}: launch counts {counts}, expected "
                f"{want} verify launches")
        print(f"llama_1b sampled {mode} {knobs}: new {a.decode_tokens} "
              f"decode_steps {a.decode_steps} mean_accept "
              f"{a.decode_tokens / a.decode_steps:.3f} ms_per_step "
              f"{dt / a.decode_steps * 1e3:.3f} (prefill included); the "
              f"same tokens on a second run with seed 17 and on the "
              f"per-step route; verify launches {want}; "
              f"{loop_line(loop, a.decode_steps)} [{card}]", flush=True)


def chain_rejection_tv(card) -> None:
    """Phase 4, on the card: chain_sampling_accept over 4000 trials at
    V = 8 with noise from the card's generator; the emitted token's total
    variation from the target softmax stays under 0.05, for a likely and
    an unlikely proposal."""
    import torch

    from samd_tpu_torch.fused_sam import (ChainNoise, chain_sampling_accept,
                                          gumbel_from_uniform)

    V, n = 8, 4000
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, V)).astype(np.float32) * 2).cuda()
    target = torch.softmax(logits[0], dim=-1).cpu().numpy()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    order = np.argsort(-target)
    for label, tok in (("likely", int(order[0])), ("unlikely",
                                                   int(order[-2]))):
        noise = ChainNoise(
            torch.rand((n, 2), generator=gen, device="cuda"),
            gumbel_from_uniform(torch.rand((n, 1, V), generator=gen,
                                           device="cuda")))
        draft = torch.tensor([5, tok], device="cuda").expand(n, 2)
        alen, bonus = chain_sampling_accept(
            logits.expand(n, 2, V), draft,
            torch.full((n,), 2, device="cuda"), noise)
        emitted = torch.where(alen >= 2, tok, bonus).cpu().numpy()
        freq = np.bincount(emitted, minlength=V) / n
        tv = 0.5 * np.abs(freq - target).sum()
        fail_if(not tv < 0.05, f"chain rejection on the card: total "
                f"variation {tv:.4f} >= 0.05 ({label} proposal)")
        print(f"chain rejection on the card, {label} proposal (p = "
              f"{target[tok]:.4f}): total variation {tv:.4f} < 0.05 over "
              f"{n} trials, accepted {float((alen >= 2).float().mean()):.3f}"
              f" [{card}]", flush=True)


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
    from samd_tpu_torch.models import param_count

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

    print(f"param_count: llama_7b int4 {param_count(params)}", flush=True)
    note("phase5_llama_7b_int4", param_count=param_count(params))
    reset_counts()                              # the path starts here
    done = serve(card, "llama_7b int4 int8-KV", engines, prompts, refs, gen,
                 cfg.vocab_size, "phase5_llama_7b_int4_fused_sam",
                 tps_key="int4_7b_fused_sam_tokens_per_s")
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
    LAST_LOOPS[:] = [engine.loop_stats[i] for i in ids] \
        if hasattr(engine, "loop_stats") else []
    return outs, wall, engine.steps_run - steps0


# the last ``serve_batched`` call's requests' device loops, in order
LAST_LOOPS: list = []


def report_batched(card, label, requests, outs, wall, steps, oracle,
                   key: str, tps_key: str = ""):
    """Check every request against the oracle's tokens; print the run's
    numbers and record them as ``key_*`` (tok/s under ``tps_key`` where
    given)."""
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
    DETAIL[tps_key or f"{key}_tokens_per_s"] = float(new / wall)
    note(key, ms_per_step=wall / steps * 1e3, mean_accept=new / slot_steps,
         equal_to_oracle=f"{len(outs)}/{len(oracle)}")
    loop_check(card, label, key, LAST_LOOPS, [o.decode_steps for o in outs])


def phase6_requests(V: int) -> list:
    """Phase 6's 16 (prompt, budget) requests: 11 prompts of 40-128
    tokens, one of 200, and four repeats of earlier prompts."""
    rng = np.random.default_rng(11)
    fresh = [(rng.integers(3, V, size=int(n)).tolist(),
              int(rng.integers(32, 129)))
             for n in rng.integers(40, 129, size=11)]
    fresh.append((rng.integers(3, V, size=200).tolist(),
                  int(rng.integers(32, 129))))
    return fresh + fresh[:4]          # four repeats of earlier prompts


def main_path_7b_paged(card: str, cfg, params) -> int:
    """Phase 6: llama_7b int4 weights over int8 pages, B = 12."""
    import torch

    from samd_tpu_torch.fused_sam import (FusedSamConfig, FusedSamEngine,
                                          PagedBatchedFusedSamEngine)

    S, B, page, n_pages = 1024, 12, 128, 52
    kw = dict(batch_size=B, max_cache_len=S, eos_token_id=-1,
              prefill_buckets=(128, 256), n_pages=n_pages, page_size=page,
              quantized_kv=True)
    requests = phase6_requests(cfg.vocab_size)

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
                   outs, wall, steps, oracle, "phase6_llama_7b_int4_paged",
                   tps_key="int4_7b_paged_batched_tokens_per_s")
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
    note("phase6_llama_7b_int4_paged", peak_pages=eng.peak_pages)
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
    return counts["paged_block_attention_int8kv"], requests, oracle


def http_post(url: str, body: dict, timeout: float = 900):
    """POST /generate; returns (status, reply JSON)."""
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def http_traffic(url: str, bodies: list, label: str) -> list:
    """Send every body from four client threads; every reply must be 200;
    returns the replies in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda b: http_post(url, b), bodies))
    for i, (code, reply) in enumerate(got):
        fail_if(code != 200, f"server {label} request {i}: HTTP {code} "
                f"{reply}")
    return [reply for _, reply in got]


def idle(sched) -> None:
    """Wait until the scheduler holds no sampling signature: the last
    replies of a traffic group can arrive before its driver thread clears
    it, and a request of another signature sent then would get 400."""
    deadline = time.monotonic() + 60
    while sched.stats()["sampling_signature"] is not None:
        fail_if(time.monotonic() > deadline,
                "server: the sampling signature was never released")
        time.sleep(0.01)


def query_windows(corpus: np.ndarray, hi: int, n: int, Q: int, ext: int,
                  rng):
    """n (query [Q], tail [ext], tail_len) windows of the draft function:
    each a history of up to 200 tokens cut from ``corpus[:hi]``, and its
    next token as the start."""
    qs, ts, tls = [], [], []
    for _ in range(n):
        hlen = int(rng.integers(0, 200))
        s = int(rng.integers(hlen, hi))
        hist = corpus[s - hlen:s].tolist()
        q = [-1] * (Q - 1) + hist
        q = q[len(q) - (Q - 1):] + [int(corpus[s])]
        pre = hist[:max(0, hlen - (Q - 1))]
        t = ([-1] * ext + pre)[-ext:]
        qs.append(q)
        ts.append(t)
        tls.append(min(ext, len(pre)))
    return (np.asarray(qs, np.int32), np.asarray(ts, np.int32),
            np.asarray(tls, np.int32))


def index_against_scan(card, eng) -> None:
    """Phase 8: the engine's index probe equals the scan on 64 queries cut
    from the random three quarters of its 2^20-token corpus, integer for
    integer (random tokens over 32000 ids repeat no 8-gram, so the scan's
    earliest full window is the longest match); both timed at the
    engine's B = 12 step shape."""
    import torch

    from samd_tpu_torch.fused_sam import suffix_match
    from samd_tpu_torch.ops.ngram_index import indexed_suffix_match

    fc = eng.cfg
    n = int(eng.corpus_len)
    corpus = eng.corpus[:n].cpu().numpy()
    q, t, tl = (torch.from_numpy(a).cuda() for a in query_windows(
        corpus, 3 * n // 4, 64, fc.max_ngram, fc.ext,
        np.random.default_rng(5)))
    kw = dict(max_ngram=fc.max_ngram, ext=fc.ext)

    def probe(b):
        return indexed_suffix_match(eng.corpus, eng.corpus_len,
                                    eng.corpus_index, q[:b], t[:b], tl[:b],
                                    **kw)

    def scan(b):
        return suffix_match(eng.corpus[None], eng.corpus_len, q[:b], t[:b],
                            tl[:b], **kw)

    (mi, ei), (ms, es) = probe(64), scan(64)
    fail_if(not (torch.equal(mi, ms) and torch.equal(ei, es)),
            f"index probe differs from the scan: {(mi != ms).sum().item()} "
            f"match lengths, {(ei != es).sum().item()} end positions of 64")
    probe_ms = cuda_ms(lambda i: probe(12), iters=20)
    scan_ms = cuda_ms(lambda i: scan(12), iters=5, warmup=2)
    print(f"index probe vs scan over the {n}-token corpus: equal on 64 "
          f"queries (match lengths {mi.min().item()}..{mi.max().item()}, "
          f"{int((mi >= fc.max_ngram).sum())} full windows); B = 12: probe "
          f"{probe_ms:.4f} ms, scan {scan_ms:.4f} ms [{card}]", flush=True)


def main_path_server(card: str, cfg, params, requests, oracle) -> dict:
    """Phase 8: the HTTP server over the paged 7B engine (int4 weights,
    int8 pages, B = 12) with a 2^20-token indexed corpus."""
    import torch

    from samd_tpu_torch.fused_sam import (FusedSamConfig,
                                          PagedBatchedFusedSamEngine)
    from samd_tpu_torch.server import serve

    S, B, page, n_pages = 1024, 12, 128, 52
    C = 1 << 20
    rng = np.random.default_rng(21)
    corpus = rng.integers(3, cfg.vocab_size, size=C).astype(np.int32)
    at = 3 * C // 4 + 12345                   # the last quarter
    for o in oracle[12:16]:                   # the four repeats' outputs
        doc = np.asarray(o.output_ids + [0], np.int32)
        corpus[at:at + len(doc)] = doc
        at += len(doc) + int(rng.integers(1000, 5000))
    fc = FusedSamConfig(n_predicts=15, steps_per_call=16, corpus_capacity=C,
                        indexed=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = PagedBatchedFusedSamEngine(
        cfg, params, fc, corpus=corpus, batch_size=B, max_cache_len=S,
        eos_token_id=-1, prefill_buckets=(128, 256), n_pages=n_pages,
        page_size=page, quantized_kv=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    idx = eng.corpus_index
    print(f"server engine: {C}-token corpus, index of {len(idx.grams)} "
          f"tables x {idx.table.shape[1]} buckets x {idx.bucket_cap} = "
          f"{idx.nbytes} bytes ({idx.nbytes / 2 ** 20:.1f} MiB) on the card;"
          f" engine and index built in {build_s:.2f} s [{card}]", flush=True)
    index_against_scan(card, eng)
    # the same greedy requests straight through the engine, all queued at
    # once, for the server's cost beside it
    alone, wall, steps = serve_batched(eng, requests, cfg.vocab_size)
    wall_alone, steps_alone = wall, steps
    fail_if(any(a.output_ids != o.output_ids for a, o in zip(alone, oracle)),
            "server engine alone: tokens differ from the alpha = 0 oracle")
    print(f"server engine alone (no HTTP, 16 greedy requests queued at "
          f"once): {steps} steps, wall {wall:.3f} s: "
          f"{sum(a.decode_tokens for a in alone) / wall:.2f} tok/s, "
          f"{wall / steps * 1e3:.3f} ms/step; every request equal to the "
          f"alpha = 0 oracle [{card}]", flush=True)
    loop_check(card, "server engine alone", "phase8_server_alone",
               LAST_LOOPS, [a.decode_steps for a in alone])

    def body(p, n, **kw):
        return {"input_ids": p, "max_new_tokens": n, "max_cache_len": S,
                **kw}

    samp = dict(temperature=0.8, accept_mode="rejection")
    server, sched = serve(eng, host="127.0.0.1", port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    sent = []             # (prompt, budget) of every request the engine ran
    try:
        reset_counts()                          # the path starts here
        mark = (eng.steps_run, eng.stats_live_steps, eng.stats_corpus_steps)

        def timed(bodies, label):
            s0, l0 = eng.steps_run, eng.stats_live_steps
            t0 = time.perf_counter()
            replies = http_traffic(url, bodies, label)
            wall = time.perf_counter() - t0
            sent.extend((b["input_ids"], b["max_new_tokens"])
                        for b in bodies)
            for b, r in zip(bodies, replies):
                out = r["output_ids"]
                fail_if(len(out) != len(b["input_ids"]) + b["max_new_tokens"]
                        or out[:len(b["input_ids"])] != b["input_ids"]
                        or not all(0 <= x < cfg.vocab_size for x in out),
                        f"server {label}: malformed reply")
            new = sum(r["new_tokens"] for r in replies)
            steps = eng.steps_run - s0
            live = eng.stats_live_steps - l0
            print(f"server {label}: {len(bodies)} requests over HTTP from "
                  f"four client threads, {new} new tokens, {steps} steps of "
                  f"[12, 16] ({live / steps:.2f} live slots per step), wall "
                  f"{wall:.3f} s: {new / wall:.2f} tok/s, "
                  f"{wall / steps * 1e3:.3f} ms/step [{card}]", flush=True)
            note("phase8_server_" + label.replace(" ", "_").replace("-", "_"),
                 tokens_per_s=new / wall, ms_per_step=wall / steps * 1e3)
            return replies

        # greedy: phase 6's 16 requests, each equal to its alpha = 0 oracle
        greedy = timed([body(p, n) for p, n in requests], "greedy")
        for i, (r, o) in enumerate(zip(greedy, oracle)):
            fail_if(r["output_ids"] != o.output_ids, f"server greedy request "
                    f"{i}: tokens differ from the alpha = 0 oracle")
        loop_check(card, "server greedy", "phase8_server_greedy",
                   [eng.loop_stats[r["request_id"]] for r in greedy],
                   [r["decode_steps"] for r in greedy])
        acc = [r["new_tokens"] / r["decode_steps"] for r in greedy]
        note("phase8_server_greedy", equal_to_oracle=f"{len(greedy)}/16",
             mean_accept=sum(r["new_tokens"] for r in greedy)
             / sum(r["decode_steps"] for r in greedy))
        rep = [0, 1, 2, 3, 12, 13, 14, 15]     # outputs held by the corpus
        print(f"server greedy: all 16 replies equal the alpha = 0 oracle; "
              f"mean accept {np.mean([acc[i] for i in rep]):.3f} on the four"
              f" repeated prompts (8 requests, outputs in the corpus), "
              f"{np.mean([a for i, a in enumerate(acc) if i not in rep]):.3f}"
              f" on the other 8", flush=True)

        # sampled: four prompts, each twice with one seed
        pairs = [body(p, n, seed=100 + i, **samp)
                 for i, (p, n) in enumerate(requests[:4])]
        sampled = timed([b for b in pairs for _ in range(2)], "sampled")
        for i in range(4):
            fail_if(sampled[2 * i]["output_ids"]
                    != sampled[2 * i + 1]["output_ids"],
                    f"server sampled prompt {i}: one seed, two outputs")

        # mixed: greedy and sampled requests in turn, so the four in
        # flight at any time hold both kinds in one batch
        mixed_b = [b for i, (p, n) in enumerate(requests[:6]) for b in (
            body(*requests[4 + i]), body(p, n, seed=200 + i, **samp))]
        mixed = timed(mixed_b, "mixed")
        for i, r in enumerate(mixed[0::2]):
            fail_if(r["output_ids"] != oracle[4 + i].output_ids,
                    f"server mixed greedy request {i}: tokens differ from "
                    "the alpha = 0 oracle")
        fail_if(mixed[1]["output_ids"] == sampled[0]["output_ids"],
                "server: seeds 100 and 200 gave the same tokens on prompt 0")
        print("server sampled: each pair equal per seed; seeds 100 and 200 "
              "differ on prompt 0; mixed batch: its 6 greedy replies equal "
              "the oracle", flush=True)

        # point-mass sampled requests (every draw forced) beside greedy
        # ones: each reply equals the alpha = 0 oracle; the first four
        # prompts' outputs are in the corpus, so their chains run long
        idle(sched)                     # a new signature: after the last
        pm = dict(POINT_MASS["rejection"], accept_mode="rejection")
        pm_b = [body(p, n, seed=300 + i, **pm)
                for i, (p, n) in enumerate(requests[:8])]
        pm_b[2:2] = [body(*requests[8])]
        pm_b[5:5] = [body(*requests[9])]
        pm_b += [body(*r) for r in requests[10:12]]
        order = [0, 1, 8, 2, 3, 9, 4, 5, 6, 7, 10, 11]
        point = timed(pm_b, "point-mass mixed")
        for k, r in zip(order, point):
            fail_if(r["output_ids"] != oracle[k].output_ids,
                    f"server point-mass mixed request {k}: tokens differ "
                    "from the alpha = 0 oracle")
        acc = [r["new_tokens"] / r["decode_steps"] for r in point]
        print(f"server point-mass: 8 sampled replies (top_k 1, temperature "
              f"1e-5) and 4 greedy ones beside them equal the alpha = 0 "
              f"oracle; mean accept {np.mean(acc[:2] + acc[3:5]):.3f} on "
              f"the four sampled requests whose outputs are in the corpus",
              flush=True)

        # one SSE request on a prompt that commits about one token a step,
        # so over several segments: its chunks equal its blocking reply
        p4, n4 = requests[4]
        raw = urllib.request.urlopen(urllib.request.Request(
            f"{url}/generate", data=json.dumps(body(p4, n4, stream=True))
            .encode(), headers={"Content-Type": "application/json"}),
            timeout=900)
        events = [json.loads(line.decode()[len("data: "):])
                  for line in raw if line.startswith(b"data: ")]
        raw.close()
        sent.append((p4, n4))
        streamed = [x for e in events[:-1] for x in e["tokens"]]
        fail_if(not events or not events[-1].get("done")
                or len(events) < 3
                or streamed != greedy[4]["output_ids"][len(p4):]
                or events[-1]["output_ids"] != greedy[4]["output_ids"],
                f"server SSE: {len(events) - 1} chunks; fewer than 2, or "
                "they differ from the blocking reply")
        print(f"server SSE: {len(events) - 1} chunks concatenate to the "
              f"blocking reply's {len(streamed)} tokens", flush=True)

        # a conflicting signature while a sampled request is in flight
        import threading

        before = sched.stats()["submitted"]
        bg = {}
        long = threading.Thread(target=lambda: bg.update(
            r=http_post(url, body(requests[1][0], 128, seed=7, **samp))))
        long.start()
        while sched.stats()["submitted"] == before:
            time.sleep(0.01)
        code, reply_c = http_post(url, body(requests[2][0], 16,
                                            temperature=0.5))
        long.join(timeout=900)
        fail_if(long.is_alive(), "server: the request in flight never ended")
        sent.append((requests[1][0], 128))
        fail_if(code != 400 or "signature" not in reply_c.get("error", ""),
                f"server: a conflicting signature got {code} {reply_c}")
        fail_if(bg["r"][0] != 200, f"server: the request in flight got "
                f"{bg['r']}")
        # bodies the engine cannot serve: 400 before the driver thread,
        # and the server serves on
        idle(sched)
        p2, n2 = requests[2]
        bad = [body(p2 + [cfg.vocab_size], n2), body([-1] + p2, n2),
               body((p2 * 8)[:257], n2),         # past the bucket of 256
               body(p2, n2, temperature=0.8, top_k=cfg.vocab_size + 1),
               body(p2, "16")]
        for b in bad:
            code, reply = http_post(url, b)
            fail_if(code != 400, f"server: a body it cannot serve got "
                    f"{code} {reply}")
        code, reply = http_post(url, body(p2, n2))
        sent.append((p2, n2))
        fail_if(code != 200 or reply["output_ids"] != oracle[2].output_ids,
                f"server: after the bad bodies, HTTP {code} or tokens "
                "other than the oracle's")
        with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
            health = json.loads(r.read())
        fail_if(health.get("status") != "ok", f"server health: {health}")
        print(f"server: a conflicting signature got 400 ({reply_c['error']});"
              f" {len(bad)} bodies it cannot serve (ids outside the "
              f"vocabulary, a prompt past the largest bucket, top_k past the"
              f" vocabulary, a string budget) got 400, and the next request "
              f"equals the oracle; health {health}", flush=True)
        counts = read_counts()                  # the path ends here
    finally:
        server.shutdown()
        server.server_close()
        sched.close()
    steps = eng.steps_run - mark[0]
    live = eng.stats_live_steps - mark[1]
    from_corpus = eng.stats_corpus_steps - mark[2]
    fail_if(len(eng.pool._free) != n_pages or eng.live_kv_tokens() != 0,
            f"server: {n_pages - len(eng.pool._free)} pages not returned")
    p128 = sum(len(p) <= 128 for p, _ in sent)
    want = {"flash_block_attention": cfg.num_layers * p128,
            "flash_block_attention_int8kv": 0,
            "int4_matmul": (7 * cfg.num_layers + 1) * (steps + len(sent)),
            "paged_block_attention": 0,
            "paged_block_attention_int8kv": cfg.num_layers * steps}
    fail_if(counts != want or not steps,
            f"server: launch counts {counts}, expected {want} (K4 int8 32 "
            "per step, the bf16 verify 32 per P = 128 prefill, K3 225 per "
            "forward)")
    print(f"server path: {len(sent)} requests, {steps} steps; K4 int8 "
          f"launches {counts['paged_block_attention_int8kv']} = 32 x {steps};"
          f" bf16 verify {counts['flash_block_attention']} = 32 x {p128} "
          f"P = 128 prefills; int4_matmul {counts['int4_matmul']} = 225 x "
          f"{steps + len(sent)} forwards; drafts from the corpus in "
          f"{from_corpus} of {live} live slot-steps "
          f"({from_corpus / live:.3f}); peak_pages {eng.peak_pages} of "
          f"{n_pages}; all pages returned [{card}]", flush=True)
    note("phase8_server", peak_pages=eng.peak_pages,
         alone_tokens_per_s=sum(a.decode_tokens for a in alone) / wall_alone,
         alone_ms_per_step=wall_alone / steps_alone * 1e3)
    del eng
    gc.collect()
    return counts


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
                       wall, steps, oracle, f"phase7_llama_1b_{name}_b4")
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
            note("phase7_llama_1b_paged_b4", peak_pages=eng.peak_pages)
        runs[name] = (outs, counts, corpus)
        del eng
        gc.collect()
    dense, paged = runs["dense"][0], runs["paged"][0]
    agree = sum(a.output_ids == b.output_ids for a, b in zip(dense, paged))
    print(f"llama_1b batched: dense and paged engines agree on {agree} of "
          f"{len(requests)} requests (not required: the dense engine attends "
          f"plainly over all S columns, the paged one through K4); K4 bf16 "
          f"launches {runs['paged'][1]['paged_block_attention']} [{card}]",
          flush=True)
    classify_dense_paged(card, cfg, params, dense, paged)
    # the scratch run: the dense engine with f32 probabilities in the plain
    # attention, as K4 keeps them
    import samd_tpu_torch.models.llama as llama

    saved = llama._attention
    llama._attention = attention_f32_probs
    try:
        f32, _, _ = serve_batched(BatchedFusedSamEngine(
            cfg, params, fcfg(), corpus=runs["dense"][2], **kw), requests,
            cfg.vocab_size)
    finally:
        llama._attention = saved
    print(f"llama_1b batched, scratch run with f32 probabilities in the "
          f"dense engine's plain attention: agrees with the paged engine on "
          f"{sum(a.output_ids == b.output_ids for a, b in zip(f32, paged))} "
          f"and with the bf16-probability dense run on "
          f"{sum(a.output_ids == b.output_ids for a, b in zip(f32, dense))} "
          f"of {len(requests)} requests [{card}]", flush=True)
    return runs["paged"][1]["paged_block_attention"]


def attention_f32_probs(q, k, v, mask, cfg):
    """A scratch copy of ``models.llama._attention`` that keeps the
    probabilities in f32 for the second product (as K4 does) instead of
    casting them to v's type."""
    import torch

    from samd_tpu_torch.models.llama import NEG_INF

    B, T = q.shape[0], q.shape[1]
    KH, G, D = cfg.num_kv_heads, cfg.kv_groups, cfg.head_dim
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4)
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    scores = scores * (D ** -0.5)
    bias = torch.where(mask[:, None, None], 0.0, NEG_INF)
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.matmul(probs, v.float()[:, :, None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, KH * G * D)


def classify_dense_paged(card, cfg, params, dense, paged) -> None:
    """Phase 7's disagreements by the near-tie rule: at each request's
    first divergent token, the logits of one plain-attention prefill over
    the shared prefix (canonical columns), with the probabilities cast to
    bf16 as the dense engine does and kept in f32 as K4 does: the top-2
    gap, and the gap between the dense and the paged engine's tokens
    (a near-tie when |gap| <= 0.08, ``evaluation/neartie.py``'s tau)."""
    import torch

    import samd_tpu_torch.models.llama as llama
    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.models import forward, prefill_mask

    pcfg = dataclasses.replace(cfg, attention_impl="xla")

    def next_logits(prefix, f32_probs):
        P = len(prefix)
        kv = init_kv_cache(pcfg, 1, P, "cuda")
        toks = torch.tensor(prefix, dtype=torch.int32, device="cuda")[None]
        saved = llama._attention
        if f32_probs:
            llama._attention = attention_f32_probs
        try:
            logits, _ = forward(params, pcfg, toks,
                                torch.arange(P, device="cuda")[None], *kv, 0,
                                prefill_mask(1, P, P, "cuda"))
        finally:
            llama._attention = saved
        return logits[0, -1].float()

    for i, (d, p) in enumerate(zip(dense, paged)):
        a, b = d.output_ids, p.output_ids
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        parts = []
        for f32 in (False, True):
            lg = next_logits(a[:j], f32)
            top = torch.topk(lg, 2)
            parts.append(
                f"{'f32' if f32 else 'bf16'} probabilities: argmax "
                f"{int(top.indices[0])}, top-2 gap "
                f"{float(top.values[0] - top.values[1]):.5f}, "
                f"logit[dense] - logit[paged] "
                f"{float(lg[a[j]] - lg[b[j]]):.5f}")
        print(f"llama_1b batched request {i}: dense and paged diverge at "
              f"token {j} (dense {a[j]}, paged {b[j]}); " + "; ".join(parts)
              + f" [{card}]", flush=True)


class DraftLog:
    """A host drafter that records, for each draft it hands out, whether
    it is a chain (parents[i] == i - 1 over its real nodes) and its node
    count; everything else is the wrapped drafter's."""

    def __init__(self, inner):
        self.inner = inner
        self.chains, self.nodes = [], []

    def reset(self):
        self.chains, self.nodes = [], []
        self.inner.reset()

    def lookup(self, start_token):
        d = self.inner.lookup(start_token)
        n = d.num_nodes
        par = d.packed[1, :n]
        if not isinstance(par, np.ndarray):     # a draft built on the card
            par = par.cpu().numpy()
        self.chains.append(bool((par == np.arange(-1, n - 1)).all()))
        self.nodes.append(n)
        return d

    def __getattr__(self, name):
        return getattr(self.inner, name)


def run_lengths(xs) -> str:
    """``[60, 60, 60, 1]`` as ``"60x3 1"``: node counts per step."""
    out, i = [], 0
    while i < len(xs):
        j = i
        while j < len(xs) and xs[j] == xs[i]:
            j += 1
        out.append(f"{xs[i]}x{j - i}" if j - i > 1 else str(xs[i]))
        i = j
    return " ".join(out)


def warm_token_recycle(tr, vocab, rng, trajectories=()) -> None:
    """Fill a Token-Recycle cache as a long-served engine holds it: every
    token has a harvest (seeded random top-8, so every tree has its full
    node count), and each ``(tokens, oracle rows)`` trajectory carries the
    oracle's own top-8 after each of its tokens, as a prior run of the
    same request leaves it (its trees follow the request's path)."""
    import torch

    from samd_tpu_torch.engine import HARVEST_TOPK, harvest_topk

    tr.harvest(np.arange(vocab), rng.integers(3, vocab,
                                              size=(vocab, HARVEST_TOPK)))
    for tokens, rows in trajectories:
        topk = harvest_topk(torch.stack(rows), HARVEST_TOPK)
        tr.harvest(np.asarray(tokens[:len(rows)]), topk.cpu().numpy())


def plain_next_logits(cfg, params, prefix):
    """The logits after ``prefix`` from one plain-attention prefill over
    it (canonical columns): a computation independent of the verify
    kernel's."""
    import torch

    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.models import forward, prefill_mask

    pcfg = dataclasses.replace(cfg, attention_impl="xla")
    P = len(prefix)
    kv = init_kv_cache(pcfg, 1, P, "cuda")
    toks = torch.tensor(prefix, dtype=torch.int32, device="cuda")[None]
    logits, _ = forward(params, pcfg, toks,
                        torch.arange(P, device="cuda")[None], *kv, 0,
                        prefill_mask(1, P, P, "cuda"))
    return logits[0, -1].float()


class AcceptRows:
    """Records, while active, the logits rows each greedy accept of the
    engine modules read.  ``oracle``: row 0, the one real token of a
    single-token-drafter oracle's block (its canonical-column logits for
    every token it emits).  ``path``: the rows of the accepted path's
    nodes, whose argmaxes are the tokens the engine emits.  ``steps``
    holds one tensor per step ([V] / [D, V] single stream, [B, V] /
    [B, D, V] batched), on the card."""

    def __init__(self, kind: str):
        self.kind = kind
        self.steps = []

    def __enter__(self):
        import torch

        import samd_tpu_torch.batching as batching
        import samd_tpu_torch.engine as engine

        self._saved = [(m, m.greedy_accept) for m in (engine, batching)]
        for mod, orig in self._saved:
            def rec(logits, tokens, paths, orig=orig):
                res = orig(logits, tokens, paths)
                if self.kind == "oracle":
                    self.steps.append(logits[..., 0, :].float().clone())
                else:
                    idx = res.path_nodes.clamp(min=0).long()
                    self.steps.append(torch.take_along_dim(
                        logits, idx[..., None], dim=-2).float())
                return res
            mod.greedy_accept = rec
        return self

    def __exit__(self, *exc):
        for mod, orig in self._saved:
            mod.greedy_accept = orig


def batched_rows(engine, rows: AcceptRows) -> dict:
    """Wrap a batched engine's step so that each request id maps to its
    own rows of ``rows.steps`` (one per step it took, in order)."""
    per_rid = {}
    orig = engine._dispatch

    def dispatch(cache_lens, drafts, stepping):
        rids = [engine.slots[i].request_id for i in stepping]
        out = orig(cache_lens, drafts, stepping)
        for i, rid in zip(stepping, rids):
            per_rid.setdefault(rid, []).append(rows.steps[-1][i])
        return out
    engine._dispatch = dispatch
    return per_rid


TOP_SPREAD = 16     # the oracle's top tokens over which a drift is taken


def drift(rows, oracle_rows):
    """[N] drifts of ``rows`` from ``oracle_rows`` (both [N, V]): the range
    over each oracle row's top 16 tokens of (row - oracle row), how far
    the gaps between its likely tokens moved."""
    import torch

    top = oracle_rows.topk(TOP_SPREAD, dim=-1).indices
    d = torch.gather(rows - oracle_rows, -1, top)
    return (d.amax(-1) - d.amin(-1)).cpu().numpy()


NEAR_TIE = 0.08    # evaluation/neartie.py's bound: bf16 rounding alone


def top2_gap_changes(oracle_rows, plain_rows) -> np.ndarray:
    """[N] |change| that the plain rows make to each oracle row's top-2
    gap (its best token's logit less its second's)."""
    import torch

    top2 = torch.as_tensor(oracle_rows).topk(2, dim=-1).indices
    o = torch.gather(torch.as_tensor(oracle_rows), -1, top2)
    p = torch.gather(torch.as_tensor(plain_rows), -1, top2)
    return ((p[:, 0] - p[:, 1]) - (o[:, 0] - o[:, 1])).abs().cpu().numpy()


def near_tie_rule(oracle_rows, plain_rows, gaps, spread: float,
                  int8: bool):
    """The near-tie rule, a pure function: (tau, None) when a first
    difference whose logit gaps ``gaps`` = (the oracle's own, a plain
    prefill's, the engine's; each the engine token's logit less the
    oracle token's) is a near-tie, else (tau, the reason).  ``gaps=None``
    only gives tau.  ``oracle_rows`` and ``plain_rows`` [N, V] are the
    oracle's and a plain prefill's logits at ``noise_spread``'s positions,
    measured before the engine runs; ``spread`` is the most a plain
    prefill drifts from the oracle there.  Over bf16 KV, tau is 0.08
    (bf16 rounding).  Over int8 KV, where each value carries up to half an
    int8 step of its own (docs/EXACTNESS.md:93-96), tau is the larger of
    0.08 and the largest change a plain prefill makes to the oracle's
    top-2 gap at those positions.  A near-tie needs |oracle gap| <= tau
    and neither the plain prefill nor the engine moving that gap by more
    than ``spread``."""
    tau = NEAR_TIE
    if int8:
        tau = max(NEAR_TIE, float(top2_gap_changes(oracle_rows,
                                                   plain_rows).max()))
    if gaps is None:
        return tau, None
    gap, plain, eng = gaps
    if abs(gap) > tau:
        return tau, f"|oracle gap| > tau {tau:.5f}"
    if abs(plain - gap) > spread:
        return tau, "the plain prefill moves the gap by more than the bound"
    if abs(eng - gap) > spread:
        return tau, "the engine's logits move the gap by more than the bound"
    return tau, None


def noise_spread(cfg, params, cases, per_case: int = 32, *,
                 int8: bool = False) -> SimpleNamespace:
    """One plain prefill's logits beside the oracle's own at ``per_case``
    positions of each ``(output ids, prompt length, oracle rows)``: how
    far two correct computations of one next-token distribution move its
    gaps.  Returns the rows (``oracle``, ``plain``), their ``drifts``, the
    bound ``spread`` (their maximum) and the near-tie rule's ``tau``
    (``near_tie_rule``; ``int8``: the path's KV is int8)."""
    import torch

    plain, ref = [], []
    for ids, plen, rows in cases:
        for g in np.linspace(1, len(rows) - 1, per_case).astype(int):
            plain.append(plain_next_logits(cfg, params, ids[:plen + g]))
            ref.append(rows[g - 1])
    plain, ref = torch.stack(plain), torch.stack(ref)
    drifts = drift(plain, ref)
    return SimpleNamespace(
        oracle=ref, plain=plain, drifts=drifts, spread=float(drifts.max()),
        tau=near_tie_rule(ref, plain, None, 0.0, int8)[0], int8=int8,
        changes=top2_gap_changes(ref, plain))


def noise_line(noise) -> str:
    """The bound's numbers for a log line."""
    ch = noise.changes
    return (f"a plain prefill drifts from the oracle's own logits "
            f"{np.median(noise.drifts):.5f} median, {noise.spread:.5f} max "
            f"over {len(noise.drifts)} positions (the drift bound); it "
            f"changes the oracle's top-2 gap {np.median(ch):.5f} median, "
            f"{np.quantile(ch, 0.9):.5f} 90th percentile, {ch.max():.5f} "
            f"max: tau {noise.tau:.5f} ("
            + ("int8 KV" if noise.int8 else "bf16 KV: 0.08") + ")")


def emitted_rows(prompt, out, chains, upto):
    """For the engine's generated tokens 1 .. ``upto`` - 1: (generated
    index, step of the row that chose it, that row's place on the step's
    accepted path, whether a tree draft came at or before that step: from
    then on the cache holds keys and values that tree rows computed, so
    the bits may differ from the oracle's).  Path token
    q >= 1 of a step comes from path node q - 1's row; the step's first
    token is the previous step's bonus, from its last path node's row."""
    lens, out_rows, cum = out.accept_length_per_step, [], 0
    for s, n in enumerate(lens):
        for q in range(n):
            g = cum + q
            if 1 <= g < upto:
                step, k = (s, q - 1) if q else (s - 1, lens[s - 1] - 1)
                out_rows.append((g, step, k, not all(chains[:step + 1])))
        cum += n
    return out_rows


def judge(prompt, out, ref, chains, ref_rows, cfg, params, noise,
          path_rows):
    """(verdict, None) when the engine's run ``out`` agrees with the
    oracle's ``ref`` by the near-tie rule, else (None, the reason).  The
    engine's own logits for every token it emits (``path_rows``, the
    accepted path's rows per step) are held to the oracle's (``ref_rows``,
    one [V] row per step): on chain drafts bitwise equal; on tree drafts
    (tree rows attend their ancestors at other columns, so their bits may
    differ from the chain oracle's: docs/EXACTNESS.md) within
    ``noise.spread``, the most a plain prefill drifts from the oracle
    (``noise_spread``).  Where the tokens first differ, a tree draft must
    have verified that token or an earlier one and, with a = the engine's
    token and b = the oracle's, the gaps row[a] - row[b] in the oracle's
    own logits, a plain prefill's over the shared prefix and the engine's
    must pass ``near_tie_rule`` (tau and the verdict printed)."""
    import torch

    spread = noise.spread
    a, b = out.output_ids, ref.output_ids
    j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None and len(a) != len(b):
        return None, "output lengths differ"
    P = len(prompt)
    upto = (len(a) if j is None else j + 1) - P
    emitted = emitted_rows(prompt, out, chains, min(upto, len(ref_rows) + 1))
    for g, step, k, _ in emitted:
        if int(path_rows[step][k].argmax()) != a[P + g]:
            return None, (f"the recorded engine row for token {P + g} does "
                          "not choose the engine's token")
    tree = [(g, st, k) for g, st, k, t in emitted if t]
    chain = [(g, st, k) for g, st, k, t in emitted if not t]
    for g, st, k in chain:
        if not torch.equal(path_rows[st][k], ref_rows[g - 1]):
            return None, (f"the engine's logits for token {P + g}, after "
                          "chain drafts only, differ from the oracle's")
    drifts = (drift(torch.stack([path_rows[st][k] for _, st, k in tree]),
                    torch.stack([ref_rows[g - 1] for g, _, _ in tree]))
              if tree else np.zeros(0))
    tally = (f"{len(chain)} tokens after chain drafts only with logits "
             f"bitwise equal to the oracle's, {len(tree)} after a tree "
             f"draft drifting "
             + (f"{np.median(drifts):.5f} median, "
                f"{np.quantile(drifts, 0.9):.5f} 90th percentile, "
                f"{drifts.max():.5f} max" if tree else "-")
             + f" (bound {spread:.5f})")
    if tree and drifts.max() > spread:
        g = tree[int(drifts.argmax())][0]
        return None, (f"{tally}: the engine's logits for token {P + g} "
                      "drift beyond the bound")
    if j is None:
        return f"equal; {tally}", None
    g = j - P
    cause = next((st for gg, st, _, _ in emitted if gg == g), -1)
    if cause < 0 or all(chains[:cause + 1]):
        return None, (f"tokens differ from the oracle at {j} after chain "
                      f"drafts only (step {cause})")
    row = ref_rows[g - 1]              # the oracle's step that emitted b[j]
    if int(row.argmax()) != b[j]:
        return None, "the recorded oracle row does not choose its token"
    erow = next(path_rows[st][k] for gg, st, k, _ in emitted if gg == g)
    gap = float(row[a[j]] - row[b[j]])
    lg = plain_next_logits(cfg, params, a[:j])
    plain = float(lg[a[j]] - lg[b[j]])
    eng = float(erow[a[j]] - erow[b[j]])
    facts = (f"token {j} (engine {a[j]}, oracle {b[j]}): logit gap "
             f"{gap:.5f} in the oracle's own logits, {plain:.5f} by a plain "
             f"prefill over the shared prefix, {eng:.5f} in the engine's "
             f"own; {tally}")
    tau, why = near_tie_rule(noise.oracle, noise.plain, (gap, plain, eng),
                             spread, noise.int8)
    if why is not None:
        return None, f"not a near-tie (tau {tau:.5f}) at {facts}: {why}"
    return (f"near-tie (tau {tau:.5f}) at {facts}; first tree draft at "
            f"step {chains.index(False)}, the token's verify step "
            f"{cause}"), None


def oracle_verdict(label, *args) -> str:
    """``judge``'s verdict; any other outcome fails the run."""
    verdict, reason = judge(*args)
    fail_if(verdict is None, f"{label}: {reason}")
    return verdict


def branching_copy(ids, prompt_len, rng, every=8):
    """``ids`` with every ``every``-th generated token replaced by a random
    one: beside the original in a corpus, the SAM's frequency tree branches
    at each such position."""
    out = list(ids)
    for i in range(prompt_len + every - 1, len(out), every):
        out[i] = int(rng.integers(3, 1000))
    return out


def by_source(stats) -> str:
    return ", ".join(f"{k} {stats.accept_by_source[k] / n:.3f} over {n} "
                     f"steps" for k, n in sorted(stats.source_counts.items()))


def planted_fault(kind: str):
    """A broken ``unpack_draft`` for the judge to catch: ``causal``, tree
    rows attend every earlier column of the block (a chain's mask);
    ``skip_parent``, rows at depth >= 2 do not attend their parent;
    ``chain_positions``, nodes take their column as position, not their
    depth."""
    import torch

    import samd_tpu_torch.engine as engine

    real = engine.unpack_draft

    def broken(draft, D):
        tokens, mask, depths, paths = real(draft, D)
        if kind == "causal":
            mask = torch.tril(torch.ones_like(mask))
        elif kind == "skip_parent":
            mask = mask.clone()
            for i, d in enumerate(depths.tolist()):
                if d >= 2 and int(paths[i, d - 1]) != i:     # not padding
                    mask[i, paths[i, d - 1]] = False
        else:
            depths = torch.arange(len(depths), dtype=depths.dtype)
        return tokens, mask, depths, paths
    return broken


PLANTED_FAULTS = ("causal", "skip_parent", "chain_positions")


def main_path_7b_host(card: str, cfg, params) -> dict:
    """Phase 9: llama_7b int4 + int8 KV through the host-automaton
    SamdEngine at M = 60."""
    import tempfile

    import torch

    import samd_tpu_torch.engine as engine
    from samd_tpu_torch.config import GenerationConfig, SamdConfig
    from samd_tpu_torch.drafters import make_drafter
    from samd_tpu_torch.engine import ArBaseline, SamdEngine, StepStats
    from samd_tpu_torch.sam import SamCursor, load_sam, save_sam, to_arrays
    from samd_tpu_torch.sam.native import build_native_corpus_sam

    cfg = dataclasses.replace(cfg, kv_quant=True)
    S, M, V = 1024, 60, cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=64, max_cache_len=S)
    kw = dict(max_cache_len=S, eos_token_id=-1)
    rng = np.random.default_rng(9)
    prompts = {"a_random": rng.integers(3, V, size=100).tolist(),
               "b_repetitive": rng.integers(3, V, size=8).tolist() * 12,
               "c_random_200": rng.integers(3, V, size=200).tolist()}
    prompts["a_repeat"] = prompts["a_random"]
    oracle = ArBaseline(cfg, params, block_size=M, **kw)
    oracle.generate(prompts["b_repetitive"][:16],
                    GenerationConfig(max_new_tokens=4))        # warm-up
    refs, ref_rows = {}, {}
    for n, p in prompts.items():
        if n != "a_repeat":
            with AcceptRows("oracle") as rows:
                refs[n] = oracle.generate(p, gen)
            ref_rows[n] = rows.steps
    refs["a_repeat"], ref_rows["a_repeat"] = refs["a_random"], \
        ref_rows["a_random"]
    noise = noise_spread(cfg, params, [
        (refs[n].output_ids, len(prompts[n]), ref_rows[n])
        for n in ("a_random", "c_random_200")], int8=True)
    print(f"llama_7b host: {noise_line(noise)}; drifts are ranges of the "
          f"difference over the oracle's top {TOP_SPREAD} tokens [{card}]",
          flush=True)
    hy_cfg = SamdConfig(draft_source="sam_hybrid", max_predicts=M)
    # the path request a leaves in a Token-Recycle cache that served it
    a_path = [(refs["a_random"].output_ids[len(prompts["a_random"]):],
               ref_rows["a_random"])]

    def hybrid():
        drafter = make_drafter(hy_cfg, V)
        warm_token_recycle(drafter.tree_drafter, V, np.random.default_rng(17),
                           a_path)
        log = DraftLog(drafter)
        return SamdEngine(cfg, params, hy_cfg, log, **kw), log

    # (b)'s corpus: random tokens, requests a's and c's oracle outputs and
    # a copy of a's that differs at every 8th generated token (so the
    # frequency trees branch), built by the native engine, saved and
    # loaded back as the Python automaton
    native = build_native_corpus_sam(
        [rng.integers(3, V, size=20000).tolist(),
         refs["a_random"].output_ids, refs["c_random_200"].output_ids,
         branching_copy(refs["a_random"].output_ids, 100, rng)],
        eos_token=0, topk=8)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.npz"
        save_sam(native, path)
        static = load_sam(path, topk=8)
    want = native.to_arrays()
    for k, v in to_arrays(static).items():
        fail_if(not np.array_equal(v, want[k]),
                f"llama_7b host: the reloaded SAM's {k} differs")
    so_cfg = SamdConfig(draft_source="sam_only", max_predicts=M)

    def sam_only():
        log = DraftLog(make_drafter(so_cfg, V, static_sam=SamCursor(static)))
        return SamdEngine(cfg, params, so_cfg, log, **kw), log

    eng_a, log_a = hybrid()
    eng_b, log_b = sam_only()
    eng_a.generate(prompts["b_repetitive"][:16],
                   GenerationConfig(max_new_tokens=8))          # warm-up
    torch.cuda.synchronize()
    # (a): every token of the warm cache has a harvest, so every draft is
    # a full 60-node tree; a's trees follow its path, c's are random, and
    # a again finds the harvest of its own first run; (b): a through
    # branching frequency trees, c through its corpus copy
    runs = [("a hybrid token_recycle", eng_a, log_a, n)
            for n in ("a_random", "c_random_200", "a_repeat")] + [
        ("b sam_only static", eng_b, log_b, n)
        for n in ("a_random", "c_random_200")]
    done = []
    reset_counts()                              # the path starts here
    for label, eng, log, name in runs:
        eng.stats = StepStats()
        with AcceptRows("path") as rows:
            t0 = time.perf_counter()
            out = eng.generate(prompts[name], gen)
            torch.cuda.synchronize()
        done.append((label, name, out, time.perf_counter() - t0,
                     list(log.chains), list(log.nodes), eng.stats,
                     rows.steps))
    counts = read_counts()                      # the path ends here
    equal = 0
    for label, name, out, dt, chains, nodes, stats, rows in done:
        tag = f"llama_7b host {label} request {name}"
        verdict = oracle_verdict(tag, prompts[name], out, refs[name], chains,
                                 ref_rows[name], cfg, params, noise, rows)
        equal += verdict.startswith("equal")
        new = len(out.output_ids) - len(prompts[name])
        print(f"{tag}: prompt {len(prompts[name])} new {new} steps "
              f"{out.decode_steps} ({chains.count(False)} tree drafts; "
              f"draft nodes per step {run_lengths(nodes)}) "
              f"ms_per_step {dt / out.decode_steps * 1e3:.3f} tok_per_s "
              f"{new / dt:.2f} (prefill included) "
              f"mean accept by source: {by_source(stats)}; against "
              f"ArBaseline(block_size=60): {verdict} [{card}]", flush=True)
    note("phase9_llama_7b_host", equal_to_oracle=f"{equal}/{len(done)}",
         **run_numbers([(len(d[2].output_ids) - len(prompts[d[1]]),
                         d[2].decode_steps, d[3]) for d in done]))
    forwards = sum(1 + d[2].decode_steps for d in done)
    short = sum(d[2].decode_steps + (len(prompts[d[1]]) <= 128)
                for d in done)
    want = {"flash_block_attention": 0,
            "flash_block_attention_int8kv": cfg.num_layers * short,
            "int4_matmul": (7 * cfg.num_layers + 1) * forwards,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want or not counts["int4_matmul"],
            f"llama_7b host: launch counts {counts}, expected {want}")
    print(f"llama_7b host path: {equal} of {len(done)} requests bitwise "
          f"equal to the oracle, the rest near-ties; int4_matmul launches "
          f"{counts['int4_matmul']} = 225 x {forwards} forwards; int8-KV "
          f"verify launches {counts['flash_block_attention_int8kv']} = 32 x "
          f"{short} forwards of T <= 128 [{card}]", flush=True)
    del done
    gc.collect()

    # planted faults in the tree buffers, each of which the judge must
    # reject, on request a with the warm cache of (a)
    for kind in PLANTED_FAULTS:
        eng, log = hybrid()
        real = engine.unpack_draft
        engine.unpack_draft = planted_fault(kind)
        try:
            with AcceptRows("path") as rows:
                bad = eng.generate(prompts["a_random"], gen)
        finally:
            engine.unpack_draft = real
        verdict, reason = judge(prompts["a_random"], bad, refs["a_random"],
                                log.chains, ref_rows["a_random"], cfg,
                                params, noise, rows.steps)
        fail_if(verdict is not None, f"llama_7b host planted fault {kind}: "
                f"the judge let it pass ({verdict})")
        print(f"llama_7b host planted fault {kind}: {bad.decode_steps} "
              f"steps, rejected: {reason} [{card}]", flush=True)
        del eng, rows

    # (c) sampled: each tree accept mode twice with its seed; point-mass
    # requests equal the same engine's greedy run
    p = prompts["b_repetitive"]
    short_gen = dict(max_new_tokens=64, max_cache_len=S)
    for mode, knobs in (("rejection", dict(top_k=50)), ("typical", {}),
                        ("nucleus", dict(top_p=0.9))):
        g = GenerationConfig(greedy=False, temperature=0.8, seed=11,
                             accept_mode=mode, **knobs, **short_gen)
        t0 = time.perf_counter()
        one, two = eng_b.generate(p, g), eng_b.generate(p, g)
        dt = time.perf_counter() - t0
        fail_if(one.output_ids != two.output_ids,
                f"llama_7b host sampled {mode}: two runs with one seed "
                "differ")
        fail_if(not all(0 <= t < V for t in one.output_ids)
                or len(one.output_ids) != len(p) + 64,
                f"llama_7b host sampled {mode}: malformed output")
        print(f"llama_7b host sampled {mode}: two runs with seed 11 equal; "
              f"{one.decode_steps} steps, mean accept "
              f"{one.decode_tokens / one.decode_steps:.3f}, "
              f"{2 * 64 / dt:.2f} tok/s [{card}]", flush=True)
    point = GenerationConfig(greedy=False, temperature=1e-5, top_k=1, seed=5,
                             **short_gen)
    for label, make in (("hybrid token_recycle", hybrid),
                        ("sam_only static", sam_only)):
        name = "a_random"
        g_eng, g_log = make()
        with AcceptRows("path") as rows:
            greedy_out = g_eng.generate(prompts[name],
                                        GenerationConfig(**short_gen))
        forced = make()[0].generate(prompts[name], point)
        fail_if(forced.output_ids != greedy_out.output_ids,
                f"llama_7b host point-mass {label}: differs from the same "
                "engine's greedy run")
        ref = refs[name].output_ids[:len(prompts[name]) + 64]
        verdict = oracle_verdict(
            f"llama_7b host point-mass {label}", prompts[name], greedy_out,
            SimpleNamespace(output_ids=ref), g_log.chains, ref_rows[name],
            cfg, params, noise, rows.steps)
        print(f"llama_7b host point-mass {label} (top_k 1, temperature "
              f"1e-5): equal to the same engine's greedy run; against the "
              f"oracle: {verdict} [{card}]", flush=True)
    return counts


def main_path_1b_host(card: str) -> dict:
    """Phase 10: llama_1b bf16 through the batched host engines (dense and
    paged, B = 4, M = 60), request interleaving, and the server's
    ``--engine batched --sam``."""
    import tempfile

    import torch

    from samd_tpu_torch.batching import (BatchedSamdEngine,
                                         PagedBatchedSamdEngine)
    from samd_tpu_torch.config import GenerationConfig, SamdConfig
    from samd_tpu_torch.drafters import AdaptiveSelector, make_drafter
    from samd_tpu_torch.engine import SamdEngine, _SingleTokenDrafter
    from samd_tpu_torch.interleave import InterleavedSamdEngine
    from samd_tpu_torch.models import init_params, llama_1b
    from samd_tpu_torch.sam import SamCursor, save_sam
    from samd_tpu_torch.sam.native import build_native_corpus_sam
    from samd_tpu_torch.server import build_server_engine, serve

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    S, M, V, L = 1024, 60, cfg.vocab_size, cfg.num_layers
    kw = dict(batch_size=4, max_cache_len=S, eos_token_id=-1,
              prefill_buckets=(128, 256))
    rng = np.random.default_rng(13)
    fresh = [(rng.integers(3, V, size=int(n)).tolist(), 64)
             for n in rng.integers(40, 101, size=4)]
    requests = fresh + fresh[:2]
    makers = {
        "dense": lambda f: BatchedSamdEngine(cfg, params, SamdConfig(
            max_predicts=M), f, **kw),
        "paged": lambda f: PagedBatchedSamdEngine(cfg, params, SamdConfig(
            max_predicts=M), f, n_pages=16, page_size=128, **kw)}
    counted = {}
    static = None
    for kind, make in makers.items():
        with AcceptRows("oracle") as rows:
            ar = make(lambda: _SingleTokenDrafter(M))
            per_rid = batched_rows(ar, rows)
            oracle, _, _ = serve_batched(ar, requests, V)
        del ar
        oracle_rows = [per_rid[i] for i in range(len(requests))]
        noise = noise_spread(cfg, params, [
            (o.output_ids, len(p), rr) for (p, _), o, rr in
            zip(requests[:2], oracle[:2], oracle_rows[:2])])
        print(f"llama_1b host {kind}: {noise_line(noise)} [{card}]",
              flush=True)
        if static is None:
            # the first two requests' outputs and copies of them that differ
            # at every 8th generated token: frequency trees that branch
            static = build_native_corpus_sam(
                [o.output_ids for o in oracle[:2]]
                + [branching_copy(o.output_ids, len(p), rng)
                   for (p, _), o in zip(requests, oracle[:2])],
                eos_token=0, topk=8)
        for source in ("sam_only", "sam_hybrid"):
            scfg = SamdConfig(draft_source=source, max_predicts=M)
            # one Token-Recycle cache shared by every request (its reset is
            # a no-op), warm: full 60-node trees, along each request's path
            # where it has not left the oracle's
            shared = make_drafter(scfg, V).tree_drafter
            if shared is not None:
                warm_token_recycle(
                    shared, V, np.random.default_rng(17),
                    [(o.output_ids[len(p):], rr) for (p, _), o, rr in
                     zip(requests, oracle, oracle_rows)])
            logs = []

            def factory():
                logs.append(DraftLog(AdaptiveSelector(
                    scfg, static_sam=SamCursor(static),
                    tree_drafter=shared)))
                return logs[-1]
            eng = make(factory)
            logs.clear()                    # the engine's probe
            torch.cuda.synchronize()
            with AcceptRows("path") as prow:
                eng_rows = batched_rows(eng, prow)
                reset_counts()              # the path starts here
                outs, wall, steps = serve_batched(eng, requests, V)
                counts = read_counts()      # the path ends here
            label = f"llama_1b host {kind} B=4 {source}"
            verdicts = [oracle_verdict(f"{label} request {i}", p, o, r,
                                       lg.chains, rr, cfg, params, noise,
                                       eng_rows[i])
                        for i, ((p, _), o, r, lg, rr) in enumerate(
                            zip(requests, outs, oracle, logs, oracle_rows))]
            del prow, eng_rows
            n_equal = sum(v.startswith("equal") for v in verdicts)
            new = sum(o.decode_tokens for o in outs)
            trees = sum(lg.chains.count(False) for lg in logs)
            nodes = sorted((n for lg in logs for n in lg.nodes),
                           reverse=True)
            print(f"{label}: {len(outs)} requests, {new} new tokens, "
                  f"{trees} tree drafts (draft nodes over all slot-steps, "
                  f"sorted: {run_lengths(nodes)}), "
                  f"{steps} steps of [4, 60], {wall / steps * 1e3:.3f} "
                  f"ms/step, {new / wall:.2f} tok/s (prefills included), "
                  f"mean accept by source: {by_source(eng.stats)}; against "
                  f"the single-token-drafter oracle: "
                  f"{n_equal} equal, {len(verdicts) - n_equal} near-ties "
                  f"[{card}]", flush=True)
            for i, v in enumerate(verdicts):
                print(f"{label} request {i}: {v} [{card}]", flush=True)
            note(f"phase10_llama_1b_host_{kind}_b4_{source}",
                 tokens_per_s=new / wall, ms_per_step=wall / steps * 1e3,
                 mean_accept=new / sum(o.decode_steps for o in outs),
                 equal_to_oracle=f"{n_equal}/{len(verdicts)}")
            want = {"flash_block_attention": L * len(requests),
                    "flash_block_attention_int8kv": 0, "int4_matmul": 0,
                    "paged_block_attention": L * steps if kind == "paged"
                    else 0, "paged_block_attention_int8kv": 0}
            fail_if(counts != want or not steps,
                    f"{label}: launch counts {counts}, expected {want}")
            if kind == "paged":
                fail_if(len(eng.pool._free) != 16,
                        f"{label}: pages not returned")
                note(f"phase10_llama_1b_host_{kind}_b4_{source}",
                     peak_pages=eng.peak_pages)
                counted[source] = counts["paged_block_attention"]
            del eng
            gc.collect()
    print(f"llama_1b host paged: K4 bf16 launches {counted} = 22 per step "
          f"[{card}]", flush=True)

    # interleaving: three lanes against three sequential runs
    so_cfg = SamdConfig(draft_source="sam_only", max_predicts=M)

    def so_drafter():
        return make_drafter(so_cfg, V, static_sam=SamCursor(static))
    gen = GenerationConfig(max_new_tokens=64, max_cache_len=S)
    three = [p for p, _ in requests[:3]]
    single = SamdEngine(cfg, params, so_cfg, so_drafter(), max_cache_len=S,
                        eos_token_id=-1)
    t0 = time.perf_counter()
    seq = [single.generate(p, gen) for p in three]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    inter = InterleavedSamdEngine(cfg, params, so_cfg, so_drafter, lanes=3,
                                  max_cache_len=S, eos_token_id=-1)
    torch.cuda.synchronize()
    reset_counts()                              # the path starts here
    t0 = time.perf_counter()
    rids = [inter.add_request(p, gen) for p in three]
    res = inter.run()
    torch.cuda.synchronize()
    t_inter = time.perf_counter() - t0
    counts = read_counts()                      # the path ends here
    fail_if([res[r] for r in rids] != seq,
            "llama_1b interleaved: outputs differ from sequential runs")
    forwards = sum(1 + o.decode_steps for o in seq)
    fail_if(counts["flash_block_attention"] != L * forwards,
            f"llama_1b interleaved: launch counts {counts}, expected "
            f"{L} x {forwards} verify launches")
    print(f"llama_1b interleaved, 3 lanes: bitwise equal to 3 sequential "
          f"SamdEngine runs; {t_inter:.3f} s against {t_seq:.3f} s "
          f"sequential; verify launches {counts['flash_block_attention']} "
          f"= 22 x {forwards} forwards [{card}]", flush=True)
    del inter, single
    gc.collect()

    # the server: --engine batched --sam FILE over 127.0.0.1
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.npz"
        save_sam(static, path)
        args = SimpleNamespace(model=None, random_model=True, tiny=False,
                               engine="batched", batch_size=4, quantize=None,
                               max_cache_len=S, sam=path, cpu=False,
                               inline_prefill=False)
        eng = build_server_engine(args)
    fail_if(type(eng) is not BatchedSamdEngine,
            f"server: --engine batched built {type(eng).__name__}")
    four = [p for p, _ in requests[:4]]
    direct, _, _ = serve_batched(eng, [(p, 32) for p in four], V)
    server, sched = serve(eng, port=0, block=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        reset_counts()                          # the path starts here
        replies = http_traffic(url, [{"input_ids": p, "max_new_tokens": 32}
                                     for p in four], "batched --sam")
        counts = read_counts()                  # the path ends here
    finally:
        server.shutdown()
        sched.close()
    fail_if([r["output_ids"] for r in replies]
            != [o.output_ids for o in direct],
            "server --engine batched --sam: replies differ from the engine "
            "called directly")
    fail_if(counts["flash_block_attention"] != L * len(four),
            f"server --engine batched: launch counts {counts}")
    print(f"server --engine batched --sam: 4 greedy replies over HTTP equal "
          f"to the engine called directly (static drafts "
          f"{eng.stats.source_counts.get('sam_static', 0)} of "
          f"{sum(eng.stats.source_counts.values())} slot-steps); verify "
          f"launches {counts['flash_block_attention']} = 22 x 4 prefills "
          f"[{card}]", flush=True)
    return counted


class FusedSteps:
    """Records, per request, what a fused tree engine verified at each of
    its steps: whether the draft was a retrieval chain, the committed
    length, and the accepted path's logits rows ``[length, V]`` (their
    argmaxes are the tokens the step emits).  Patches the engine module's
    ``forward`` and ``greedy_accept`` while active, and wraps the
    engine's ``_step`` (and the hybrid's ``_hybrid_draft``).  Batched
    engines are keyed by request id, a single stream by its calls in
    order (``next_request``)."""

    def __init__(self, engine, module):
        self.engine, self.mod = engine, module
        self.per_rid = {}
        self.rid = -1
        self.logits = self.res = self.use_sam = None

    def next_request(self) -> None:
        self.rid += 1

    def _rec(self, rid):
        return self.per_rid.setdefault(rid, dict(rows=[], chains=[],
                                                 alens=[]))

    def __enter__(self):
        import torch

        mod, eng = self.mod, self.engine
        eng.segmented = False           # the recorder reads every step
        self._saved = (mod.forward, mod.greedy_accept, eng._step)
        fwd, acc, step = self._saved

        def forward(*a, **k):
            out = fwd(*a, **k)
            self.logits = out[0]
            return out

        def greedy(*a):
            self.res = acc(*a)
            return self.res
        mod.forward, mod.greedy_accept = forward, greedy
        if hasattr(eng, "_hybrid_draft"):
            draft = eng._hybrid_draft

            def hybrid_draft(*a):
                out = draft(*a)
                self.use_sam = out[0]
                return out
            eng._hybrid_draft = hybrid_draft

        def keep(rid, b, alen, chain):
            r = self._rec(rid)
            nodes = self.res.path_nodes
            nodes = nodes[b] if nodes.dim() == 2 else nodes
            r["rows"].append(self.logits[b][nodes[:alen].long()].float())
            r["chains"].append(chain)
            r["alens"].append(alen)

        if hasattr(eng, "B"):
            def batched_step(hist_lens, starts, budgets, lives, *rest):
                live = lives.cpu().numpy()
                rids = list(eng._slot_req)
                out = step(hist_lens, starts, budgets, lives, *rest)
                alens = (out[0] - hist_lens).cpu().numpy()
                use = self.use_sam.cpu().numpy()
                for b in np.nonzero(live)[0]:
                    keep(rids[b], b, int(alens[b]), bool(use[b]))
                return out
            eng._step = batched_step
        else:
            def single_step(*a, **k):
                out = step(*a, **k)
                alen = int(self.res.accept_len)
                chain = (self.use_sam is not None
                         and bool(self.use_sam.reshape(-1)[0]))
                keep(self.rid, 0, alen, chain)
                return out
            eng._step = single_step
        self._torch = torch
        return self

    def __exit__(self, *exc):
        self.mod.forward, self.mod.greedy_accept = self._saved[:2]
        for name in ("_step", "_hybrid_draft", "segmented"):
            self.engine.__dict__.pop(name, None)

    def outputs(self, rid, out):
        """``out`` with its per-step committed lengths, for ``judge``."""
        return SimpleNamespace(output_ids=out.output_ids,
                               accept_length_per_step=self._rec(rid)["alens"])


class ChainOracleRows:
    """While active, the logits row 0 of every live slot at each step of a
    batched chain engine run as its ``alpha = 0`` oracle (one real token a
    step), per request id in order: the rows ``judge`` holds a batched
    engine to."""

    def __init__(self, engine):
        self.engine = engine
        self.per_rid = {}

    def __enter__(self):
        import samd_tpu_torch.fused_sam as fs

        eng, self._fwd, step = self.engine, fs.forward, self.engine._step
        eng.segmented = False           # the recorder reads every step
        last = {}

        def forward(*a, **k):
            out = self._fwd(*a, **k)
            last["logits"] = out[0]
            return out
        fs.forward = forward

        def oracle_step(hist_lens, starts, budgets, lives, *rest):
            live = lives.cpu().numpy()
            rids = list(eng._slot_req)
            out = step(hist_lens, starts, budgets, lives, *rest)
            for b in np.nonzero(live)[0]:
                self.per_rid.setdefault(rids[b], []).append(
                    last["logits"][b, 0].float())
            return out
        eng._step = oracle_step
        return self

    def __exit__(self, *exc):
        import samd_tpu_torch.fused_sam as fs

        fs.forward = self._fwd
        for name in ("_step", "segmented"):
            self.engine.__dict__.pop(name, None)


def warm_harvest(engine, rng, trajectories=()) -> None:
    """Fill a fused tree engine's harvest tables as a long-served engine
    holds them (``tools.profile_step.warm_harvest``: every token seen, a
    seeded random top-8, so every tree has its full node count), and along
    each ``(slot, tokens, oracle rows)`` trajectory the oracle's own top-8
    after each token."""
    import torch

    from samd_tpu_torch.engine import harvest_topk
    from samd_tpu_torch.fused_base import harvest_update
    from samd_tpu_torch.tools.profile_step import warm_harvest as warm

    harvests, seens = engine.harvests, engine.seens
    K = harvests.shape[2]
    warm(harvests, seens, rng)
    for slot, tokens, rows in trajectories:
        n = len(rows)
        harvest_update(harvests[slot:slot + 1], seens[slot:slot + 1],
                       torch.tensor(tokens[:n], device=harvests.device)[None],
                       harvest_topk(torch.stack(rows), K)[None])


def check_paged_compaction(card: str) -> None:
    """``paged_kv.paged_compact_block`` on the card over one side of phase
    11b's int8 pool (32 layers, 64 pages of 128 rows, KH 32, D 128) at B =
    12, M = 24: shuffled tables, blocks across page boundaries, paths of
    depth 10, two slots without pages (their rows on the scratch page).
    Every page must equal a row-by-row copy of each slot's path, values
    and scales bitwise, and pages outside every table stay untouched."""
    import torch

    from samd_tpu_torch.paged_kv import PagedKV, paged_compact_block

    L, KH, D, page, n = 32, 32, 128, 128, 64
    B, M, A, P = 12, 24, 10, 8
    rng = np.random.default_rng(41)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    pool = torch.randint(-127, 128, (L, n + 1, KH, page, D), generator=gen,
                         device="cuda", dtype=torch.int8)
    scale = torch.rand((L, n + 1, KH, page), generator=gen, device="cuda")
    perm = rng.permutation(n)
    tables = np.full((B, P), -1, np.int32)
    for b in range(10):                       # slots 10 and 11 hold none
        tables[b, :6] = perm[6 * b:6 * b + 6]
    offsets = rng.integers(0, 6 * page - M, size=B).astype(np.int32)
    offsets[:3] = (1, 2, 3) * np.array([page]) - 5   # across a boundary
    paths = np.stack([np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, M), A - 1, replace=False))]) for _ in range(B)])
    want_pool, want_scale = pool.clone(), scale.clone()
    for b in range(10):
        def at(pos):
            return int(tables[b, pos // page]), pos % page
        rows = [at(int(offsets[b] + paths[b, i])) for i in range(A)]
        vals = [(want_pool[:, pg, :, sl].clone(),
                 want_scale[:, pg, :, sl].clone()) for pg, sl in rows]
        for i, (v, sc) in enumerate(vals):
            pg, sl = at(int(offsets[b]) + i)
            want_pool[:, pg, :, sl] = v
            want_scale[:, pg, :, sl] = sc
    got = PagedKV(pool, scale)
    paged_compact_block(got, torch.from_numpy(tables).cuda(),
                        torch.from_numpy(offsets).cuda(),
                        torch.from_numpy(paths.astype(np.int32)).cuda(), M,
                        n)
    torch.cuda.synchronize()
    fail_if(not (torch.equal(got.pool[:, :n], want_pool[:, :n])
                 and torch.equal(got.scale[:, :n], want_scale[:, :n])),
            "paged_compact_block: int8 pages differ from a row-by-row copy")
    print(f"paged_compact_block over int8 pages (B 12, M 24, paths of depth "
          f"{A}, 10 slots with pages and 2 on the scratch page): every page "
          f"bitwise equal to a row-by-row copy, values and scales [{card}]",
          flush=True)
    del pool, scale, want_pool, want_scale, got
    torch.cuda.empty_cache()


def deep_tree_steps(card, label, rec) -> None:
    """Fails unless some live slot-step of ``rec`` (``FusedSteps``)
    accepted a tree path past the root's child (a committed length of 3 or
    more after a tree draft): otherwise the judge saw no real tree path."""
    alens = [a for r in rec.per_rid.values()
             for c, a in zip(r["chains"], r["alens"]) if not c]
    deep = sum(a >= 3 for a in alens)
    print(f"{label}: {deep} of {len(alens)} tree slot-steps accepted a path "
          f"of depth >= 2, longest {max(alens, default=0)} [{card}]",
          flush=True)
    fail_if(not deep, f"{label}: no tree draft accepted a path of depth "
            ">= 2")


def judge_all(card, label, cases, cfg, params, noise, key: str) -> list:
    """``oracle_verdict`` of every (name, prompt, engine outputs, oracle
    outputs, chains, oracle rows, engine path rows); prints each verdict,
    records how many are equal as ``key_equal_to_oracle`` and returns
    them."""
    verdicts = []
    for name, p, out, ref, chains, ref_rows, rows in cases:
        v = oracle_verdict(f"{label} request {name}", p, out, ref, chains,
                           ref_rows, cfg, params, noise, rows)
        print(f"{label} request {name}: {v}; {chains.count(True)} chain and "
              f"{chains.count(False)} tree drafts [{card}]", flush=True)
        verdicts.append(v)
    n_equal = sum(v.startswith("equal") for v in verdicts)
    note(key, equal_to_oracle=f"{n_equal}/{len(verdicts)}")
    return verdicts


def main_path_7b_hybrid(card: str, cfg, params) -> tuple:
    """Phase 11: llama_7b int4 through the fused SAM[Token Recycle] hybrid:
    (a) FusedHybridEngine over int8 KV, (c) sampled requests; (b) is
    ``main_path_7b_paged_hybrid``.  Returns (a)'s prompts, oracle outputs,
    oracle rows and bound for phase 13a."""
    import torch

    import samd_tpu_torch.fused_hybrid as fh
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_hybrid import (FusedHybridConfig,
                                             FusedHybridEngine)

    L, V = cfg.num_layers, cfg.vocab_size
    # (a) one stream, int8 KV, the default hybrid (M 64, tree 61, chains 40)
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    hc = FusedHybridConfig(corpus_capacity=4096,
                           cache_buckets=(256, 384, 512, 768))
    M, S, new = hc.block, 1024, 128
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    rng = np.random.default_rng(21)
    prompts = {
        "a_random_200": rng.integers(3, V, size=200).tolist(),
        "b_own_corpus": rng.integers(3, V, size=96).tolist(),
        "c_repetitive": rng.integers(3, V, size=8).tolist() * 12}
    oracle = ArBaseline(qcfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=M)
    refs, ref_rows = {}, {}
    with AcceptRows("oracle") as rows:
        for name, p in prompts.items():
            n0 = len(rows.steps)
            refs[name] = oracle.generate(p, gen)
            ref_rows[name] = rows.steps[n0:]
    del oracle
    noise = noise_spread(qcfg, params, [
        (refs[n].output_ids, len(prompts[n]), ref_rows[n])
        for n in ("a_random_200", "c_repetitive")], int8=True)
    print(f"llama_7b hybrid: {noise_line(noise)} [{card}]", flush=True)
    engines = {"a_random_200": FusedHybridEngine(
        qcfg, params, hc, max_cache_len=S, eos_token_id=-1)}
    engines["c_repetitive"] = engines["a_random_200"]
    engines["b_own_corpus"] = FusedHybridEngine(
        qcfg, params, hc, corpus=refs["b_own_corpus"].output_ids + [0],
        max_cache_len=S, eos_token_id=-1)
    a = prompts["a_random_200"]
    for e in (engines["a_random_200"], engines["b_own_corpus"]):
        warm_harvest(e, np.random.default_rng(22), [
            (0, refs["a_random_200"].output_ids[len(a):],
             ref_rows["a_random_200"])])
    torch.cuda.synchronize()
    state = harvest_state(engines["a_random_200"], engines["b_own_corpus"])
    cases, done, runs, judged = [], [], [], []
    reset_counts()                              # the path starts here
    for name, p in prompts.items():
        eng = engines[name]
        with FusedSteps(eng, fh) as rec:
            rec.next_request()
            t0 = time.perf_counter()
            out = eng.generate(p, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        r = rec.per_rid[0]
        judged.append(out)
        cases.append((name, p, rec.outputs(0, out), refs[name], r["chains"],
                      ref_rows[name], r["rows"]))
        done.append((len(p), out.decode_steps))
        runs.append((out.decode_tokens, out.decode_steps, dt))
        print(f"llama_7b hybrid int8-KV request {name}: prompt {len(p)} new "
              f"{out.decode_tokens} decode_steps {out.decode_steps} "
              f"(retrieval chains {eng.sam_steps}) mean_accept "
              f"{out.decode_tokens / out.decode_steps:.3f} ms_per_step "
              f"{dt / out.decode_steps * 1e3:.3f} tok_per_s "
              f"{out.decode_tokens / dt:.2f} (prefill included) [{card}]",
              flush=True)
    counts = read_counts()                      # the path ends here
    note("phase11a_llama_7b_hybrid", **run_numbers(runs))
    judge_all(card, "llama_7b hybrid int8-KV", cases, qcfg, params, noise,
              "phase11a_llama_7b_hybrid")
    forwards = sum(1 + steps for _, steps in done)
    short = sum(steps + (n <= 128) for n, steps in done)
    want = {"flash_block_attention": 0,
            "flash_block_attention_int8kv": L * short,
            "int4_matmul": (7 * L + 1) * forwards,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want, f"llama_7b hybrid: launch counts {counts}, "
            f"expected {want}")
    print(f"llama_7b hybrid path: int4_matmul {counts['int4_matmul']} = 225 "
          f"x {forwards} forwards; int8-KV verify "
          f"{counts['flash_block_attention_int8kv']} = 32 x {short} forwards "
          f"of T <= 128 [{card}]", flush=True)
    graph_rerun(card, "llama_7b hybrid int8-KV", "phase11a_llama_7b_hybrid",
                state, lambda: serve_single(engines, prompts, gen), judged,
                counts)

    # (c) sampled: each accept mode twice from one saved harvest state;
    # point-mass requests equal the greedy run from that state
    eng = engines["a_random_200"]
    saved = (eng.harvests.clone(), eng.seens.clone())
    p = prompts["c_repetitive"]

    def run(**kw):
        eng.harvests.copy_(saved[0])
        eng.seens.copy_(saved[1])
        return eng.generate(p, GenerationConfig(
            max_new_tokens=64, max_cache_len=S, **kw)).output_ids

    for i, (mode, knobs) in enumerate((
            ("rejection", dict(temperature=0.8, top_k=50)),
            ("typical", dict(temperature=0.8)),
            ("nucleus", dict(temperature=0.8, top_p=0.9)))):
        one = run(greedy=False, seed=70 + i, accept_mode=mode, **knobs)
        fail_if(one != run(greedy=False, seed=70 + i, accept_mode=mode,
                           **knobs),
                f"llama_7b hybrid sampled {mode}: two runs with one seed "
                "differ")
        print(f"llama_7b hybrid sampled {mode}: two runs with seed {70 + i} "
              f"equal [{card}]", flush=True)
    greedy = run()
    for mode in POINT_MASS:
        fail_if(run(greedy=False, seed=80, accept_mode=mode,
                    **POINT_MASS[mode]) != greedy,
                f"llama_7b hybrid point-mass {mode}: differs from greedy")
    print(f"llama_7b hybrid point-mass rejection and nucleus requests equal "
          f"the greedy run [{card}]", flush=True)
    del engines, eng, saved
    gc.collect()
    torch.cuda.empty_cache()
    return prompts, refs, ref_rows, noise


PAGED_KW = dict(batch_size=12, max_cache_len=1024, eos_token_id=-1,
                prefill_buckets=(128, 256), n_pages=64, page_size=128,
                quantized_kv=True)


def server_hybrid_cfg():
    """The server's hybrid block: M 24, a 23-node tree, chains of 20."""
    from samd_tpu_torch.fused_hybrid import FusedHybridConfig

    return FusedHybridConfig(steps_per_call=16, tree_nodes=23,
                             n_predicts=20, max_block=24,
                             corpus_capacity=4096)


def chain_oracle_24(card, cfg, params, requests, **kw):
    """Phase 6's requests through the chain-only
    PagedBatchedFusedSamEngine at alpha = 0 and M = 24 over int8 pages
    (``PAGED_KW``): its outputs and per-request rows (``ChainOracleRows``),
    the corpus of its first four outputs, and the bound measured on
    requests 4 and 5 (int8 KV)."""
    from samd_tpu_torch.fused_sam import (FusedSamConfig,
                                          PagedBatchedFusedSamEngine)

    oracle_eng = PagedBatchedFusedSamEngine(
        cfg, params, FusedSamConfig(n_predicts=23, steps_per_call=16,
                                    alpha=0.0, corpus_capacity=4096),
        **{**PAGED_KW, **kw})
    with ChainOracleRows(oracle_eng) as orows:
        oracle, o_wall, o_steps = serve_batched(oracle_eng, requests,
                                                cfg.vocab_size)
    o_rows = [orows.per_rid[i] for i in range(len(requests))]
    del oracle_eng
    corpus = sum((o.output_ids + [0] for o in oracle[:4]), [])
    noise = noise_spread(cfg, params, [
        (o.output_ids, len(p), rr) for (p, _), o, rr in
        zip(requests[4:6], oracle[4:6], o_rows[4:6])], int8=True)
    print(f"llama_7b paged chain oracle at M = 24: "
          f"{o_wall / o_steps * 1e3:.3f} ms/step; {noise_line(noise)} "
          f"[{card}]", flush=True)
    return oracle, o_rows, corpus, noise


def every_path(requests, oracle, o_rows, slots: int) -> list:
    """``warm_harvest`` trajectories: every slot along every request's
    oracle path."""
    return [(b, o.output_ids[len(p):], rr) for b in range(slots)
            for (p, _), o, rr in zip(requests, oracle, o_rows)]


def main_path_7b_paged_hybrid(card, cfg, params, requests) -> tuple:
    """Phase 11b: PagedBatchedFusedHybridEngine at B = 12 with the
    server's block over 64 int8 pages, every slot's harvest warm along
    every request's oracle path, judged against the chain oracle at M =
    24 with the int8 tau; some tree slot-step must accept a path of depth
    >= 2.  Returns the oracle's outputs, rows, corpus and bound for phase
    13b."""
    import torch

    import samd_tpu_torch.fused_hybrid as fh
    from samd_tpu_torch.fused_hybrid import PagedBatchedFusedHybridEngine

    L, n_pages = cfg.num_layers, PAGED_KW["n_pages"]
    oracle, o_rows, corpus, noise = chain_oracle_24(card, cfg, params,
                                                    requests)
    check_paged_compaction(card)
    eng = PagedBatchedFusedHybridEngine(cfg, params, server_hybrid_cfg(),
                                        corpus=corpus, **PAGED_KW)
    warm_harvest(eng, np.random.default_rng(23),
                 every_path(requests, oracle, o_rows, eng.B))
    gc.collect()
    torch.cuda.synchronize()
    state = harvest_state(eng)
    with FusedSteps(eng, fh) as rec:
        reset_counts()                          # the path starts here
        outs, wall, steps = serve_batched(eng, requests, cfg.vocab_size)
        counts = read_counts()                  # the path ends here
    label = "llama_7b paged hybrid B=12 int8 pages"
    rid0 = min(rec.per_rid)
    cases = [(str(i), p, rec.outputs(rid0 + i, o), r,
              rec.per_rid[rid0 + i]["chains"], rr,
              rec.per_rid[rid0 + i]["rows"])
             for i, ((p, _), o, r, rr) in enumerate(zip(requests, outs,
                                                        oracle, o_rows))]
    key = "phase11b_llama_7b_paged_hybrid"
    verdicts = judge_all(card, label, cases, cfg, params, noise, key)
    deep_tree_steps(card, label, rec)
    del rec, cases
    fail_if(len(eng.pool._free) != n_pages or eng.live_kv_tokens() != 0,
            f"{label}: {n_pages - len(eng.pool._free)} pages not returned")
    new_tok = sum(o.decode_tokens for o in outs)
    n_equal = sum(v.startswith("equal") for v in verdicts)
    print(f"{label}: {len(outs)} requests, {new_tok} new tokens, {steps} "
          f"steps of [12, 24], wall {wall:.3f} s: {new_tok / wall:.2f} tok/s, "
          f"{wall / steps * 1e3:.3f} ms/step, mean accept "
          f"{new_tok / eng.steps_total:.3f} per live slot-step, retrieval "
          f"chains {eng.sam_steps_total} of {eng.steps_total} slot-steps, "
          f"peak_pages {eng.peak_pages} of {n_pages}; {n_equal} equal to "
          f"the chain oracle, {len(outs) - n_equal} near-ties (tau "
          f"{noise.tau:.5f}); all pages returned [{card}]", flush=True)
    note(key, tokens_per_s=new_tok / wall, ms_per_step=wall / steps * 1e3,
         mean_accept=new_tok / eng.steps_total, peak_pages=eng.peak_pages)
    p128 = sum(len(p) <= 128 for p, _ in requests)
    want = {"flash_block_attention": L * p128,
            "flash_block_attention_int8kv": 0,
            "int4_matmul": (7 * L + 1) * (steps + len(requests)),
            "paged_block_attention": 0,
            "paged_block_attention_int8kv": L * steps}
    fail_if(counts != want or not steps,
            f"{label}: launch counts {counts}, expected {want}")
    print(f"{label} path: K4 int8 {counts['paged_block_attention_int8kv']} = "
          f"32 x {steps} steps; K3 {counts['int4_matmul']} = 225 x "
          f"{steps + len(requests)} forwards [{card}]", flush=True)
    graph_rerun(card, label, key, state, lambda: serve_batched_loops(
        eng, requests, cfg.vocab_size), outs, counts)
    fail_if(len(eng.pool._free) != n_pages or eng.live_kv_tokens() != 0,
            f"{label}, graph route: pages not returned")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return oracle, o_rows, corpus, noise


def tree_depths(label, card, rec) -> None:
    """The committed lengths of ``rec``'s (``FusedSteps``) tree-drafted
    live slot-steps, counted: 1 is the root alone (no draft token
    accepted), d + 1 a path of depth d."""
    alens = [a for r in rec.per_rid.values()
             for c, a in zip(r["chains"], r["alens"]) if not c]
    counts = np.bincount(alens, minlength=2)[1:] if alens else []
    print(f"{label}: {len(alens)} tree slot-steps"
          + (" committing " + ", ".join(
              f"{n}: {k}" for n, k in enumerate(counts, 1) if k)
             + " tokens" if alens else "")
          + f"; {sum(a >= 2 for a in alens)} accepted a drafted token, "
          f"{sum(a >= 3 for a in alens)} a path of depth >= 2 [{card}]",
          flush=True)


def eagle_net_7b(cfg):
    """A random EAGLE draft net for llama_7b drawn on the card from seed 7
    and quantized to int8 (``quantize_eagle_params``)."""
    import torch

    from samd_tpu_torch.drafters.eagle.net import (EagleNetConfig,
                                                   init_eagle_params)
    from samd_tpu_torch.ops.quant import quantize_eagle_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    return quantize_eagle_params(init_eagle_params(
        EagleNetConfig.from_target(cfg), gen, device="cuda"))


def main_path_7b_eagle(card, cfg, params, single, paged, requests) -> None:
    """Phase 13: llama_7b int4 through SAM[EAGLE-2] with an int8 draft net:
    (a) FusedHybridEagleEngine over int8 KV (M 64, depth 5, top-8, 63
    nodes, chains of 40) on phase 11a's requests, judged against its
    ArBaseline(block_size=64) rows (``single``); (b)
    PagedBatchedFusedHybridEagleEngine at B = 12 with the server's block
    (M 24, depth 4, top-4, 23 nodes, chains of 20) over 64 int8 pages on
    phase 6's requests, judged against 11b's chain oracle (``paged``);
    (c) one sampled pair per tree accept mode, point-mass requests equal
    to greedy."""
    import torch

    import samd_tpu_torch.fused_hybrid as fh
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.fused_hybrid import (
        FusedHybridEagleConfig, FusedHybridEagleEngine,
        PagedBatchedFusedHybridEagleEngine)

    L, S = cfg.num_layers, 1024
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    net = eagle_net_7b(cfg)
    prompts, refs, ref_rows, noise = single
    hc = FusedHybridEagleConfig(corpus_capacity=4096)
    gen = GenerationConfig(max_new_tokens=128, max_cache_len=S)
    eng = FusedHybridEagleEngine(qcfg, params, hc, net_params=net,
                                 max_cache_len=S, eos_token_id=-1)
    own = FusedHybridEagleEngine(
        qcfg, params, hc, net_params=net,
        corpus=refs["b_own_corpus"].output_ids + [0], max_cache_len=S,
        eos_token_id=-1)
    engines = {"a_random_200": eng, "b_own_corpus": own,
               "c_repetitive": eng}
    eng.generate(prompts["c_repetitive"][:16],
                 GenerationConfig(max_new_tokens=8))         # warm-up
    torch.cuda.synchronize()
    label = "llama_7b SAM[EAGLE-2] int8-KV"
    cases, done, runs, judged = [], [], [], []
    with FusedSteps(eng, fh) as rec_a, FusedSteps(own, fh) as rec_b:
        recs = {"a_random_200": rec_a, "b_own_corpus": rec_b,
                "c_repetitive": rec_a}
        reset_counts()                          # the path starts here
        for name, p in prompts.items():
            e, rec = engines[name], recs[name]
            rec.next_request()
            t0 = time.perf_counter()
            out = e.generate(p, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = rec.per_rid[rec.rid]
            judged.append(out)
            cases.append((name, p, rec.outputs(rec.rid, out), refs[name],
                          r["chains"], ref_rows[name], r["rows"]))
            done.append((len(p), out.decode_steps))
            runs.append((out.decode_tokens, out.decode_steps, dt))
            print(f"{label} request {name}: prompt {len(p)} new "
                  f"{out.decode_tokens} decode_steps {out.decode_steps} "
                  f"(retrieval chains {e.sam_steps}) mean_accept "
                  f"{out.decode_tokens / out.decode_steps:.3f} ms_per_step "
                  f"{dt / out.decode_steps * 1e3:.3f} tok_per_s "
                  f"{out.decode_tokens / dt:.2f} (prefill included) "
                  f"[{card}]", flush=True)
        counts = read_counts()                  # the path ends here
        note("phase13_llama_7b_eagle_hybrid", **run_numbers(runs))
        judge_all(card, label, cases, qcfg, params, noise,
                  "phase13_llama_7b_eagle_hybrid")
        for rec in (rec_a, rec_b):
            tree_depths(label, card, rec)
    graph_rerun(card, label, "phase13_llama_7b_eagle_hybrid", [],
                lambda: serve_single(engines, prompts, gen), judged, counts)
    steps = sum(s for _, s in done)
    forwards = sum(1 + s for _, s in done)
    short = sum(s + (n <= 128) for n, s in done)
    want = {"flash_block_attention": 0,
            "flash_block_attention_int8kv": L * short,
            "int4_matmul": (7 * L + 1) * forwards + hc.eagle_depth * steps,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want, f"{label}: launch counts {counts}, expected "
            f"{want}")
    print(f"{label} path: int4_matmul {counts['int4_matmul']} = 225 x "
          f"{forwards} forwards + {hc.eagle_depth} draft-head launches x "
          f"{steps} steps; int8-KV verify "
          f"{counts['flash_block_attention_int8kv']} = 32 x {short} forwards "
          f"of T <= 128 [{card}]", flush=True)

    # (c) sampled pairs per tree accept mode; point-mass equals greedy
    p = prompts["c_repetitive"]

    def run(**kw):
        return eng.generate(p, GenerationConfig(
            max_new_tokens=64, max_cache_len=S, **kw)).output_ids

    for i, (mode, knobs) in enumerate((
            ("rejection", dict(temperature=0.8, top_k=50)),
            ("typical", dict(temperature=0.8)),
            ("nucleus", dict(temperature=0.8, top_p=0.9)))):
        one = run(greedy=False, seed=90 + i, accept_mode=mode, **knobs)
        fail_if(one != run(greedy=False, seed=90 + i, accept_mode=mode,
                           **knobs),
                f"{label} sampled {mode}: two runs with one seed differ")
        print(f"{label} sampled {mode}: two runs with seed {90 + i} equal "
              f"[{card}]", flush=True)
    greedy = run()
    for mode in POINT_MASS:
        fail_if(run(greedy=False, seed=95, accept_mode=mode,
                    **POINT_MASS[mode]) != greedy,
                f"{label} point-mass {mode}: differs from greedy")
    print(f"{label} point-mass rejection and nucleus requests equal the "
          f"greedy run [{card}]", flush=True)
    del eng, own, engines, cases
    gc.collect()
    torch.cuda.empty_cache()

    # (b) paged B = 12, the server's block, over int8 pages
    oracle, o_rows, corpus, noise = paged
    n_pages = PAGED_KW["n_pages"]
    hy = FusedHybridEagleConfig(steps_per_call=16, eagle_depth=4,
                                eagle_topk=4, eagle_total=23, max_block=24,
                                n_predicts=20, corpus_capacity=4096)
    eng = PagedBatchedFusedHybridEagleEngine(cfg, params, hy, net_params=net,
                                             corpus=corpus, **PAGED_KW)
    gc.collect()
    torch.cuda.synchronize()
    label = "llama_7b paged SAM[EAGLE-2] B=12 int8 pages"
    with FusedSteps(eng, fh) as rec:
        reset_counts()                          # the path starts here
        outs, wall, steps = serve_batched(eng, requests, cfg.vocab_size)
        counts = read_counts()                  # the path ends here
    cases = [(str(i), p, rec.outputs(i, o), r, rec.per_rid[i]["chains"], rr,
              rec.per_rid[i]["rows"])
             for i, ((p, _), o, r, rr) in enumerate(zip(requests, outs,
                                                        oracle, o_rows))]
    key = "phase13_llama_7b_paged_eagle_hybrid"
    verdicts = judge_all(card, label, cases, cfg, params, noise, key)
    tree_depths(label, card, rec)
    del rec, cases
    fail_if(len(eng.pool._free) != n_pages or eng.live_kv_tokens() != 0,
            f"{label}: {n_pages - len(eng.pool._free)} pages not returned")
    new_tok = sum(o.decode_tokens for o in outs)
    n_equal = sum(v.startswith("equal") for v in verdicts)
    print(f"{label}: {len(outs)} requests, {new_tok} new tokens, {steps} "
          f"steps of [12, 24], wall {wall:.3f} s: {new_tok / wall:.2f} tok/s, "
          f"{wall / steps * 1e3:.3f} ms/step, mean accept "
          f"{new_tok / eng.steps_total:.3f} per live slot-step, retrieval "
          f"chains {eng.sam_steps_total} of {eng.steps_total} slot-steps, "
          f"peak_pages {eng.peak_pages} of {n_pages}; {n_equal} equal to "
          f"the chain oracle, {len(outs) - n_equal} near-ties (tau "
          f"{noise.tau:.5f}); all pages returned [{card}]", flush=True)
    note(key, tokens_per_s=new_tok / wall, ms_per_step=wall / steps * 1e3,
         mean_accept=new_tok / eng.steps_total, peak_pages=eng.peak_pages)
    p128 = sum(len(p) <= 128 for p, _ in requests)
    want = {"flash_block_attention": L * p128,
            "flash_block_attention_int8kv": 0,
            "int4_matmul": (7 * L + 1) * (steps + len(requests))
            + hy.eagle_depth * steps,
            "paged_block_attention": 0,
            "paged_block_attention_int8kv": L * steps}
    fail_if(counts != want or not steps,
            f"{label}: launch counts {counts}, expected {want}")
    print(f"{label} path: K4 int8 {counts['paged_block_attention_int8kv']} = "
          f"32 x {steps} steps; K3 {counts['int4_matmul']} = 225 x "
          f"{steps + len(requests)} forwards + {hy.eagle_depth} draft-head "
          f"launches x {steps} steps [{card}]", flush=True)
    graph_rerun(card, label, key, [], lambda: serve_batched_loops(
        eng, requests, cfg.vocab_size), outs, counts)
    del eng, net
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# python3 chip_smoke.py --isolate-11b: a reporting run of phase 11b
# ----------------------------------------------------------------------

class SnapAt:
    """While active, copies out the slot of request ``rid`` of a paged
    batched engine just before the step that starts at committed length
    ``h0``: its pages gathered into a dense batch-1 cache of ``S``
    columns (``cache.QuantizedKV`` over int8 pages)."""

    def __init__(self, engine, rid, h0, S):
        self.engine, self.rid, self.h0, self.S = engine, rid, h0, S
        self.kv = None

    def __enter__(self):
        import torch

        from samd_tpu_torch.cache import QuantizedKV
        from samd_tpu_torch.ops.paged_attention import gather_pages

        eng, step = self.engine, self.engine._step
        eng.segmented = False           # the snapshot reads every step

        def dense(side, table):
            def cut(x):
                g = torch.stack([gather_pages(x[l], table[None])
                                 for l in range(x.shape[0])])
                return g[:, :, :, :self.S].clone()
            if side.scale is None:
                return cut(side.pool)
            return QuantizedKV(cut(side.pool), cut(side.scale))

        def snap_step(hist_lens, *rest):
            hl = hist_lens.cpu().numpy()
            for b, rid in enumerate(eng._slot_req):
                if rid == self.rid and int(hl[b]) == self.h0 \
                        and self.kv is None:
                    table = eng.page_reqs[b].table(eng.device)
                    self.kv = (dense(eng.kv_k, table),
                               dense(eng.kv_v, table))
            return step(hist_lens, *rest)
        eng._step = snap_step
        return self

    def __exit__(self, *exc):
        for name in ("_step", "segmented"):
            self.engine.__dict__.pop(name, None)


def chain_rows(cfg, params, kv, h0, tokens, M):
    """``tokens`` re-verified as one chain of an M-wide block at committed
    length ``h0`` over a copy of the dense batch-1 cache ``kv`` (the
    verify kernel, its int8 mode for a ``QuantizedKV``): the logits rows of
    the chain, [len(tokens), V]."""
    import torch

    from samd_tpu_torch.cache import QuantizedKV
    from samd_tpu_torch.fused_sam import chain_tree_mask
    from samd_tpu_torch.models import block_decode_mask, forward

    k, v = (QuantizedKV(x.q.clone(), x.scale.clone())
            if isinstance(x, QuantizedKV) else x.clone() for x in kv)
    qcfg = dataclasses.replace(cfg, kv_quant=isinstance(k, QuantizedKV))
    n = len(tokens)
    block = torch.zeros((1, M), dtype=torch.int32, device="cuda")
    block[0, :n] = torch.tensor(tokens, dtype=torch.int32)
    off = torch.tensor(h0, dtype=torch.int32, device="cuda")
    pos = (off + torch.arange(M, device="cuda"))[None]
    mask = block_decode_mask(chain_tree_mask(
        torch.tensor(n, device="cuda"), M), off, k.shape[3])
    logits, _ = forward(params, qcfg, block, pos, k, v, off, mask)
    return logits[0, :n].float()


def isolate_11b(card: str) -> int:
    """Phase 11b warmed along every path, reported, not judged into a
    failure; at the first request whose first difference the judge
    rejects by the fixed bf16 bound (tau 0.08, the rule before the int8
    bound), the token there: (i) over bf16 pages, (ii) through the dense
    int8 BatchedFusedHybridEngine, (iii) the step's accepted path
    re-verified as a chain over the engine's own cache and (iv) over the
    chain oracle's cache at that length; and how the two caches differ."""
    import torch

    import samd_tpu_torch.fused_hybrid as fh
    from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEngine,
                                             PagedBatchedFusedHybridEngine)
    from samd_tpu_torch.fused_sam import (FusedSamConfig,
                                          PagedBatchedFusedSamEngine)

    cfg, params = llama_7b_int4_params()
    V = cfg.vocab_size
    requests = phase6_requests(V)
    oracle, o_rows, corpus, noise = chain_oracle_24(card, cfg, params,
                                                    requests)
    hy = server_hybrid_cfg()
    M = hy.max_block
    fixed = SimpleNamespace(**{**vars(noise), "int8": False})

    def run(label, make):
        eng = make()
        warm_harvest(eng, np.random.default_rng(23),
                     every_path(requests, oracle, o_rows, eng.B))
        with FusedSteps(eng, fh) as rec:
            outs, _, _ = serve_batched(eng, requests, V)
        bad = []
        for i, ((p, _), o, r, rr) in enumerate(zip(requests, outs, oracle,
                                                   o_rows)):
            got = rec.per_rid[i]
            verdict, reason = judge(p, rec.outputs(i, o), r, got["chains"],
                                    rr, cfg, params, fixed, got["rows"])
            print(f"isolate 11b ({label}) request {i}: "
                  f"{verdict or 'REJECTED: ' + reason} [{card}]", flush=True)
            if verdict is None:
                bad.append(i)
        deep = [a for r in rec.per_rid.values()
                for c, a in zip(r["chains"], r["alens"]) if not c]
        print(f"isolate 11b ({label}): {sum(a >= 3 for a in deep)} of "
              f"{len(deep)} tree slot-steps accepted depth >= 2 [{card}]",
              flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return rec, outs, bad

    def paged(**kw):
        return lambda: PagedBatchedFusedHybridEngine(
            cfg, params, hy, corpus=corpus, **{**PAGED_KW, **kw})

    rec, outs, bad = run("int8 pages", paged())
    if not bad:
        print("isolate 11b: no request rejected", flush=True)
        return 0
    i = bad[0]
    p, out, ref = requests[i][0], outs[i], oracle[i]
    j = next(n for n, (x, y) in enumerate(zip(out.output_ids,
                                               ref.output_ids)) if x != y)
    a, b = out.output_ids[j], ref.output_ids[j]
    # the step whose path row chose token j: committed length h0, row k
    alens, h0 = rec.per_rid[i]["alens"], len(p)
    for s, n in enumerate(alens):
        if h0 + n >= j:
            break
        h0 += n
    k = j - h0 - 1
    print(f"isolate 11b: request {i} differs at {j} (engine {a}, oracle "
          f"{b}); the step from committed length {h0} (step {s}, "
          f"{'chain' if rec.per_rid[i]['chains'][s] else 'tree'} draft, "
          f"{alens[s]} committed) chose it at path row {k} [{card}]",
          flush=True)
    del rec

    def gaps(rows, label):
        r = rows[k]
        print(f"isolate 11b ({label}): argmax {int(r.argmax())}, "
              f"row[{a}] - row[{b}] = {float(r[a] - r[b]):.5f} [{card}]",
              flush=True)

    # (i) bf16 pages, (ii) the dense int8 engine: the token at j
    dense = dict(batch_size=12, max_cache_len=1024, eos_token_id=-1,
                 prefill_buckets=(128, 256))
    for label, make in (
            ("i bf16 pages", paged(quantized_kv=False)),
            ("ii dense int8 KV", lambda: BatchedFusedHybridEngine(
                dataclasses.replace(cfg, kv_quant=True), params, hy,
                corpus=corpus, **dense))):
        got = run(label, make)[1][i].output_ids
        print(f"isolate 11b ({label}): request {i} token {j} = {got[j]} "
              f"(prefix {'equal to' if got[:j] == out.output_ids[:j] else 'differs from'} "
              f"the int8 engine's) [{card}]", flush=True)

    # (iii) the engine's own cache, (iv) the chain oracle's, at length h0
    tokens = out.output_ids[h0:h0 + k + 1]
    eng = paged()()
    warm_harvest(eng, np.random.default_rng(23),
                 every_path(requests, oracle, o_rows, eng.B))
    with SnapAt(eng, i, h0, 1024) as snap:
        serve_batched(eng, requests, V)
    kv_eng = snap.kv
    del eng
    gc.collect()
    ora = PagedBatchedFusedSamEngine(
        cfg, params, FusedSamConfig(n_predicts=23, steps_per_call=16,
                                    alpha=0.0, corpus_capacity=4096),
        **PAGED_KW)
    with SnapAt(ora, i, h0, 1024) as snap:
        serve_batched(ora, requests, V)
    kv_ora = snap.kv
    del ora
    gc.collect()
    gaps(chain_rows(cfg, params, kv_eng, h0, tokens, M),
         "iii chain over the engine's cache")
    gaps(chain_rows(cfg, params, kv_ora, h0, tokens, M),
         "iv chain over the oracle's cache")
    for side, (x, y) in zip("kv", zip(kv_eng, kv_ora)):
        dq = (x.q[:, :, :, :h0] != y.q[:, :, :, :h0])
        cols = dq.any(dim=-1).any(dim=0).any(dim=0).any(dim=0)
        first = int(cols.nonzero()[0]) if cols.any() else -1
        step = (x.q[:, :, :, :h0].int() - y.q[:, :, :, :h0].int()).abs()
        print(f"isolate 11b: {side} cache of the engine against the "
              f"oracle's over the first {h0} columns: {int(dq.sum())} int8 "
              f"values differ (largest difference {int(step.max())} "
              f"steps), in {int(cols.sum())} columns, the first at "
              f"{first}; scales differ in "
              f"{int((x.scale[..., :h0] != y.scale[..., :h0]).sum())} "
              f"[{card}]", flush=True)
    return 0


def main_path_1b_fused(card: str) -> None:
    """Phase 12: llama_1b bf16 through PldEngine, FusedTokenRecycleEngine,
    the dense and paged BatchedFusedHybridEngine at B = 4, and both hybrid
    server engines over HTTP."""
    import torch

    import samd_tpu_torch.fused_hybrid as fh
    import samd_tpu_torch.token_recycle_fused as trf
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEngine,
                                             FusedHybridConfig,
                                             PagedBatchedFusedHybridEngine)
    from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine,
                                          FusedSamConfig,
                                          PagedBatchedFusedSamEngine)
    from samd_tpu_torch.models import init_params, llama_1b
    from samd_tpu_torch.pld import PldConfig, PldEngine
    from samd_tpu_torch.server import build_server_engine
    from samd_tpu_torch.server import serve as serve_http
    from samd_tpu_torch.token_recycle_fused import FusedTokenRecycleEngine

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    S, V, L = 2048, cfg.vocab_size, cfg.num_layers
    gen = GenerationConfig(max_new_tokens=128, max_cache_len=S)
    rng = np.random.default_rng(31)
    base = rng.integers(3, V, size=8).tolist()
    prompts = {"a_random": rng.integers(3, V, size=64).tolist(),
               "b_repetitive": base * 12}

    # PLD: chains only, bitwise equal to the block-11 oracle
    pld = PldEngine(cfg, params, PldConfig(), max_cache_len=S,
                    eos_token_id=-1)
    oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=PldConfig().block)
    refs = {n: oracle.generate(p, gen) for n, p in prompts.items()}
    reset_counts()                              # the path starts here
    done = serve(card, "llama_1b PLD", {n: pld for n in prompts}, prompts,
                 refs, gen, V, "phase12_llama_1b_pld")
    counts = read_counts()                      # the path ends here
    forwards = sum(1 + steps for _, steps in done)
    fail_if(counts["flash_block_attention"] != L * forwards
            or sum(counts.values()) != L * forwards,
            f"llama_1b PLD: launch counts {counts}, expected 22 x "
            f"{forwards} verify launches")
    del pld, oracle

    # fused Token Recycle, a warm harvest: 61-node trees, judged
    tr = FusedTokenRecycleEngine(cfg, params, max_cache_len=S,
                                 eos_token_id=-1)
    oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=tr.N)
    refs, ref_rows = {}, {}
    with AcceptRows("oracle") as rows:
        for name, p in prompts.items():
            n0 = len(rows.steps)
            refs[name] = oracle.generate(p, gen)
            ref_rows[name] = rows.steps[n0:]
    del oracle
    noise = noise_spread(cfg, params, [
        (refs[n].output_ids, len(p), ref_rows[n])
        for n, p in prompts.items()])
    a = prompts["a_random"]
    warm_harvest(tr, np.random.default_rng(32), [
        (0, refs["a_random"].output_ids[len(a):], ref_rows["a_random"])])
    warm = (tr.harvests.clone(), tr.seens.clone())
    cases, forwards, runs, judged = [], 0, [], {}
    reset_counts()                              # the path starts here
    for name, p in prompts.items():
        with FusedSteps(tr, trf) as rec:
            rec.next_request()
            t0 = time.perf_counter()
            out = tr.generate(p, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        r = rec.per_rid[0]
        judged[name] = out
        cases.append((name, p, rec.outputs(0, out), refs[name], r["chains"],
                      ref_rows[name], r["rows"]))
        forwards += 1 + out.decode_steps
        runs.append((out.decode_tokens, out.decode_steps, dt))
        print(f"llama_1b fused Token Recycle request {name}: "
              f"{out.decode_steps} steps of a 61-node tree, mean accept "
              f"{out.decode_tokens / out.decode_steps:.3f}, "
              f"{dt / out.decode_steps * 1e3:.3f} ms/step [{card}]",
              flush=True)
    counts = read_counts()                      # the path ends here
    print(f"llama_1b fused Token Recycle: {noise_line(noise)} [{card}]",
          flush=True)
    note("phase12_llama_1b_fused_token_recycle", **run_numbers(runs))
    judge_all(card, "llama_1b fused Token Recycle", cases, cfg, params,
              noise, "phase12_llama_1b_fused_token_recycle")
    fail_if(counts["flash_block_attention"] != L * forwards
            or sum(counts.values()) != L * forwards,
            f"llama_1b fused Token Recycle: launch counts {counts}")
    # the judged run read every step for its recorder; the graph route,
    # from the same harvest, must give its tokens and steps
    tr.harvests.copy_(warm[0])
    tr.seens.copy_(warm[1])
    loops, forwards, runs = [], 0, []
    reset_counts()                              # the path starts here
    for name, p in prompts.items():
        t0 = time.perf_counter()
        out = tr.generate(p, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fail_if(out != judged[name], f"llama_1b fused Token Recycle request "
                f"{name}: the graph route differs from the judged run")
        loops.append(tr.loop_stats)
        forwards += 1 + out.decode_steps
        runs.append((out.decode_tokens, out.decode_steps, dt))
        print(f"llama_1b fused Token Recycle request {name}, graph route: "
              f"equal to the judged run; {dt / out.decode_steps * 1e3:.3f} "
              f"ms/step; {loop_line(loops[-1], out.decode_steps)} [{card}]",
              flush=True)
    counts = read_counts()                      # the path ends here
    fail_if(counts["flash_block_attention"] != L * forwards
            or sum(counts.values()) != L * forwards,
            f"llama_1b fused Token Recycle, graph route: launch counts "
            f"{counts}")
    note("phase12_llama_1b_fused_token_recycle_graph", **run_numbers(runs))
    loop_check(card, "llama_1b fused Token Recycle",
               "phase12_llama_1b_fused_token_recycle_graph", loops,
               [j.decode_steps for j in judged.values()])
    del tr, cases
    gc.collect()

    # the dense and paged batched hybrid at B = 4, M = 24
    kw = dict(batch_size=4, max_cache_len=1024, eos_token_id=-1,
              prefill_buckets=(128, 256))
    rng = np.random.default_rng(33)
    fresh = [(rng.integers(3, V, size=int(n)).tolist(), 64)
             for n in rng.integers(40, 101, size=4)]
    requests = fresh + fresh[:2]
    hy = FusedHybridConfig(steps_per_call=16, tree_nodes=23, n_predicts=20,
                           max_block=24, corpus_capacity=4096)
    chain = FusedSamConfig(n_predicts=hy.block - 1, steps_per_call=16,
                           alpha=0.0, corpus_capacity=4096)
    pages = dict(n_pages=32, page_size=128)
    for kind, (hy_ctor, sam_ctor, extra) in {
            "dense": (BatchedFusedHybridEngine, BatchedFusedSamEngine, {}),
            "paged": (PagedBatchedFusedHybridEngine,
                      PagedBatchedFusedSamEngine, pages)}.items():
        label = f"llama_1b {kind} hybrid B=4"
        ora = sam_ctor(cfg, params, chain, **kw, **extra)
        with ChainOracleRows(ora) as orows:
            oracle, _, _ = serve_batched(ora, requests, V)
        o_rows = [orows.per_rid[i] for i in range(len(requests))]
        del ora
        noise = noise_spread(cfg, params, [
            (o.output_ids, len(p), rr) for (p, _), o, rr in
            zip(requests[:2], oracle[:2], o_rows[:2])])
        corpus = sum((o.output_ids + [0] for o in oracle[:2]), [])
        eng = hy_ctor(cfg, params, hy, corpus=corpus, **kw, **extra)
        warm_harvest(eng, np.random.default_rng(34), [
            (b, o.output_ids[len(p):], rr) for b in range(kw["batch_size"])
            for (p, _), o, rr in zip(requests, oracle, o_rows)])
        torch.cuda.synchronize()
        state = harvest_state(eng)
        with FusedSteps(eng, fh) as rec:
            reset_counts()                      # the path starts here
            outs, wall, steps = serve_batched(eng, requests, V)
            counts = read_counts()              # the path ends here
        cases = [(str(i), p, rec.outputs(i, o), r, rec.per_rid[i]["chains"],
                  rr, rec.per_rid[i]["rows"])
                 for i, ((p, _), o, r, rr) in enumerate(zip(
                     requests, outs, oracle, o_rows))]
        key = f"phase12_llama_1b_{kind}_hybrid_b4"
        verdicts = judge_all(card, label, cases, cfg, params, noise, key)
        deep_tree_steps(card, label, rec)
        del rec, cases
        n_equal = sum(v.startswith("equal") for v in verdicts)
        new_tok = sum(o.decode_tokens for o in outs)
        note(key, tokens_per_s=new_tok / wall,
             ms_per_step=wall / steps * 1e3,
             mean_accept=new_tok / eng.steps_total)
        print(f"{label}: {new_tok} new tokens, {steps} steps of [4, 24], "
              f"{wall / steps * 1e3:.3f} ms/step, {new_tok / wall:.2f} tok/s, "
              f"retrieval chains {eng.sam_steps_total} of {eng.steps_total} "
              f"slot-steps; {n_equal} equal to the chain oracle, "
              f"{len(outs) - n_equal} near-ties (bound {noise.spread:.5f}) "
              f"[{card}]", flush=True)
        want = {"flash_block_attention": L * len(requests),
                "flash_block_attention_int8kv": 0, "int4_matmul": 0,
                "paged_block_attention": L * steps if kind == "paged"
                else 0, "paged_block_attention_int8kv": 0}
        fail_if(counts != want or not steps,
                f"{label}: launch counts {counts}, expected {want}")
        if kind == "paged":
            fail_if(len(eng.pool._free) != 32, f"{label}: pages not "
                    "returned")
            note(key, peak_pages=eng.peak_pages)
        graph_rerun(card, label, key, state, lambda: serve_batched_loops(
            eng, requests, V), outs, counts)
        del eng
        gc.collect()

    # both hybrid server engines over 127.0.0.1, against the same engine
    # called directly from the same (empty) harvest tables
    four = [p for p, _ in requests[:4]]
    for name in ("fused_hybrid_batched", "paged_fused_hybrid"):
        args = SimpleNamespace(model=None, random_model=True, tiny=False,
                               engine=name, batch_size=4, quantize=None,
                               max_cache_len=1024, sam=None, cpu=False,
                               inline_prefill=False)
        eng = build_server_engine(args)
        direct, _, _ = serve_batched(eng, [(p, 32) for p in four], V)
        eng.harvests.zero_()
        eng.seens.zero_()
        server, sched = serve_http(eng, port=0, block=False)
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            reset_counts()                      # the path starts here
            replies = http_traffic(url, [{"input_ids": p,
                                          "max_new_tokens": 32}
                                         for p in four], name)
            counts = read_counts()              # the path ends here
        finally:
            server.shutdown()
            sched.close()
        fail_if([r["output_ids"] for r in replies]
                != [o.output_ids for o in direct],
                f"server --engine {name}: replies differ from the engine "
                "called directly")
        fail_if(counts["flash_block_attention"] != L * len(four)
                or (name == "paged_fused_hybrid")
                != bool(counts["paged_block_attention"]),
                f"server --engine {name}: launch counts {counts}")
        print(f"server --engine {name}: 4 greedy replies over HTTP equal to "
              f"the engine called directly; launches {counts} [{card}]",
              flush=True)
        del eng
        gc.collect()


def main_path_1b_eagle(card: str) -> None:
    """Phase 14: llama_1b bf16 through the EAGLE engines with a random
    bf16 draft net (seed 7): FusedEagle2Engine (depth 5, top-8, 63 nodes)
    against ArBaseline(block_size=64); SamdEngine at M = 64 with the
    EAGLE-2 and EAGLE-1 tree drafters against the same oracle; the dense
    BatchedFusedHybridEagleEngine at B = 4 with the server's block against
    its chain-only engine at alpha = 0; and --engine
    eagle2_hybrid_batched over 127.0.0.1 against the engine called
    directly.  Every request through phase 9's judge."""
    import torch

    import samd_tpu_torch.eagle_fused as ef
    import samd_tpu_torch.fused_hybrid as fh
    from samd_tpu_torch.config import GenerationConfig, SamdConfig
    from samd_tpu_torch.drafters import make_drafter
    from samd_tpu_torch.drafters.eagle.net import (EagleNetConfig,
                                                   init_eagle_params)
    from samd_tpu_torch.eagle_fused import FusedEagle2Engine
    from samd_tpu_torch.engine import ArBaseline, SamdEngine
    from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEagleEngine,
                                             FusedHybridEagleConfig)
    from samd_tpu_torch.fused_sam import BatchedFusedSamEngine, FusedSamConfig
    from samd_tpu_torch.models import init_params, llama_1b
    from samd_tpu_torch.server import build_server_engine
    from samd_tpu_torch.server import serve as serve_http

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    gen_w.manual_seed(7)
    net = init_eagle_params(EagleNetConfig.from_target(cfg), gen_w,
                            device="cuda")
    S, V, L, M = 2048, cfg.vocab_size, cfg.num_layers, 64
    gen = GenerationConfig(max_new_tokens=96, max_cache_len=S)
    rng = np.random.default_rng(41)
    prompts = {"a_random": rng.integers(3, V, size=64).tolist(),
               "b_repetitive": rng.integers(3, V, size=8).tolist() * 12}
    oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                        block_size=M)
    refs, ref_rows = {}, {}
    with AcceptRows("oracle") as rows:
        for name, p in prompts.items():
            n0 = len(rows.steps)
            refs[name] = oracle.generate(p, gen)
            ref_rows[name] = rows.steps[n0:]
    del oracle
    noise = noise_spread(cfg, params, [
        (refs[n].output_ids, len(p), ref_rows[n])
        for n, p in prompts.items()])
    print(f"llama_1b EAGLE: {noise_line(noise)} [{card}]", flush=True)

    # FusedEagle2Engine
    label = "llama_1b FusedEagle2Engine"
    eng = FusedEagle2Engine(cfg, params, net_params=net, max_cache_len=S,
                            eos_token_id=-1)
    cases, forwards, runs, judged = [], 0, [], []
    with FusedSteps(eng, ef) as rec:
        reset_counts()                          # the path starts here
        for name, p in prompts.items():
            rec.next_request()
            t0 = time.perf_counter()
            out = eng.generate(p, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = rec.per_rid[rec.rid]
            judged.append(out)
            cases.append((name, p, rec.outputs(rec.rid, out), refs[name],
                          r["chains"], ref_rows[name], r["rows"]))
            forwards += 1 + out.decode_steps
            runs.append((out.decode_tokens, out.decode_steps, dt))
            print(f"{label} request {name}: {out.decode_steps} steps of a "
                  f"64-node tree, mean accept "
                  f"{out.decode_tokens / out.decode_steps:.3f}, "
                  f"{dt / out.decode_steps * 1e3:.3f} ms/step [{card}]",
                  flush=True)
        counts = read_counts()                  # the path ends here
    note("phase14_llama_1b_fused_eagle2", **run_numbers(runs))
    judge_all(card, label, cases, cfg, params, noise,
              "phase14_llama_1b_fused_eagle2")
    tree_depths(label, card, rec)
    fail_if(counts["flash_block_attention"] != L * forwards
            or sum(counts.values()) != L * forwards,
            f"{label}: launch counts {counts}, expected 22 x {forwards}")
    graph_rerun(card, label, "phase14_llama_1b_fused_eagle2", [],
                lambda: serve_single({n: eng for n in prompts}, prompts,
                                     gen), judged, counts)
    del eng, rec, cases
    gc.collect()

    # SamdEngine with the EAGLE-2 and EAGLE-1 tree drafters
    for method in ("eagle2", "eagle"):
        label = f"llama_1b SamdEngine sam_hybrid {method}"
        scfg = SamdConfig(draft_source="sam_hybrid", tree_method=method,
                          max_predicts=M)
        log = DraftLog(make_drafter(scfg, V, model_cfg=cfg, params=params,
                                    eagle_net_params=net))
        eng = SamdEngine(cfg, params, scfg, log, max_cache_len=S,
                         eos_token_id=-1)
        forwards, runs, n_equal = 0, [], 0
        reset_counts()                          # the path starts here
        for name, p in prompts.items():
            with AcceptRows("path") as rows:
                t0 = time.perf_counter()
                out = eng.generate(p, gen)
                runs.append((out.decode_tokens, out.decode_steps,
                             time.perf_counter() - t0))
            forwards += 1 + out.decode_steps
            verdict = oracle_verdict(f"{label} request {name}", p, out,
                                     refs[name], log.chains, ref_rows[name],
                                     cfg, params, noise, rows.steps)
            n_equal += verdict.startswith("equal")
            print(f"{label} request {name}: {out.decode_steps} steps "
                  f"({log.chains.count(False)} tree drafts of "
                  f"{run_lengths(log.nodes)} nodes), mean accept by source: "
                  f"{by_source(eng.stats)}; {verdict} [{card}]", flush=True)
        counts = read_counts()                  # the path ends here
        fail_if(counts["flash_block_attention"] != L * forwards
                or sum(counts.values()) != L * forwards
                or not eng.stats.source_counts.get(method),
                f"{label}: launch counts {counts}, sources "
                f"{eng.stats.source_counts}")
        note(f"phase14_llama_1b_samd_{method}", **run_numbers(runs),
             equal_to_oracle=f"{n_equal}/{len(prompts)}")
        del eng, log
        gc.collect()

    # the dense batched SAM[EAGLE-2] at B = 4 with the server's block
    label = "llama_1b dense SAM[EAGLE-2] B=4"
    kw = dict(batch_size=4, max_cache_len=1024, eos_token_id=-1,
              prefill_buckets=(128, 256))
    rng = np.random.default_rng(43)
    fresh = [(rng.integers(3, V, size=int(n)).tolist(), 64)
             for n in rng.integers(40, 101, size=4)]
    requests = fresh + fresh[:2]
    hy = FusedHybridEagleConfig(steps_per_call=16, eagle_depth=4,
                                eagle_topk=4, eagle_total=23, max_block=24,
                                n_predicts=20, corpus_capacity=4096)
    ora = BatchedFusedSamEngine(cfg, params, FusedSamConfig(
        n_predicts=23, steps_per_call=16, alpha=0.0, corpus_capacity=4096),
        **kw)
    with ChainOracleRows(ora) as orows:
        oracle, _, _ = serve_batched(ora, requests, V)
    o_rows = [orows.per_rid[i] for i in range(len(requests))]
    del ora
    bnoise = noise_spread(cfg, params, [
        (o.output_ids, len(p), rr) for (p, _), o, rr in
        zip(requests[:2], oracle[:2], o_rows[:2])])
    corpus = sum((o.output_ids + [0] for o in oracle[:2]), [])
    eng = BatchedFusedHybridEagleEngine(cfg, params, hy, net_params=net,
                                        corpus=corpus, **kw)
    torch.cuda.synchronize()
    with FusedSteps(eng, fh) as rec:
        reset_counts()                          # the path starts here
        outs, wall, steps = serve_batched(eng, requests, V)
        counts = read_counts()                  # the path ends here
    cases = [(str(i), p, rec.outputs(i, o), r, rec.per_rid[i]["chains"], rr,
              rec.per_rid[i]["rows"])
             for i, ((p, _), o, r, rr) in enumerate(zip(requests, outs,
                                                        oracle, o_rows))]
    key = "phase14_llama_1b_dense_eagle_hybrid_b4"
    verdicts = judge_all(card, label, cases, cfg, params, bnoise, key)
    tree_depths(label, card, rec)
    n_equal = sum(v.startswith("equal") for v in verdicts)
    new_tok = sum(o.decode_tokens for o in outs)
    note(key, tokens_per_s=new_tok / wall, ms_per_step=wall / steps * 1e3,
         mean_accept=new_tok / eng.steps_total)
    print(f"{label}: {new_tok} new tokens, {steps} steps of [4, 24], "
          f"{wall / steps * 1e3:.3f} ms/step, {new_tok / wall:.2f} tok/s, "
          f"retrieval chains {eng.sam_steps_total} of {eng.steps_total} "
          f"slot-steps; {n_equal} equal to the chain oracle, "
          f"{len(outs) - n_equal} near-ties [{card}]", flush=True)
    want = {"flash_block_attention": L * len(requests),
            "flash_block_attention_int8kv": 0, "int4_matmul": 0,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want or not steps,
            f"{label}: launch counts {counts}, expected {want}")
    graph_rerun(card, label, key, [], lambda: serve_batched_loops(
        eng, requests, V), outs, counts)
    del eng, rec, cases
    gc.collect()

    # --engine eagle2_hybrid_batched over 127.0.0.1
    four = [p for p, _ in requests[:4]]
    args = SimpleNamespace(model=None, random_model=True, tiny=False,
                           engine="eagle2_hybrid_batched", batch_size=4,
                           quantize=None, max_cache_len=1024, sam=None,
                           cpu=False, inline_prefill=False)
    eng = build_server_engine(args)
    direct, _, _ = serve_batched(eng, [(p, 32) for p in four], V)
    server, sched = serve_http(eng, port=0, block=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        reset_counts()                          # the path starts here
        replies = http_traffic(url, [{"input_ids": p, "max_new_tokens": 32}
                                     for p in four], "eagle2_hybrid_batched")
        counts = read_counts()                  # the path ends here
    finally:
        server.shutdown()
        sched.close()
    fail_if([r["output_ids"] for r in replies]
            != [o.output_ids for o in direct],
            "server --engine eagle2_hybrid_batched: replies differ from the "
            "engine called directly")
    fail_if(counts["flash_block_attention"] != L * len(four),
            f"server --engine eagle2_hybrid_batched: launch counts {counts}")
    print(f"server --engine eagle2_hybrid_batched: 4 greedy replies over "
          f"HTTP equal to the engine called directly; launches {counts} "
          f"[{card}]", flush=True)
    del eng, params, net
    gc.collect()


# the HF widths of the repo's llama_1b (TinyLlama 1.1B), eos 2 as its own
LLAMA_1B_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
               "vocab_size": 32000, "hidden_size": 2048,
               "intermediate_size": 5632, "num_hidden_layers": 22,
               "num_attention_heads": 32, "num_key_value_heads": 4,
               "head_dim": 64, "max_position_embeddings": 2048,
               "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
               "rope_scaling": None, "tie_word_embeddings": False,
               "torch_dtype": "bfloat16", "bos_token_id": 1,
               "eos_token_id": 2}
ROOT = os.path.dirname(os.path.abspath(__file__))


def write_safetensors(path: str, named: list) -> int:
    """Write (name, bf16 tensor) pairs as one safetensors file: an 8-byte
    little-endian header length, the JSON header padded to 8 bytes, the
    raw bytes; returns the bytes of tensor data."""
    import torch

    header, offset = {}, 0
    for name, t in named:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in named:
            t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy() \
                .tofile(f)
    return offset


def hf_state(params, cfg) -> list:
    """The port's llama parameters as HF's (name, [out, in] tensor)
    pairs, in HF's order."""
    out = [("model.embed_tokens.weight", params["embed"])]
    lay = params["layers"]
    proj = (("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
            ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
            ("mlp.gate_proj", "w_gate"), ("mlp.up_proj", "w_up"),
            ("mlp.down_proj", "w_down"))
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        out.append((p + "input_layernorm.weight", lay["attn_norm"][i]))
        out.append((p + "post_attention_layernorm.weight",
                    lay["mlp_norm"][i]))
        out += [(f"{p}{hf}.weight", lay[key][i].T) for hf, key in proj]
    out.append(("model.norm.weight", params["final_norm"]))
    out.append(("lm_head.weight", params["lm_head"].T))
    return out


def write_hf_dir(d: str, params, cfg) -> float:
    """An HF directory of ``params``: config.json, two shards and
    model.safetensors.index.json; returns the GB written."""
    named = hf_state(params, cfg)
    half = len(named) // 2
    shards = {"model-00001-of-00002.safetensors": named[:half],
              "model-00002-of-00002.safetensors": named[half:]}
    total = 0
    weight_map = {}
    for fname, part in shards.items():
        total += write_safetensors(os.path.join(d, fname), part)
        weight_map.update({name: fname for name, _ in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(LLAMA_1B_HF, f)
    return total / 1e9


def same_tree(label, got, want) -> None:
    """Fail unless two parameter trees hold the same leaves bit for bit."""
    import torch

    from samd_tpu_torch.ops.quant import tensors

    def flat(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from flat(tree[k], prefix + k + ".")
            else:
                yield prefix + k, tree[k]

    g, w = dict(flat(got)), dict(flat(want))
    fail_if(g.keys() != w.keys(), f"{label}: leaves {sorted(g)} against "
            f"{sorted(w)}")
    for k in g:
        fail_if(type(g[k]) is not type(w[k]), f"{label}: {k} kind differs")
        for a, b in zip(tensors(g[k]), tensors(w[k])):
            fail_if(a.dtype != b.dtype or a.shape != b.shape
                    or not torch.equal(a.view(torch.uint8) if
                                       a.element_size() == 1 else a,
                                       b.view(torch.uint8) if
                                       b.element_size() == 1 else b),
                    f"{label}: {k} differs")


def cli_session(model_dir: str, flags: list, turns: list, save: str):
    """Drive ``python3 -m samd_tpu_torch.cli --model DIR`` with stdin
    piped: two turns, ``!!regen``, ``!!save``, ``!!reset``, ``!!load``,
    a third turn, ``!!exit``; returns (the four replies, stderr, wall s)."""
    script = (" ".join(map(str, turns[0])) + "\n"
              + " ".join(map(str, turns[1])) + "\n!!regen\n"
              f"!!save {save}\n!!reset\n!!load {save}\n"
              + " ".join(map(str, turns[2])) + "\n!!exit\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "samd_tpu_torch.cli", "--model", model_dir,
         "--max-new-tokens", "48", "--max-cache-len", "1024", *flags],
        input=script, capture_output=True, text=True, timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    fail_if(r.returncode != 0, f"cli {flags}: exit {r.returncode}: "
            f"{r.stderr[-3000:]}")
    replies = [[int(t) for t in ln.split("ASSISTANT>")[1].split("USER>")[0]
                .split()] for ln in r.stdout.splitlines()
               if "ASSISTANT>" in ln]
    fail_if(len(replies) != 4, f"cli {flags}: {len(replies)} replies, "
            f"expected 4: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    return replies, r.stderr, wall


def main_path_1b_disk(card: str, d: str):
    """Phase 15: llama_1b from an HF directory on disk through the loader,
    the checkpoint format, the CLI and the server; returns the loaded
    (cfg, params) for phase 16."""
    import torch

    from samd_tpu_torch import cli
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.models import init_params, llama_1b
    from samd_tpu_torch.models.checkpoint import load_params, save_params
    from samd_tpu_torch.models.loader import load_llama
    from samd_tpu_torch.ops.quant import INT4, quantize_llama_params
    from samd_tpu_torch.server import build_server_engine

    # (a) write the directory
    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    written = init_params(cfg, gen_w, scale=0.02, device="cuda")
    model_dir = os.path.join(d, "llama_1b_hf")
    os.makedirs(model_dir)
    t0 = time.perf_counter()
    gb = write_hf_dir(model_dir, written, cfg)
    t_write = time.perf_counter() - t0
    # (b) load it
    t0 = time.perf_counter()
    lcfg, params = load_llama(model_dir, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    fail_if(lcfg != cfg, f"load_llama: config {lcfg} against {cfg}")
    same_tree("load_llama", params, written)
    del written
    print(f"llama_1b HF directory: {gb:.3f} GB of bf16 in two safetensors "
          f"shards written in {t_write:.2f} s, loaded by load_llama in "
          f"{t_load:.2f} s, every leaf bitwise equal to what was written "
          f"[{card}]", flush=True)
    # (c) the port's checkpoint format, plain and int4
    for label, tree in (("plain", params),
                        ("int4", quantize_llama_params(params, dtype=INT4))):
        path = os.path.join(d, f"ckpt_{label}")
        t0 = time.perf_counter()
        save_params(path, tree, lcfg)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        ccfg, back = load_params(path, device="cuda")
        torch.cuda.synchronize()
        t_back = time.perf_counter() - t0
        fail_if(ccfg != lcfg, f"checkpoint {label}: config differs")
        same_tree(f"checkpoint {label}", back, tree)
        print(f"checkpoint round trip ({label}): saved in {t_save:.2f} s, "
              f"loaded in {t_back:.2f} s, bitwise equal [{card}]",
              flush=True)
        del back, tree
        shutil.rmtree(path)
        gc.collect()

    # (d) the CLI, as a subprocess, against the same engine in process;
    # the three sessions and (e)'s server start together
    import socket
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(151)
    V = cfg.vocab_size
    turns = [rng.integers(3, V, size=n).tolist() for n in (64, 32, 24)]
    gen = GenerationConfig(max_new_tokens=48, max_cache_len=1024)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t_server = time.perf_counter()
    log_path = os.path.join(d, "server.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "samd_tpu_torch.server", "--model", model_dir,
         "--engine", "paged_fused_sam", "--batch-size", "4",
         "--max-cache-len", "1024", "--port", str(port)],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        flag_sets = (["--engine", "fused_sam"],
                     ["--engine", "fused_sam", "--quantize", "int4",
                      "--kv-quant"],
                     ["--engine", "samd"])
        pool = ThreadPoolExecutor(len(flag_sets))
        sessions = [pool.submit(cli_session, model_dir, flags, turns,
                                os.path.join(d, f"conversation{i}.json"))
                    for i, flags in enumerate(flag_sets)]
        pool.shutdown(wait=False)
        for i, (flags, session) in enumerate(zip(flag_sets, sessions)):
            label = "cli " + " ".join(flags)
            save = os.path.join(d, f"conversation{i}.json")
            replies, err, wall = session.result()
            fail_if(replies[1] != replies[2], f"{label}: !!regen gave "
                    "another reply")
            fail_if("loaded 2 turns" not in err or "holds no tokenizer"
                    not in err, f"{label}: stderr {err[-2000:]}")
            with open(save) as f:
                fail_if(json.load(f) != [[turns[0], replies[0]],
                                         [turns[1], replies[1]]],
                        f"{label}: the saved conversation differs")
            args = cli.parse_args(["--model", model_dir, "--max-new-tokens",
                                   "48", "--max-cache-len", "1024", *flags])
            engine, _, eos = cli.build_engine(args)
            fail_if(eos != 2, f"{label}: end token {eos}, config.json says 2")
            M = engine.samd_cfg.max_predicts if flags[1] == "samd" \
                else engine.cfg.block
            oracle = ArBaseline(engine.model_cfg, engine.params,
                                max_cache_len=1024, eos_token_id=eos,
                                block_size=M)
            second = turns[0] + replies[0] + turns[1]
            prompts = [turns[0], second, second + replies[1] + turns[2]]
            want = [replies[0], replies[1], replies[3]]
            reset_counts()                          # the path starts here
            t0 = time.perf_counter()
            outs = [engine.generate(p, gen) for p in prompts]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()                  # the path ends here
            refs = [oracle.generate(p, gen) for p in prompts]
            for i, (p, o, r, w) in enumerate(zip(prompts, outs, refs, want)):
                fail_if(o.output_ids[len(p):] != w, f"{label} turn {i}: the "
                        "CLI's reply differs from the engine's generate")
                fail_if(o.output_ids != r.output_ids, f"{label} turn {i}: "
                        f"differs from ArBaseline(block_size={M})")
            steps = sum(o.decode_steps for o in outs)
            note("phase15_" + "_".join(f.strip("-").replace("-", "_")
                                       for f in flags),
                 ms_per_step=dt / steps * 1e3,
                 tokens_per_s=sum(o.decode_tokens for o in outs) / dt,
                 mean_accept=sum(o.decode_tokens for o in outs) / steps,
                 equal_to_oracle=f"{len(outs)}/{len(prompts)}")
            print(f"{label}: 4 replies (regen equal, save/load round trip) in "
                  f"{wall:.2f} s of subprocess; the same engine in process "
                  f"{steps} steps, {dt / steps * 1e3:.3f} ms/step, each reply "
                  f"equal to it and to ArBaseline(block_size={M}) bit for "
                  "bit; "
                  f"launches {counts} [{card}]", flush=True)
            want_k = ("flash_block_attention_int8kv", "int4_matmul") \
                if "--quantize" in flags else ("flash_block_attention",)
            fail_if(any(counts[k] == 0 for k in want_k),
                    f"{label}: launch counts {counts}")
            del engine, oracle, outs, refs
            gc.collect()
            torch.cuda.empty_cache()

        # (e) the server, as a subprocess, against the engine called directly
        four = [rng.integers(3, V, size=int(n)).tolist()
                for n in rng.integers(40, 101, size=4)]
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                with open(log_path) as f:
                    raise SystemExit(f"server --model: exited "
                                     f"{proc.returncode}: {f.read()[-3000:]}")
            fail_if(time.monotonic() > deadline, "server --model: no "
                    "/health within 300 s")
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
        t_up = time.perf_counter() - t_server
        replies = http_traffic(url, [{"input_ids": p, "max_new_tokens": 32}
                                     for p in four], "--model")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    args = SimpleNamespace(model=model_dir, random_model=False, tiny=False,
                           engine="paged_fused_sam", batch_size=4,
                           quantize=None, max_cache_len=1024, sam=None,
                           cpu=False, inline_prefill=False)
    eng = build_server_engine(args)
    fail_if(eng.eos_token_id != 2, "server --model: end token "
            f"{eng.eos_token_id}, config.json says 2")
    reset_counts()                              # the path starts here
    ids = [eng.add_request(p, GenerationConfig(max_new_tokens=32,
                                               max_cache_len=1024))
           for p in four]
    res = eng.run()
    torch.cuda.synchronize()
    counts = read_counts()                      # the path ends here
    direct = [res[i].output_ids for i in ids]
    fail_if([r["output_ids"] for r in replies] != direct,
            "server --model: replies differ from the engine called directly")
    fail_if(any(not 0 <= t < V for o in direct for t in o),
            "server --model: token ids outside the vocabulary")
    fail_if(counts["paged_block_attention"] == 0,
            f"server --model: launch counts {counts}")
    print(f"server --model --engine paged_fused_sam: up in {t_up:.2f} s, 4 "
          f"greedy replies over HTTP equal to the engine called directly; "
          f"launches {counts} [{card}]", flush=True)
    note("phase15_server_model", up_seconds=t_up,
         equal_to_direct=f"{len(replies)}/{len(four)}")
    del eng
    gc.collect()
    return lcfg, params


class PathProbe:
    """Inside the block, functions of ``models.llama`` that ``forward``
    looks up are each wrapped once; the wrappers launch no counted kernel.

    - The verify attention (``flash_block_attention``), while ``capture``
      is set, keeps the inputs and the output of its 1st, 2nd, 4th, 8th,
      ... call at each shape, so that after the path every shape it gave
      the kernel, over cache lengths from the first step to late ones, is
      held against the plain version (``hold``).
    - With ``experts``, ``moe_route`` adds each expert's selections over
      every row to ``selected``, and while ``timing`` is set, CUDA events
      are recorded around each call of ``_moe_mlp``, ``_expert_stack``
      (a stack's dequantization), ``int4_matmul`` (K3) and the verify
      attention, kept per function in ``spans``."""

    TIMED = ("_moe_mlp", "_expert_stack", "int4_matmul",
             "flash_block_attention")

    def __init__(self, experts: int = 0, capture: bool = True):
        self.calls = {}     # (q shape, k shape, dtype, int8) -> calls
        self.kept = []      # (key, arguments, the path's output)
        self.capture, self.timing, self.experts = capture, False, experts
        self.spans = {n: [] for n in self.TIMED}
        if experts:
            import torch

            self.selected = torch.zeros(experts, dtype=torch.int64,
                                        device="cuda")

    def __enter__(self):
        import samd_tpu_torch.models.llama as llama

        names = ["flash_block_attention"]
        if self.experts:
            names += ["moe_route", "_moe_mlp", "_expert_stack",
                      "int4_matmul"]
        self._orig = {n: getattr(llama, n) for n in names}
        for n, fn in self._orig.items():
            setattr(llama, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import samd_tpu_torch.models.llama as llama

        for n, fn in self._orig.items():
            setattr(llama, n, fn)

    def _wrap(self, name, fn):
        import torch

        def call(*args, **kw):
            if not (self.timing and name in self.TIMED):
                out = fn(*args, **kw)
            else:
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = fn(*args, **kw)
                ev[1].record()
                self.spans[name].append(ev)
            if name == "moe_route":
                self.selected += (out > 0).sum(dim=(0, 1))
            elif name == "flash_block_attention" and self.capture:
                self._keep(args, out)
            return out
        return call

    def _keep(self, args, out):
        key = (tuple(args[0].shape), tuple(args[1].shape),
               str(args[0].dtype).split(".")[1],
               len(args) > 5 and args[5] is not None)
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if n & (n - 1) == 0:
            self.kept.append((key, [a.clone() if a is not None else None
                                    for a in args], out.clone()))

    def hold(self, card: str, label: str) -> dict:
        """Fail unless every kept output is finite and within
        ``kernel_tolerance`` of the plain version on its inputs; returns
        the largest error per kernel row."""
        import torch

        from samd_tpu_torch.ops.flash_attention import (
            flash_block_attention_ref, kernel_tolerance)

        fail_if(not self.kept, f"{label}: the verify attention was never "
                "called")
        worst = {}
        for key, args, out in self.kept:
            ref = flash_block_attention_ref(*args)
            err, _ = check_close(f"{label} q {key[0]} k {key[1]} {key[2]}",
                                 out, ref, kernel_tolerance(ref))
            name = ("flash_block_attention_int8kv" if key[3]
                    else "flash_block_attention")
            worst[name] = max(worst.get(name, 0.0), err)
        torch.cuda.synchronize()
        shapes = ", ".join(f"T {q[1]} S {k[2]} D {q[3]} {dt}"
                           f"{' int8' if i8 else ''} x{n}"
                           for (q, k, dt, i8), n in sorted(
                               self.calls.items()))
        print(f"{label}: the path's verify attention at {len(self.calls)} "
              f"shapes ({shapes}); {len(self.kept)} of its "
              f"{sum(self.calls.values())} outputs held against the plain "
              f"version, max_abs_err {worst} [{card}]", flush=True)
        return worst


def main_path_training(card: str, cfg, params) -> dict:
    """Phase 16: the accept demo, the Spec-Bench demo and full-width EAGLE
    distillation on the card; each part's verify-attention outputs held
    against the plain version (``PathProbe``).  Returns the
    largest error per kernel row."""
    import torch

    from samd_tpu_torch.evaluation import accept_demo, specbench_demo
    from samd_tpu_torch.training import markov_corpus, train_eagle

    # (a) the accept demo at the reference bench's sizes
    worst = {}

    def hold(cap, label):
        for name, err in cap.hold(card, label).items():
            worst[name] = max(worst.get(name, 0.0), err)

    reset_counts()                              # the path starts here
    t0 = time.perf_counter()
    with PathProbe() as cap:
        demo = accept_demo.run(steps=400, vocab=64, new_tokens=48)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()                      # the path ends here
    hold(cap, "accept demo")
    acc = demo["accept"]
    ref = demo["reference_targets"]
    print(f"accept demo ({dt:.1f} s): LM loss {demo['lm_loss_first']} -> "
          f"{demo['lm_loss']}, distill loss {demo['eagle_loss']}; mean "
          f"accept: EAGLE-2 trained {acc['eagle2_trained']} (random net "
          f"{acc['eagle2_random_net']}; the reference's published "
          f"{ref['eagle2_mean_accept']}), batched "
          f"{acc['eagle2_trained_batched']}, SAM[EAGLE-2] "
          f"{acc['sam_eagle2_trained']}, Token Recycle "
          f"order-1 {acc['token_recycle_trained_order1']} (the reference's "
          f"{ref['token_recycle_mean_accept']}), order-2 "
          f"{acc['token_recycle_trained']}, sam_only corpus "
          f"{acc['sam_only_trained']}, dynamic {acc['sam_only_dyn_trained']}"
          f"; launches {counts} [{card}]", flush=True)
    fail_if(not demo["lm_loss"] < 0.5 * demo["lm_loss_first"],
            f"accept demo: LM loss {demo['lm_loss_first']} -> "
            f"{demo['lm_loss']}, not below half")
    fail_if(not acc["eagle2_trained"] > acc["eagle2_random_net"],
            "accept demo: the trained EAGLE-2 net accepts no more than the "
            "random one")
    fail_if(counts["flash_block_attention"] == 0,
            f"accept demo: launch counts {counts}")
    note("phase16_accept_demo", seconds=dt, **{
        f"mean_accept_{k}": v for k, v in acc.items()})

    # (b) the Spec-Bench pipeline
    reset_counts()                              # the path starts here
    t0 = time.perf_counter()
    with PathProbe() as cap:
        sb = specbench_demo.run(steps=300, vocab=64, per_task=2,
                                new_tokens=64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()                      # the path ends here
    hold(cap, "spec-bench")
    for name, row in sb["engines"].items():
        print(f"spec-bench {name}: speedup {row['speedup']}, mean accept "
              f"{row['mean_accept']}, {row['tokens_per_s']} tok/s "
              f"(baseline {sb['baseline_tokens_per_s']}), equal to its "
              f"block oracle {row['outputs_equal_vs_block_oracle']}, errors "
              f"{row['errors']} [{card}]", flush=True)
        fail_if(not row["outputs_equal_vs_block_oracle"] or row["errors"],
                f"spec-bench {name}: mismatches {row['mismatch_qids']}, "
                f"errors {row['errors']}")
        note(f"phase16_specbench_{name}", speedup=row["speedup"],
             mean_accept=row["mean_accept"],
             tokens_per_s=row["tokens_per_s"],
             equal_to_oracle=f"{sb['n_questions'] - len(row['mismatch_qids'])}"
                             f"/{sb['n_questions']}")
    print(f"spec-bench pipeline: {sb['n_questions']} questions, LM loss "
          f"{sb['lm_loss']}, {dt:.1f} s; launches {counts} [{card}]",
          flush=True)
    fail_if(counts["flash_block_attention"] == 0,
            f"spec-bench: launch counts {counts}")

    # (c) EAGLE distillation against the full-width llama_1b
    corpus = markov_corpus(cfg.vocab_size, 20000, seed=0)
    losses, times, bad = [], [], []

    def on_step(i, loss, leaves):
        times.append(time.perf_counter())
        losses.append(loss)
        bad.extend(j for j, t in enumerate(leaves)
                   if t.grad is None or not torch.isfinite(t.grad).all())

    reset_counts()                              # the path starts here
    t0 = time.perf_counter()
    with PathProbe() as cap:
        net, _ = train_eagle(cfg, params, corpus, steps=30, batch=8,
                             seq_len=64, lr=5e-4, seed=0, on_step=on_step)
    torch.cuda.synchronize()
    counts = read_counts()                      # the path ends here
    if cap.calls:
        hold(cap, "train_eagle")
    per_step = np.diff([t0] + times) * 1e3
    n_params = sum(t.numel() for t in net.values())
    print(f"train_eagle llama_1b (bf16, a {n_params / 1e6:.1f}M-parameter "
          f"net, batch 8 x 64): losses {[round(x, 4) for x in losses]}; "
          f"{np.median(per_step[1:]):.3f} ms/step median (first step "
          f"{per_step[0]:.3f}); launches {counts} [{card}]", flush=True)
    note("phase16_train_eagle", ms_per_step=float(np.median(per_step[1:])),
         loss_first=losses[0], loss_last=losses[-1])
    fail_if(not losses[-1] < losses[0], f"train_eagle: loss {losses[0]} -> "
            f"{losses[-1]}")
    fail_if(bool(bad), f"train_eagle: parameters {sorted(set(bad))} without "
            "a finite gradient")
    del net
    return worst


def mixtral_int4_params():
    """mixtral_8x7b at full width in the single-card serving form: each
    layer's bf16 leaves drawn on the card from a generator seeded 0 with
    ``init_params``'s distribution (normal · 0.02, norms ones), quantized
    to packed int4 with ``quantize_weight4`` as ``quantize_llama_params``
    does (the expert stacks per [E, in, out] along -2; router and norms
    bf16), and freed before the next layer, so the 93 GB bf16 tree never
    exists.  The embed stays bf16, the head is int4."""
    import torch

    from samd_tpu_torch.models import mixtral_8x7b
    from samd_tpu_torch.ops.quant import (Int4Tensor, quantize_weight4,
                                          quantized_bytes)

    cfg = mixtral_8x7b()
    fail_if(cfg.int4_impl != "kernel" or cfg.attention_impl != "flash",
            "mixtral_8x7b: the kernels are not the default routes")
    t0 = time.perf_counter()
    L, H, I, E = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_experts)
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def norm(*shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device="cuda")
        return (x * 0.02).to(cfg.dtype)

    shapes = {"wq": (H, NH * D), "wk": (H, KH * D), "wv": (H, KH * D),
              "wo": (NH * D, H), "w_gate": (E, H, I), "w_up": (E, H, I),
              "w_down": (E, I, H)}
    layers = {n: Int4Tensor(
        torch.empty((L, *s[:-1], s[-1] // 2), dtype=torch.uint8,
                    device="cuda"),
        torch.empty((L, *s[:-2], s[-1]), dtype=torch.float32,
                    device="cuda")) for n, s in shapes.items()}
    router = torch.empty((L, H, E), dtype=cfg.dtype, device="cuda")
    for l in range(L):
        for n, s in shapes.items():
            w = norm(*s)
            q = quantize_weight4(w)
            layers[n].packed[l].copy_(q.packed)
            layers[n].scale[l].copy_(q.scale)
            del w, q
        router[l] = norm(H, E)
    ones = torch.ones((L, H), dtype=cfg.dtype, device="cuda")
    params = {"embed": norm(cfg.vocab_size, H),
              "layers": {**layers, "router": router, "attn_norm": ones,
                         "mlp_norm": ones.clone()},
              "final_norm": torch.ones(H, dtype=cfg.dtype, device="cuda"),
              "lm_head": quantize_weight4(norm(H, cfg.vocab_size))}
    torch.cuda.synchronize()
    gb = quantized_bytes(params) / 1e9
    experts = sum(quantized_bytes(layers[n])
                  for n in ("w_gate", "w_up", "w_down")) / 1e9
    print(f"mixtral_8x7b weights: drawn layer by layer on the card and "
          f"quantized to packed int4 in {time.perf_counter() - t0:.1f} s; "
          f"{gb:.3f} GB ({experts:.3f} GB of expert stacks); peak "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"[{nvidia_smi()}]", flush=True)
    fail_if(not 23.0 < gb < 24.2, f"mixtral_8x7b: {gb:.3f} GB of weights, "
            "expected about 23.6")
    return cfg, params


def mixtral_forward_split(card, cfg, params, probe, cache_len, S, T=16
                          ) -> None:
    """Device time of one forward of the engine's block (T rows at
    cache_len over an int8 cache of S slots) by CUDA events, split into
    the expert side (each layer's MoE MLP: the stacks' dequantization
    plus the products, routing and combine) and the rest (K3 on
    wq/wk/wv/wo and the head, the int8-mode attention, norms, rope);
    median of three after a warm-up.  Beside it the bytes bound: every
    weight read once (of the bf16 embed table only the T rows looked up),
    the live int8 KV prefix read and the T new rows written (values and
    f32 scales), the f32 logits written, over HBM_BYTES_PER_S."""
    import torch

    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.models import block_decode_mask, forward
    from samd_tpu_torch.ops.quant import quantized_bytes

    L, H, KH, D = (cfg.num_layers, cfg.hidden_size, cfg.num_kv_heads,
                   cfg.head_dim)
    embed = params["embed"]
    moved = (quantized_bytes(params)
             - embed.numel() * embed.element_size()
             + T * H * embed.element_size()
             + (cache_len + T) * L * 2 * KH * (D + 4)
             + T * cfg.vocab_size * 4)
    kv = init_kv_cache(cfg, 1, S, "cuda")
    toks = torch.randint(3, cfg.vocab_size, (1, T), device="cuda")
    pos = torch.arange(cache_len, cache_len + T, device="cuda")[None]
    tree = torch.tril(torch.ones((T, T), dtype=torch.bool, device="cuda"))
    mask = block_decode_mask(tree, cache_len, S)
    off = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
    logs = [probe.spans[n] for n in probe.TIMED]
    rows = []
    for i in range(4):
        for log in logs:
            log.clear()
        probe.timing = True
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        forward(params, cfg, toks, pos, *kv, off, mask)
        ev[1].record()
        probe.timing = False
        torch.cuda.synchronize()
        rows.append([ev[0].elapsed_time(ev[1])] + [
            sum(a.elapsed_time(b) for a, b in log) for log in logs])
    total, moe, deq, k3, attn = sorted(rows[1:])[1]
    pairs = [len(log) for log in logs]
    fail_if(pairs != [L, 3 * L, 4 * L + 1, L],
            f"mixtral split: event pairs {pairs}")
    print(f"mixtral_8x7b forward device split (T {T}, cache_len "
          f"{cache_len}, int8 KV over {S} slots, median of 3 by CUDA "
          f"events): total {total:.3f} ms; expert side {moe:.3f} ms "
          f"({moe / total:.1%}: dequantization {deq:.3f} ms, products, "
          f"routing and combine {moe - deq:.3f} ms); attention side "
          f"{k3 + attn:.3f} ms (K3 on wq/wk/wv/wo and the head {k3:.3f} ms "
          f"in {4 * L + 1} calls, the int8-mode attention {attn:.3f} ms in "
          f"{L}, {attn / total:.1%} of the forward); the rest (embed, "
          f"norms, rope, the int8 KV writes) {total - moe - k3 - attn:.3f} "
          f"ms; the bytes bound {moved / 1e9:.3f} GB / "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{moved / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]", flush=True)


def main_path_mixtral(card: str) -> None:
    """Phase 17: mixtral_8x7b at full width, int4 weights and int8 KV,
    through FusedSamEngine against ArBaseline(block_size=16)."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
    from samd_tpu_torch.models import param_count
    from samd_tpu_torch.ops.quant import dequant, unpack4

    torch.cuda.reset_peak_memory_stats()
    cfg, params = mixtral_int4_params()
    cfg = dataclasses.replace(cfg, kv_quant=True)
    print(f"param_count: mixtral_8x7b int4 {param_count(params)}",
          flush=True)
    note("phase17_mixtral_8x7b_int4", param_count=param_count(params))
    fc = FusedSamConfig(n_predicts=15, corpus_capacity=4096,
                        cache_buckets=(256, 384, 512, 768))
    M, S, new = fc.block, 1024, 64
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    rng = np.random.default_rng(7)       # phase 5's three prompts
    prompts = {
        "a_random_200": rng.integers(3, cfg.vocab_size, size=200).tolist(),
        "b_own_corpus": rng.integers(3, cfg.vocab_size, size=96).tolist(),
        "c_repetitive": rng.integers(3, cfg.vocab_size, size=8).tolist() * 12,
    }
    stack = params["layers"]["w_gate"].layer(0)

    def unpack4_form(i):
        return unpack4(stack.packed).to(cfg.dtype) \
            * stack.scale[:, None, :].to(cfg.dtype)

    fail_if(not torch.equal(dequant(stack, cfg.dtype), unpack4_form(0)),
            "mixtral_8x7b: dequant of layer 0's w_gate stack differs from "
            "unpack4's form")
    print(f"mixtral_8x7b dequant of one {list(stack.shape)} expert stack: "
          f"{cuda_ms(lambda i: dequant(stack, cfg.dtype), 5, 1):.3f} ms, "
          f"bitwise equal to unpack4's int32 form, "
          f"{cuda_ms(unpack4_form, 5, 1):.3f} ms [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    probe = PathProbe(cfg.num_experts, capture=False)
    with probe:
        oracle = ArBaseline(cfg, params, max_cache_len=S, eos_token_id=-1,
                            block_size=M)
        oracle.generate(prompts["c_repetitive"][:16],
                        GenerationConfig(max_new_tokens=2))    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = {name: oracle.generate(p, gen)
                for name, p in prompts.items()}
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        print(f"mixtral_8x7b oracle ArBaseline(block_size={M}): "
              f"{3 * new} tokens in {oracle_s:.1f} s, "
              f"{oracle_s / (3 * new) * 1e3:.1f} ms per token (one "
              f"forward each, prefills included) [{card}]", flush=True)
        corpus = []          # the oracle's own outputs (bench.py:1900-1906)
        for r in refs.values():
            corpus += r.output_ids + [0]
        engine = FusedSamEngine(cfg, params, fc, corpus=corpus,
                                max_cache_len=S, eos_token_id=-1)
        engine.generate(prompts["c_repetitive"][:16],
                        GenerationConfig(max_new_tokens=4))    # warm-up
        torch.cuda.synchronize()
        probe.selected.zero_()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                          # the path starts here
        probe.capture = True
        done = serve(card, "mixtral_8x7b int4 int8-KV",
                     {n: engine for n in prompts}, prompts, refs, gen,
                     cfg.vocab_size, "phase17_mixtral_8x7b_int4_fused_sam")
        probe.capture = False
        counts = read_counts()                  # the path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        selected = probe.selected.tolist()
        for cache_len, slots in ((200, 256), (700, 768)):
            mixtral_forward_split(card, cfg, params, probe, cache_len,
                                  slots)
    worst = probe.hold(card, "mixtral_8x7b path")
    forwards = sum(1 + steps for _, steps in done)
    short = sum(steps + (n <= 128) for n, steps in done)
    want = {"flash_block_attention": 0,
            "flash_block_attention_int8kv": cfg.num_layers * short,
            "int4_matmul": (4 * cfg.num_layers + 1) * forwards,
            "paged_block_attention": 0, "paged_block_attention_int8kv": 0}
    fail_if(counts != want or not counts["int4_matmul"]
            or not counts["flash_block_attention_int8kv"],
            f"mixtral_8x7b: launch counts {counts}, expected {want} (129 "
            "int4 launches per forward, 32 int8-KV verify launches per "
            "forward of T <= 128)")
    total = sum(selected)
    print(f"mixtral_8x7b path: int4_matmul launches {counts['int4_matmul']}"
          f" = {4 * cfg.num_layers + 1} x {forwards} forwards; int8-KV "
          f"verify launches {counts['flash_block_attention_int8kv']} = "
          f"{cfg.num_layers} x {short} forwards of T <= 128; experts "
          f"selected (rows x layers, top-2) {selected}, shares "
          f"{[round(c / total, 4) for c in selected]}; peak allocated while "
          f"serving {peak:.3f} GB; kept verify outputs {worst} [{card}]",
          flush=True)
    return worst


def main_path_tools(card: str, d: str) -> None:
    """Phase 18: item 15's corpus tooling on phase 15's llama_1b HF
    directory: gen_corpus, build_sam, the CLI over the corpus SAM, parity
    at corpus scale and the two-worker evaluation fan-out."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.evaluation import launch, parity
    from samd_tpu_torch.models.loader import load_llama
    from samd_tpu_torch.sam import load_sam
    from samd_tpu_torch.tools import build_sam, gen_corpus

    model_dir = os.path.join(d, "llama_1b_hf")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(3, 32000, size=n).tolist()
               for n in (40, 24, 56, 32)]
    instr = os.path.join(d, "instructions.jsonl")
    corpus = os.path.join(d, "corpus.jsonl")
    sam_path = os.path.join(d, "corpus_sam.npz")
    with open(instr, "w") as f:
        f.writelines(json.dumps({"tokens": p}) + "\n" for p in prompts)
    new = 32

    # (a) responses from the batched fused engine, greedy, batch 4
    t0 = time.perf_counter()
    reset_counts()
    gen_corpus.main(["--input", instr, "--output", corpus, "--model-dir",
                     model_dir, "--max-new-tokens", str(new),
                     "--max-cache-len", "1024", "--batch", "4",
                     "--temperature", "0", "--eos-token-id", "-1"])
    counts = read_counts()
    with open(corpus) as f:
        rows = [json.loads(ln)["tokens"] for ln in f if ln.strip()]
    fail_if([r[:len(p)] for r, p in zip(rows, prompts)] != prompts
            or [len(r) - len(p) for r, p in zip(rows, prompts)]
            != [new] * len(prompts), "gen_corpus: malformed rows")
    print(f"gen_corpus --model-dir: {len(rows)} token rows of {new} new "
          f"tokens at batch 4 in {time.perf_counter() - t0:.2f} s; launches "
          f"{counts} [{card}]", flush=True)

    # (b) the corpus SAM
    stats = build_sam.main(["--input", corpus, "--output", sam_path,
                            "--eos-token", "2"])
    sam = load_sam(sam_path)
    fail_if(len(sam.text) != sum(len(r) + 1 for r in rows)
            or sam.num_states != stats["states"],
            f"build_sam: {len(sam.text)} tokens, {sam.num_states} states "
            f"against {stats}")
    print(f"build_sam: {stats} -> {os.path.basename(sam_path)}", flush=True)

    # (c) the CLI's host engine drafting from that SAM
    prompt = prompts[0]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "samd_tpu_torch.cli", "--model", model_dir,
         "--engine", "samd", "--sam", sam_path, "--max-new-tokens", str(new),
         "--max-cache-len", "1024"],
        input=" ".join(map(str, prompt)) + "\n!!exit\n", capture_output=True,
        text=True, timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    fail_if(r.returncode != 0, f"cli --sam: exit {r.returncode}: "
            f"{r.stderr[-3000:]}")
    replies = [[int(t) for t in ln.split("ASSISTANT>")[1].split("USER>")[0]
                .split()] for ln in r.stdout.splitlines()
               if "ASSISTANT>" in ln]
    cfg, params = load_llama(model_dir, device="cuda")
    oracle = ArBaseline(cfg, params, max_cache_len=1024, eos_token_id=2,
                        block_size=60)
    ref = oracle.generate(prompt, GenerationConfig(max_new_tokens=new,
                                                   max_cache_len=1024))
    fail_if(replies != [ref.output_ids[len(prompt):]],
            f"cli --engine samd --sam: reply {replies} differs from "
            "ArBaseline(block_size=60)")
    print(f"cli --engine samd --sam: one reply of {len(replies[0])} tokens "
          f"in {wall:.2f} s of subprocess, equal to ArBaseline(block_size="
          f"60) bit for bit [{card}]", flush=True)
    del oracle, params

    # (d) retrieval parity over a 2^20-token corpus, on the card
    for extra in ([], ["--indexed"]):
        t0 = time.perf_counter()
        rep = parity.main(["--corpus-size", str(1 << 20), "--steps", "400",
                           *extra])
        mode = rep["mode"]
        fail_if(rep["device"] != "cuda" or rep["mean_match_delta_capped"] < 0
                or (mode == "windowed"
                    and rep["match_and_end_agreement"] != 1.0),
                f"parity {mode}: {rep}")
        print(f"parity {mode} over {rep['corpus_size']} tokens, "
              f"{rep['steps']} steps: match agreement "
              f"{rep['match_agreement']}, match and end "
              f"{rep['match_and_end_agreement']}, mean draft-length delta "
              f"{rep['mean_draft_len_delta']} in "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)

    # (e) two workers on the card, their merged answers against the engine
    # called in this process
    qfile = os.path.join(d, "questions.jsonl")
    out = os.path.join(d, "answers.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps({"question_id": i, "category": "tools",
                                 "turns": [p]}) + "\n"
                     for i, p in enumerate(prompts))
    argv = ["--question-file", qfile, "--out", out, "--engine", "sam_only",
            "--model-dir", model_dir, "--sam", sam_path, "--max-new-tokens",
            str(new), "--max-cache-len", "1024", "--eos-token-id", "2",
            "--warmup", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "samd_tpu_torch.evaluation.launch", *argv,
         "--num-workers", "2"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    wall = time.perf_counter() - t0
    fail_if(r.returncode != 0, f"launch: exit {r.returncode}: "
            f"{r.stderr[-3000:]}")
    report = json.loads(r.stdout.strip().splitlines()[-1])
    with open(out) as f:
        answers = [json.loads(ln) for ln in f if ln.strip()]
    fail_if([a["question_id"] for a in answers] != list(range(len(prompts))),
            f"launch: merged question ids "
            f"{[a['question_id'] for a in answers]}")
    engine = launch.build_engine(launch.parse_args(argv))
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=1024)
    reset_counts()
    outs = [engine.generate(p, gen) for p in prompts]
    torch.cuda.synchronize()
    counts = read_counts()
    for a, p, o in zip(answers, prompts, outs):
        fail_if(a["choices"][0]["turns"][0] != o.output_ids[len(p):],
                f"launch: question {a['question_id']}'s merged answer "
                "differs from the engine called in this process")
    steps = sum(o.decode_steps for o in outs)
    print(f"launch --num-workers 2: {len(answers)} merged answers in "
          f"{wall:.2f} s, sorted and each equal to the engine in this "
          f"process ({steps} steps, mean accept "
          f"{sum(o.decode_tokens for o in outs) / steps:.3f} from the "
          f"corpus SAM); worker tok/s {report['per_worker_tokens_per_s']}; "
          f"launches in process {counts} [{card}]", flush=True)
    note("phase18_launch_2_workers", seconds=wall,
         worker_tokens_per_s=report["per_worker_tokens_per_s"],
         mean_accept=sum(o.decode_tokens for o in outs) / steps,
         equal_to_oracle=f"{len(answers)}/{len(prompts)}")


# ----------------------------------------------------------------------
# Phase 19: the mesh (parallel/, SamdEngine(mesh=), int4_matmul_tp)
# ----------------------------------------------------------------------

MESH_NEW = 64           # new tokens per llama_7b request of phase 19
MESH_NEW_1B = 32        # per llama_1b request (its ranks' steps cost most)
MESH_M = 16             # the engines' block
MESH_ROUNDS = 7         # world-of-one timing rounds, unsharded and mesh


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_prompts(V: int) -> dict:
    """Phase 5's three prompts."""
    rng = np.random.default_rng(7)
    return {"a_random_200": rng.integers(3, V, size=200).tolist(),
            "b_own_corpus": rng.integers(3, V, size=96).tolist(),
            "c_repetitive": rng.integers(3, V, size=8).tolist() * 12}


def mesh_engine(cfg, params, corpus, mesh=None):
    """SamdEngine with the SAM drafter at M 16 (sam_only, the static
    corpus SAM's trees cut to one branch: chains), over 1024 bf16 KV
    slots, on ``mesh``."""
    from samd_tpu_torch.config import SamdConfig
    from samd_tpu_torch.drafters import make_drafter
    from samd_tpu_torch.engine import SamdEngine
    from samd_tpu_torch.sam import SamCursor, build_corpus_sam

    so = SamdConfig(draft_source="sam_only", max_predicts=MESH_M,
                    tree_topk=1)
    static = build_corpus_sam(corpus, eos_token=0, topk=1)
    return SamdEngine(cfg, params, so,
                      make_drafter(so, cfg.vocab_size,
                                   static_sam=SamCursor(static)),
                      max_cache_len=1024, eos_token_id=-1, mesh=mesh)


def timed_outputs(engine, prompts, new: int = MESH_NEW, warm: bool = True
                  ) -> tuple:
    """({name: output ids}, new tokens, wall s, decode steps) of ``new``
    new tokens per prompt, after a short warm-up request when ``warm``."""
    import torch

    from samd_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=new, max_cache_len=1024)
    if warm:
        engine.generate(prompts["c_repetitive"][:16],
                        GenerationConfig(max_new_tokens=8))
    torch.cuda.synchronize()
    outs, toks, steps = {}, 0, 0
    t0 = time.perf_counter()
    for name, p in prompts.items():
        o = engine.generate(p, gen)
        outs[name] = o.output_ids
        toks += o.decode_tokens
        steps += o.decode_steps
    torch.cuda.synchronize()
    return outs, toks, time.perf_counter() - t0, steps


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def mesh_world_of_one(card: str) -> dict:
    """Phase 19 (1): a world of one over NCCL, in this process: llama_7b
    int4 over bf16 KV in SamdEngine(mesh=make_mesh(1)) against the
    unsharded engine and ArBaseline(block_size=16) on the same mesh.
    Returns the unsharded outputs, which the tp-2 ranks must equal."""
    import torch
    import torch.distributed as dist

    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.parallel import make_mesh

    cfg, params = llama_7b_int4_params()
    cfg = dataclasses.replace(cfg, kv_quant=False)
    prompts = mesh_prompts(cfg.vocab_size)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        fail_if(mesh.device != torch.device("cuda", 0),
                f"world of one: the rank's device is {mesh.device}")
        oracle = ArBaseline(cfg, params, max_cache_len=1024,
                            eos_token_id=-1, block_size=MESH_M)
        refs = timed_outputs(oracle, prompts)[0]
        corpus = list(refs.values())
        plain_engine = mesh_engine(cfg, params, corpus)
        unsharded = timed_outputs(plain_engine, prompts)
        engine = mesh_engine(cfg, params, corpus, mesh)
        reset_counts()                          # the path starts here
        meshed = timed_outputs(engine, prompts)
        counts = read_counts()                  # the path ends here
        mesh_ar = timed_outputs(ArBaseline(
            cfg, params, max_cache_len=1024, eos_token_id=-1,
            block_size=MESH_M, mesh=mesh), prompts)[0]
        # the tok/s ratio: rounds of the two engines in turn, the one that
        # goes first alternating, each run the same requests
        ratios = [meshed[1] / meshed[2] / (unsharded[1] / unsharded[2])]
        for i in range(MESH_ROUNDS - 1):
            pair = {}
            for e in ((engine, plain_engine) if i % 2 == 0
                      else (plain_engine, engine)):
                pair[e is engine] = timed_outputs(e, prompts, warm=False)
            fail_if(any(o[0] != unsharded[0] for o in pair.values()),
                    "phase 19 world of one: a timing round's outputs differ")
            ratios.append(pair[True][1] / pair[True][2]
                          / (pair[False][1] / pair[False][2]))
    finally:
        dist.destroy_process_group()
    for name in prompts:
        for label, got in (("the unsharded engine", unsharded[0][name]),
                           ("the mesh engine", meshed[0][name]),
                           ("ArBaseline on the mesh", mesh_ar[name])):
            j = first_difference(got, refs[name])
            fail_if(j is not None, f"phase 19 world of one, {name}: "
                    f"{label} differs from ArBaseline(block_size=16) at {j}")
    fail_if(counts["int4_matmul"] == 0
            or counts["flash_block_attention"] == 0,
            f"phase 19 world of one: launch counts {counts}")
    tps = [n / w for _, n, w, _ in (unsharded, meshed)]
    mid, lo, hi = float(np.median(ratios)), min(ratios), max(ratios)
    note("phase19_world_of_one", unsharded_tokens_per_s=tps[0],
         mesh_tokens_per_s=tps[1], mesh_tokens_per_s_ratio_median=mid,
         unsharded_ms_per_step=unsharded[2] / unsharded[3] * 1e3,
         mesh_ms_per_step=meshed[2] / meshed[3] * 1e3,
         equal_to_oracle=f"{len(prompts)}/{len(prompts)}")
    verdict = ("the mesh is slower in every round" if hi < 1 else
               "the mesh is faster in every round" if lo > 1 else
               "unresolved: the rounds fall on both sides of 1")
    print(f"phase 19 world of one (NCCL, make_mesh(1)), llama_7b int4 bf16 "
          f"KV, SamdEngine sam_only chains M {MESH_M}: 3 requests of "
          f"{MESH_NEW} new tokens, each equal bit for bit to the unsharded "
          f"engine and to ArBaseline(block_size=16) unsharded and on the "
          f"mesh; first round: unsharded {unsharded[1]} tokens in "
          f"{unsharded[3]} steps, {tps[0]:.2f} tok/s, mesh {meshed[1]} "
          f"tokens in {meshed[3]} steps, {tps[1]:.2f} tok/s; tok/s ratio "
          f"mesh/unsharded over {len(ratios)} rounds: median {mid:.4f}, "
          f"min {lo:.4f}, max {hi:.4f} ({verdict}); rounds "
          f"{[round(r, 4) for r in ratios]}; launches {counts} [{card}]",
          flush=True)
    return {"prompts": prompts, "outputs": unsharded[0], "corpus": corpus}


def mesh_1b_references(card: str) -> dict:
    """Phase 19's llama_1b references, unsharded, in this process: the
    unsharded engine and ArBaseline(block_size=16) with its rows on phase
    5's prompts, the near-tie bound's noise, and the sequence-parallel
    case's 16 greedy tokens after a 300-token prompt with their logits."""
    import torch

    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.models import (block_decode_mask, forward,
                                       init_params, llama_1b, prefill_mask)

    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    prompts = mesh_prompts(cfg.vocab_size)
    oracle = ArBaseline(cfg, params, max_cache_len=1024, eos_token_id=-1,
                        block_size=MESH_M)
    gen = GenerationConfig(max_new_tokens=MESH_NEW_1B, max_cache_len=1024)
    oracle.generate(prompts["c_repetitive"][:16],
                    GenerationConfig(max_new_tokens=4))        # warm-up
    refs = {}
    for name, p in prompts.items():
        with AcceptRows("oracle") as rows:
            refs[name] = oracle.generate(p, gen).output_ids
        # the row of each generated token: the prefill's last row for the
        # first, then each step's
        refs[name + "/rows"] = [oracle._engine._prefill(p)[1].float()] \
            + rows.steps
    corpus = [refs[n] for n in prompts]
    unsharded = timed_outputs(mesh_engine(cfg, params, corpus), prompts,
                              MESH_NEW_1B)[0]
    for name in prompts:
        j = first_difference(unsharded[name], refs[name])
        fail_if(j is not None, f"phase 19 llama_1b, {name}: the unsharded "
                f"engine differs from ArBaseline(block_size=16) at {j}")
    noise = noise_spread(cfg, params, [
        (refs[n], len(prompts[n]), refs[n + "/rows"][1:]) for n in prompts],
        per_case=8)
    print(f"phase 19 llama_1b references: {noise_line(noise)} [{card}]",
          flush=True)
    # the sequence-parallel case: a 300-token prompt, 16 greedy steps
    sp_prompt = np.random.default_rng(19).integers(
        3, cfg.vocab_size, size=300).tolist()
    S, T0 = 512, 300
    kv_k, kv_v = init_kv_cache(cfg, 1, S, "cuda")
    toks = torch.tensor([sp_prompt], device="cuda")
    logits, _ = forward(params, cfg, toks, torch.arange(T0, device="cuda")
                        [None], kv_k, kv_v, 0, prefill_mask(1, T0, S, "cuda"))
    sp_rows = [logits[0, -1].float()]
    chain = torch.ones((1, 1), dtype=torch.bool, device="cuda")
    for step in range(16):
        cl = T0 + step
        tok = int(sp_rows[-1].argmax())
        lo, _ = forward(params, cfg, torch.tensor([[tok]], device="cuda"),
                        torch.tensor([[cl]], device="cuda"), kv_k, kv_v,
                        torch.tensor(cl, device="cuda"),
                        block_decode_mask(chain, cl, S))
        sp_rows.append(lo[0, 0].float())
    del kv_k, kv_v
    return {"cfg": cfg, "params": params, "prompts": prompts, "refs": refs,
            "noise": noise, "sp_prompt": sp_prompt,
            "sp_tokens": [int(r.argmax()) for r in sp_rows],
            "sp_rows": sp_rows}


def mesh_near_tie(label, cfg, params, noise, a, b, j, row, eng_gap) -> str:
    """The verdict on a first difference at ``j`` between a sharded run's
    ``a`` and the unsharded ``b``: ``near_tie_rule`` on the gaps a[j] -
    b[j] in the unsharded oracle's own logits ``row``, a plain prefill's
    over the shared prefix, and the sharded run's own (``eng_gap``);
    anything else fails."""
    fail_if(int(row.argmax()) != b[j],
            f"{label}: the recorded unsharded row does not choose its token")
    gap = float(row[a[j]] - row[b[j]])
    lg = plain_next_logits(cfg, params, a[:j])
    plain = float(lg[a[j]] - lg[b[j]])
    tau, why = near_tie_rule(noise.oracle, noise.plain, (gap, plain, eng_gap),
                             noise.spread, False)
    facts = (f"token {j} (sharded {a[j]}, unsharded {b[j]}): gap {gap:.5f} "
             f"in the unsharded oracle's logits, {plain:.5f} by a plain "
             f"prefill, {eng_gap:.5f} in the sharded run's own")
    fail_if(why is not None, f"{label}: not a near-tie (tau {tau:.5f}) at "
            f"{facts}: {why}")
    return f"near-tie (tau {tau:.5f}) at {facts}"


def main_path_mesh(card: str) -> dict:
    """Phase 19: the mesh.  Returns the ranks' launch counts."""
    import torch

    t0 = time.perf_counter()
    one = mesh_world_of_one(card)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref1 = mesh_1b_references(card)
    t2 = time.perf_counter()
    d = tempfile.mkdtemp(prefix=".smoke_mesh_", dir=ROOT)
    try:
        with open(os.path.join(d, "refs.json"), "w") as f:
            json.dump({"prompts": one["prompts"], "corpus7": one["corpus"],
                       "corpus1": [ref1["refs"][n] for n in ref1["prompts"]],
                       "refs1": {n: ref1["refs"][n] for n in ref1["prompts"]},
                       "sp_prompt": ref1["sp_prompt"],
                       "sp_tokens": ref1["sp_tokens"]}, f)
        gc.collect()
        torch.cuda.empty_cache()
        reports = run_mesh_ranks(d, card)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase 19 walls: world of one {t1 - t0:.1f} s, llama_1b "
          f"references {t2 - t1:.1f} s, the two ranks "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    cfg1, params1 = ref1["cfg"], ref1["params"]
    fail_if(any(r["embed_sum"] != float(params1["embed"].float().sum())
                for r in reports.values()),
            "phase 19: a rank drew other llama_1b weights")
    total, n_7b, n_1b, equal_1b = {}, 0, 0, 0
    for rank, r in sorted(reports.items()):
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v
        n_7b += len(r["a"])
        n_1b += len(r["b"])
        # (a) llama_7b int4 tp 2: bit for bit the unsharded engine
        for name, ids in r["a"].items():
            j = first_difference(ids, one["outputs"][name])
            fail_if(j is not None, f"phase 19 rank {rank} llama_7b tp 2, "
                    f"{name}: differs from the unsharded engine at {j}")
        # (b) llama_1b tp 2: the mesh oracle bit for bit; the unsharded
        # engine up to a near-tie
        for name, (ids, mesh_ar, eng_gap) in r["b"].items():
            j = first_difference(ids, mesh_ar)
            fail_if(j is not None, f"phase 19 rank {rank} llama_1b tp 2, "
                    f"{name}: differs from ArBaseline(block_size=16) on the "
                    f"mesh at {j}")
            b = ref1["refs"][name]
            j = first_difference(ids, b)
            verdict = "equal to the unsharded engine"
            equal_1b += j is None
            if j is not None:
                g = j - len(ref1["prompts"][name])
                verdict = mesh_near_tie(
                    f"phase 19 llama_1b tp 2 {name}", cfg1, params1,
                    ref1["noise"], ids, b, j,
                    ref1["refs"][name + "/rows"][g], eng_gap)
            print(f"phase 19 rank {rank} llama_1b tp 2 {name}: equal to "
                  f"ArBaseline(block_size=16) on the mesh; {verdict} "
                  f"[{card}]", flush=True)
        # (c) sequence parallel
        sp, (tokens, eng_gap) = ref1["sp_tokens"], r["c"]
        j = first_difference(tokens, sp)
        verdict = "equal to the unsharded forward's"
        if j is not None:
            prefix = ref1["sp_prompt"] + sp[:j]
            P = len(ref1["sp_prompt"])
            verdict = mesh_near_tie(
                "phase 19 sequence parallel", cfg1, params1, ref1["noise"],
                ref1["sp_prompt"] + tokens, prefix + [sp[j]], P + j,
                ref1["sp_rows"][j], eng_gap)
        print(f"phase 19 rank {rank} make_sp_forward (S 512 over 2 ranks, a "
              f"300-token prompt, 16 greedy steps): {verdict} [{card}]",
              flush=True)
    print(f"phase 19: the ranks' path launches {total} [{card}]",
          flush=True)
    note("phase19_tp2", llama_7b_equal_to_unsharded=f"{n_7b}/{n_7b}",
         llama_1b_equal_to_mesh_oracle=f"{n_1b}/{n_1b}",
         llama_1b_equal_to_unsharded=f"{equal_1b}/{n_1b}")
    return total


def run_mesh_ranks(d: str, card: str) -> dict:
    """Two ranks sharing the card over gloo, as two processes of this
    script (``--mesh-rank``); a rank that fails ends the other.  Returns
    each rank's report."""
    port = free_port()
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(port), d], cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    deadline = time.monotonic() + 700
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    reports = {}
    for r, p in enumerate(procs):
        with open(os.path.join(d, f"rank{r}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("{\"rank\""):
                reports.setdefault(r, {}).update(json.loads(line))
            elif line.strip():
                print(f"phase 19 rank {r}: {line} [{card}]", flush=True)
        fail_if(p.returncode != 0, f"phase 19: rank {r} exited "
                f"{p.returncode}")
    fail_if(sorted(reports) != [0, 1] or any("done" not in r
                                             for r in reports.values()),
            "phase 19: a rank reported nothing")
    return reports


def mesh_rank(rank: int, port: int, d: str) -> int:
    """One rank of phase 19's two (``--mesh-rank RANK PORT DIR``): over
    gloo with the other, on the one card; prints its results as JSON
    lines."""
    import torch

    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.models import (block_decode_mask, forward,
                                       init_params, llama_1b, prefill_mask)
    from samd_tpu_torch.ops.int4_matmul import (int4_matmul, int4_matmul_ref,
                                                int4_matmul_tp, int4_tp_slab,
                                                kernel_tolerance)
    from samd_tpu_torch.parallel import make_mesh, shard_kv
    from samd_tpu_torch.parallel.multihost import init_distributed
    from samd_tpu_torch.parallel.seq_parallel import (make_sp_forward,
                                                      shard_kv_seq)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()

    def report(**kw):
        print(json.dumps({"rank": rank, **kw}), flush=True)
        print(f"{sorted(kw)} reported at {time.perf_counter() - t0:.1f} s",
              flush=True)

    with open(os.path.join(d, "refs.json")) as f:
        refs = json.load(f)
    prompts = refs["prompts"]
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(2)
    print(f"{mesh} on {mesh.device}", flush=True)
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) llama_7b int4 at tp 2, JAX's placement: int4 whole on each rank
    cfg, params = llama_7b_int4_params()
    cfg = dataclasses.replace(cfg, kv_quant=False)
    eng = mesh_engine(cfg, params, refs["corpus7"], mesh)
    reset_counts()                              # the path starts here
    outs, n, wall, steps = timed_outputs(eng, prompts)
    c = read_counts()                           # the path ends here
    add(c)
    print(f"llama_7b int4 tp 2: {n} tokens in {steps} steps, {n / wall:.2f} "
          f"tok/s (two ranks on one card over gloo); launches {c}",
          flush=True)
    report(a=outs)
    # the collectives' share of one T 16 verify forward at cache_len 400
    S, cl, T = 1024, 400, 16
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    toks = torch.randint(3, cfg.vocab_size, (1, T), generator=g,
                         device="cuda")
    pos = torch.arange(cl, cl + T, device="cuda")[None]
    tri = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    mask = block_decode_mask(tri, cl, S)
    split = {}
    for timed in (False, True, False, True):
        mesh.stats.calls, mesh.stats.seconds = 0, 0.0
        mesh.stats.timed = timed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        forward(eng.params, cfg, toks, pos, eng.kv_k, eng.kv_v,
                torch.tensor(cl, device="cuda"), mask, mesh=mesh)
        end.record()
        torch.cuda.synchronize()
        split[timed] = (start.elapsed_time(end), mesh.stats.seconds * 1e3,
                        mesh.stats.calls)
    mesh.stats.timed = False
    ms, _, calls = split[False]
    ms_t, comm_ms, _ = split[True]
    print(f"llama_7b int4 tp 2, one T 16 forward at cache_len {cl}: "
          f"{ms:.3f} ms by CUDA events, {calls} collectives; with each "
          f"collective synchronized and timed {ms_t:.3f} ms, of which the "
          f"collectives {comm_ms:.3f} ms ({comm_ms / ms_t:.1%})", flush=True)
    report(split=[ms, ms_t, comm_ms, calls])
    # (d) int4_matmul_tp at w_gate, layer 0: each rank's slab
    w = params["layers"]["w_gate"]
    packed, scale = int4_tp_slab(mesh, w.packed[0], w.scale[0])
    errs = {}
    for R in (16, 192):
        gx = torch.Generator(device="cuda")
        gx.manual_seed(R)
        x = torch.randn((R, cfg.hidden_size), generator=gx,
                        device="cuda").to(torch.bfloat16)
        got = int4_matmul_tp(mesh, x, w.packed, w.scale, 0)
        own = int4_matmul(x, packed, scale)
        whole = int4_matmul(x, w.packed, w.scale, 0)
        ref = int4_matmul_ref(x, w.packed, w.scale, 0)
        own_ref = int4_matmul_ref(x, packed, scale)
        torch.cuda.synchronize()
        err_w = check_close(f"int4_matmul_tp R={R} gathered against K3 on "
                            "the whole weight", got, whole,
                            kernel_tolerance(x, w.packed, w.scale, 0, ref))[0]
        err_p = check_close(f"int4_matmul_tp R={R} gathered against the "
                            "plain version", got, ref,
                            kernel_tolerance(x, w.packed, w.scale, 0, ref))[0]
        err_o = check_close(f"int4_matmul_tp R={R} the rank's slab against "
                            "its plain version", own, own_ref,
                            kernel_tolerance(x, packed, scale, None,
                                             own_ref))[0]
        errs[R] = (err_w, err_p, err_o)
        print(f"int4_matmul_tp w_gate R={R} (slab out/2 "
              f"{packed.shape[-1]}): gathered within K3's bound of K3 on "
              f"the whole weight (max {err_w:.3e}) and of the plain version "
              f"({err_p:.3e}); the slab within its own ({err_o:.3e})",
              flush=True)
    report(d=errs)
    del eng, params, w, packed, scale
    gc.collect()
    torch.cuda.empty_cache()

    # (b) llama_1b bf16 at tp 2: row-parallel sums reordered
    cfg = llama_1b()
    gen_w = torch.Generator(device="cuda")
    gen_w.manual_seed(0)
    params = init_params(cfg, gen_w, scale=0.02, device="cuda")
    report(embed_sum=float(params["embed"].float().sum()))
    eng = mesh_engine(cfg, params, refs["corpus1"], mesh)
    reset_counts()                              # the path starts here
    outs = timed_outputs(eng, prompts, MESH_NEW_1B)[0]
    add(read_counts())                          # the path ends here
    oracle = ArBaseline(cfg, params, max_cache_len=1024, eos_token_id=-1,
                        block_size=MESH_M, mesh=mesh)
    mesh_ar = timed_outputs(oracle, prompts, MESH_NEW_1B)[0]
    b = {}
    for name, ids in outs.items():
        want = refs["refs1"][name]
        j = first_difference(ids, want)
        gap = None
        if j is not None:           # the sharded gap at the first difference
            S = -(-j // 64) * 64
            kv = shard_kv(*init_kv_cache(cfg, 1, S, "cuda"), mesh)
            lg, _ = forward(eng.params, cfg,
                            torch.tensor([ids[:j]], device="cuda"),
                            torch.arange(j, device="cuda")[None], *kv, 0,
                            prefill_mask(1, j, S, "cuda"), mesh=mesh)
            gap = float(lg[0, -1, ids[j]] - lg[0, -1, want[j]])
        b[name] = (ids, mesh_ar[name], gap)
    report(b=b)
    # (c) make_sp_forward: S 512 over the two ranks
    sp = make_sp_forward(cfg, mesh)
    S, T0 = 512, len(refs["sp_prompt"])
    kv_k, kv_v = shard_kv_seq(*init_kv_cache(cfg, 1, S, "cuda"), mesh)
    toks = torch.tensor([refs["sp_prompt"]], device="cuda")
    logits, _, kv_k, kv_v = sp(params, toks, torch.arange(
        T0, device="cuda")[None], kv_k, kv_v, 0,
        prefill_mask(1, T0, S, "cuda"))
    rows = [logits[0, -1].float()]
    chain = torch.ones((1, 1), dtype=torch.bool, device="cuda")
    for step in range(16):
        cl = T0 + step
        tok = int(rows[-1].argmax())
        lo, _, kv_k, kv_v = sp(params, torch.tensor([[tok]], device="cuda"),
                               torch.tensor([[cl]], device="cuda"), kv_k,
                               kv_v, cl, block_decode_mask(chain, cl, S))
        rows.append(lo[0, 0].float())
    tokens = [int(r.argmax()) for r in rows]
    j = first_difference(tokens, refs["sp_tokens"])
    gap = None if j is None else float(rows[j][tokens[j]]
                                       - rows[j][refs["sp_tokens"][j]])
    report(c=(tokens, gap), counts=counts, done=True)
    torch.distributed.destroy_process_group()
    return 0


LAPS = [time.perf_counter()]
EMITTER = []          # the BenchEmitter, once the path phases begin


def lap(label: str) -> None:
    """Print the wall seconds since the previous lap (each phase's time),
    record them, and from phase 4 on write the detail file."""
    now = time.perf_counter()
    print(f"wall: {label} {now - LAPS[-1]:.1f} s ({now - LAPS[0]:.1f} s "
          "in all)", flush=True)
    DETAIL[label.replace(" ", "_") + "_seconds"] = now - LAPS[-1]
    DETAIL["script_seconds"] = now - LAPS[0]
    for em in EMITTER:            # its own cost, summed, in the next file
        em.emit()
        DETAIL["emit_seconds"] = DETAIL.get("emit_seconds", 0.0) \
            + time.perf_counter() - now
    LAPS.append(time.perf_counter())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:       # one of phase 19's ranks
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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

    lap("phases 1-2")
    if sys.argv[1:] == ["--isolate-11b"]:
        return isolate_11b(card)

    # phase 3: kernels against their plain versions
    rows = {"flash_block_attention": check_kernels(card),
            "flash_block_attention_int8kv": check_int8_attention(card),
            "int4_matmul": check_int4(card), **check_paged(card)}
    check_tree_masks(card)
    errs = check_hybrid_masks(card)
    for name, key in (("flash_block_attention", "pld"),
                      ("flash_block_attention", "tr"),
                      ("flash_block_attention_int8kv", "int8")):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        errs[(key, torch.bfloat16)])
    rows["paged_block_attention_int8kv"]["max_abs_err"] = max(
        rows["paged_block_attention_int8kv"]["max_abs_err"], errs["k4"])
    errs = check_eagle_masks(card)
    for name, key in (("flash_block_attention", "k1"),
                      ("flash_block_attention_int8kv", "int8")):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        errs[(key, torch.bfloat16)])
    rows["paged_block_attention_int8kv"]["max_abs_err"] = max(
        rows["paged_block_attention_int8kv"]["max_abs_err"], errs["k4"])

    lap("phase 3")
    from samd_tpu_torch.evaluation.bench_emit import BenchEmitter

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    EMITTER.append(BenchEmitter(DETAIL, os.path.join(
        ROOT, "chiprun_out", "chip_smoke_detail.json")))
    # phases 4 to 19: the paths, each with its counts read on its own and
    # summed into TOTALS
    main_path_1b(card)
    lap("phase 4")
    gc.collect()
    torch.cuda.empty_cache()
    cfg7, params7 = llama_7b_int4_params()
    main_path_7b(card, cfg7, params7)
    lap("phase 5")
    gc.collect()
    torch.cuda.empty_cache()
    _, requests7, oracle7 = main_path_7b_paged(card, cfg7, params7)
    lap("phase 6")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_server(card, cfg7, params7, requests7, oracle7)
    lap("phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_7b_host(card, cfg7, params7)
    lap("phase 9")
    gc.collect()
    torch.cuda.empty_cache()
    single7 = main_path_7b_hybrid(card, cfg7, params7)
    lap("phase 11a")
    gc.collect()
    torch.cuda.empty_cache()
    paged7 = main_path_7b_paged_hybrid(card, cfg7, params7, requests7)
    lap("phase 11b")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_7b_eagle(card, cfg7, params7, single7, paged7, requests7)
    lap("phase 13")
    del single7, paged7
    del params7
    gc.collect()
    torch.cuda.empty_cache()
    main_path_1b_batched(card)
    lap("phase 7")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_1b_host(card)
    lap("phase 10")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_1b_fused(card)
    lap("phase 12")
    gc.collect()
    torch.cuda.empty_cache()
    main_path_1b_eagle(card)
    lap("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=ROOT)
    try:
        cfg1, params1 = main_path_1b_disk(card, d)
        lap("phase 15")
        gc.collect()
        torch.cuda.empty_cache()
        for name, err in main_path_training(card, cfg1, params1).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        lap("phase 16")
        del cfg1, params1
        gc.collect()
        torch.cuda.empty_cache()
        for name, err in main_path_mixtral(card).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        lap("phase 17")
        gc.collect()
        torch.cuda.empty_cache()
        main_path_tools(card, d)
        lap("phase 18")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in main_path_mesh(card).items():
        TOTALS[name] = TOTALS.get(name, 0) + n
    lap("phase 19")
    fail_if(min(TOTALS.values()) == 0, f"a kernel never launched on a path: "
            f"{TOTALS}")
    EMITTER[0].emit(complete=True)

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
         "replaces": meta[name][1], "launches": TOTALS[name], **rows[name]}
        for name in meta]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
