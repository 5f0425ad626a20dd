"""The CUDA kernels against their plain PyTorch versions: the verify
attention (with k/v of q's type and in int8-KV mode), its paged mode over
a page pool (K4), and the int4 weight-streaming matmul.

Needs a card: every test here carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor samd_tpu, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from samd_tpu_torch.cache import quantize_kv_block
from samd_tpu_torch.models.llama import block_decode_mask, prefill_mask
from samd_tpu_torch.ops import int4_matmul as k3
from samd_tpu_torch.ops.flash_attention import (flash_block_attention,
                                                flash_block_attention_ref,
                                                kernel_tolerance)
from samd_tpu_torch.ops.paged_attention import (boundary_mask_window,
                                                gather_pages,
                                                paged_block_attention,
                                                paged_block_attention_ref,
                                                window_to_mask)
from samd_tpu_torch.ops.quant import quantize_weight4
from samd_tpu_torch.ops.treeops import tree_mask_from_parents


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_case(T, NH, KH, D, S, cache_len, dtype, device, seed=0,
              prefill=False):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    q, k, v = normal(1, T, NH, D), normal(1, KH, S, D), normal(1, KH, S, D)
    if prefill:
        mask = prefill_mask(1, T, S, device).contiguous()
    else:
        parents = [-1] + [int(rng.integers(0, i)) for i in range(1, T)]
        tree = tree_mask_from_parents(torch.tensor(parents)).to(device)
        mask = block_decode_mask(tree, cache_len, S).contiguous()
    lim = torch.tensor(cache_len + T, dtype=torch.int32, device=device)
    return q, k, v, mask, lim


# (T, NH, KH, D, S, cache_len, prefill): tiny, llama_1b decode / T = 1 /
# prefill, a llama_7b (KH >= 8) shape, llama_7b's bf16 prefill into the
# paged engine's 128-slot batch-1 cache, and llama_7b decode in bf16 at
# T = 16 with ragged R = 1 and 13 (bf16 q: the column-quarter layout)
SHAPES = [(8, 8, 2, 16, 128, 40, False), (16, 16, 8, 32, 256, 180, False),
          (60, 32, 4, 64, 2048, 700, False), (1, 32, 4, 64, 2048, 300, False),
          (128, 32, 4, 64, 2048, 0, True), (60, 32, 32, 128, 2048, 300, False),
          (128, 32, 32, 128, 128, 0, True),
          (16, 32, 32, 128, 1024, 200, False),
          (1, 32, 32, 128, 1024, 300, False),
          (13, 32, 32, 128, 1024, 300, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,NH,KH,D,S,cache_len,prefill", SHAPES)
def test_kernel_matches_plain(cuda_device, dtype, T, NH, KH, D, S,
                              cache_len, prefill):
    """Within ``kernel_tolerance``: another summation order (f32), plus one
    bf16 rounding of the output (bf16); two runs bitwise equal; poison past
    kv_limit changes nothing; one count per launch."""
    q, k, v, mask, lim = make_case(T, NH, KH, D, S, cache_len, dtype,
                                   cuda_device, prefill=prefill)
    before = flash_block_attention.launches
    got = flash_block_attention(q, k, v, mask, lim)
    again = flash_block_attention(q, k, v, mask, lim)
    k[:, :, cache_len + T:] = 1e30
    v[:, :, cache_len + T:] = -1e30
    poisoned = flash_block_attention(q, k, v, mask, lim)
    torch.cuda.synchronize()
    assert flash_block_attention.launches == before + 3
    ref = flash_block_attention_ref(q, k, v, mask, lim)
    excess = ((got.float() - ref.float()).abs() - kernel_tolerance(ref))
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got, poisoned)


# int8-KV mode: (T, NH, KH, D, S, cache_len, prefill): tiny, llama_7b
# decode at several live lengths and its T = 128 prefill, a llama_1b
# shape, and ragged R = 1 and 13 at G = 1
Q8_SHAPES = [(8, 8, 2, 16, 128, 40, False), (16, 32, 32, 128, 1024, 0, False),
             (16, 32, 32, 128, 1024, 200, False),
             (16, 32, 32, 128, 1024, 1008, False),
             (128, 32, 32, 128, 1024, 0, True),
             (60, 32, 4, 64, 2048, 700, False),
             (1, 32, 32, 128, 1024, 300, False),
             (13, 32, 32, 128, 1024, 300, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,NH,KH,D,S,cache_len,prefill", Q8_SHAPES)
def test_int8_kv_kernel_matches_plain(cuda_device, dtype, T, NH, KH, D, S,
                                      cache_len, prefill):
    """int8 K/V with per-(head, column) scales: within ``kernel_tolerance``
    of the plain version, two runs bitwise equal, ±127 bytes and 1e30
    scales past kv_limit change nothing, one count per launch."""
    q, k, v, mask, lim = make_case(T, NH, KH, D, S, cache_len, torch.float32,
                                   cuda_device, prefill=prefill)
    q = q.to(dtype)
    (kq, ks), (vq, vs) = (quantize_kv_block(t) for t in (k, v))
    before = flash_block_attention.launches_int8
    got = flash_block_attention(q, kq, vq, mask, lim, ks, vs)
    again = flash_block_attention(q, kq, vq, mask, lim, ks, vs)
    for t in (kq, vq):
        t[:, :, cache_len + T:] = 127
    for t in (ks, vs):
        t[:, :, cache_len + T:] = 1e30
    poisoned = flash_block_attention(q, kq, vq, mask, lim, ks, vs)
    torch.cuda.synchronize()
    assert flash_block_attention.launches_int8 == before + 3
    ref = flash_block_attention_ref(q, kq, vq, mask, lim, ks, vs)
    excess = ((got.float() - ref.float()).abs() - kernel_tolerance(ref))
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got, poisoned)


# (T, NH, KH, D, cache_len, prefill): both row layouts, decode and prefill
S_INVARIANT_CASES = [(16, 32, 32, 128, 200, False), (13, 32, 32, 128, 0, False),
                     (60, 32, 4, 64, 160, False), (128, 32, 32, 128, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,NH,KH,D,cache_len,prefill", S_INVARIANT_CASES)
def test_kernel_s_invariant(cuda_device, T, NH, KH, D, cache_len, prefill,
                            int8):
    """The same live prefix in a 256- and a 1024-column cache gives the
    same bits (bf16 q): the single-stream engine moves a request between
    cache buckets, and its oracle equality needs a row's result to ignore
    the columns past kv_limit."""
    q, k, v, mask, lim = make_case(T, NH, KH, D, 1024, cache_len,
                                   torch.float32, cuda_device,
                                   prefill=prefill)
    q = q.to(torch.bfloat16)
    if int8:
        (k, ks), (v, vs) = (quantize_kv_block(t) for t in (k, v))
        sc, sc256 = (ks, vs), (ks[:, :, :256].contiguous(),
                               vs[:, :, :256].contiguous())
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        sc = sc256 = ()
    big = flash_block_attention(q, k, v, mask, lim, *sc)
    small = flash_block_attention(q, k[:, :, :256].contiguous(),
                                  v[:, :, :256].contiguous(),
                                  mask[:, :, :256].contiguous(), lim, *sc256)
    torch.cuda.synchronize()
    assert torch.equal(big, small)


def int4_case(L, IN, OUT, R, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((L, IN, OUT), generator=gen, device=device) * 0.02
    t = quantize_weight4(w)
    x = torch.randn((R, IN), generator=gen, device=device)
    return x.to(torch.bfloat16), t.packed, t.scale


# (in, out) of llama_7b's projections and head, at decode rows, the
# prefill buckets 128 and 256, and B * M = 12 * 16 rows of batched serving
K3_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [1, 13, 16, 128, 192, 200, 256])
@pytest.mark.parametrize("IN,OUT", K3_SHAPES)
def test_int4_kernel_matches_plain(cuda_device, IN, OUT, R, xdt):
    """Within ``ops.int4_matmul.kernel_tolerance`` of the plain version in
    bf16 and f32 outputs; two runs bitwise equal; row invariance: each row
    equals the same x row run alone at R = 1 and placed at another row of
    another block, bitwise; one count per launch.  A bf16 x runs on the
    tensor cores (row tiles of 16 up to R = 16, of 64 beyond: R = 1, 13
    and 200 end inside one; q/k/v/o and w_down split k over two CTAs and
    a second pass), an f32 x on the CUDA cores."""
    x, packed, scale = int4_case(2, IN, OUT, R, cuda_device, seed=IN + OUT)
    x = x.to(xdt)
    layer = 1
    if OUT == 32000:          # the head: a 2-D weight, no layer index
        packed, scale, layer = packed[1], scale[1], None
    for out_dtype in (torch.bfloat16, torch.float32):
        before = k3.int4_matmul.launches
        got = k3.int4_matmul(x, packed, scale, layer, out_dtype=out_dtype)
        again = k3.int4_matmul(x, packed, scale, layer, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert k3.int4_matmul.launches == before + 2
        ref = k3.int4_matmul_ref(x, packed, scale, layer,
                                 out_dtype=out_dtype)
        tol = k3.kernel_tolerance(x, packed, scale, layer, ref)
        excess = (got.float() - ref.float()).abs() - tol
        assert excess.max().item() <= 0, (out_dtype, excess.max().item())
        assert torch.equal(got, again)
    for r in sorted({0, min(5, R - 1), R - 1}):
        alone = k3.int4_matmul(x[r:r + 1].contiguous(), packed, scale, layer,
                               out_dtype=torch.float32)
        other = torch.randn((7, IN), device=cuda_device).to(xdt)
        other[6] = x[r]
        placed = k3.int4_matmul(other, packed, scale, layer,
                                out_dtype=torch.float32)
        assert torch.equal(alone[0], got[r]) and torch.equal(placed[6],
                                                             got[r])


@pytest.mark.cuda
@pytest.mark.parametrize("IN,OUT", K3_SHAPES)
def test_int4_kernel_row_invariant_across_r(cuda_device, IN, OUT):
    """A row's output is the same bits at R = 16 (one 16-row tile) as
    inside R = 192 (64-row tiles), wherever the 16 rows sit in it."""
    x, packed, scale = int4_case(2, IN, OUT, 192, cuda_device, seed=3)
    layer = 1
    if OUT == 32000:
        packed, scale, layer = packed[1], scale[1], None
    for out_dtype in (torch.bfloat16, torch.float32):
        big = k3.int4_matmul(x, packed, scale, layer, out_dtype=out_dtype)
        for a in (0, 56, 176):
            small = k3.int4_matmul(x[a:a + 16].contiguous(), packed, scale,
                                   layer, out_dtype=out_dtype)
            assert torch.equal(small, big[a:a + 16]), (out_dtype, a)


def paged_case(B, T, NH, KH, D, page, committed, dtype, int8, device,
               seed=0):
    """A page pool with shuffled tables: slot b holds ``committed[b]``
    tokens plus its block of T (None: an inactive slot, table all -1,
    kv_limit T); a random tree block mask per slot.  Returns (args of
    paged_block_attention, the active slots, the pages in no table)."""
    rng = np.random.default_rng(seed)
    P = -(-1024 // page) + -(-T // page) + 1      # table width, with pad
    lims = [T + (c or 0) for c in committed]
    used = sum(-(-lim // page) for c, lim in zip(committed, lims)
               if c is not None)
    n_pages = used + 5

    def normal(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(device)

    kp, vp = normal(n_pages + 1, KH, page, D), normal(n_pages + 1, KH, page, D)
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = (quantize_kv_block(t) for t in (kp, vp))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    perm = rng.permutation(n_pages)
    tables = np.full((B, P), -1, np.int32)
    at = 0
    for b, (c, lim) in enumerate(zip(committed, lims)):
        if c is None:
            continue
        npg = -(-lim // page)
        tables[b, :npg] = perm[at:at + npg]
        at += npg
    wins = []
    for b in range(B):
        parents = [-1] + [int(rng.integers(0, i)) for i in range(1, T)]
        tree = tree_mask_from_parents(torch.tensor(parents)).to(device)
        wins.append(boundary_mask_window(tree, committed[b] or 0, page))
    q = normal(B, T, NH, D).to(dtype)
    args = (q, kp, vp, torch.from_numpy(tables).to(device),
            torch.stack(wins).contiguous(),
            torch.tensor(lims, dtype=torch.int32, device=device), ks, vs)
    active = [b for b, c in enumerate(committed) if c is not None]
    return args, active, sorted(set(range(n_pages)) - set(perm[:at])) \
        + [n_pages]


def poison_pages(args, active, spare, page):
    """Copies of the pools with 1e30 (int8: 127 with scales of 1e30) past
    each active slot's kv_limit in its last page, in every page outside the
    tables and in the scratch page."""
    q, kp, vp, tables, win, lims, ks, vs = args
    kp, vp = kp.clone(), vp.clone()
    ks, vs = (None, None) if ks is None else (ks.clone(), vs.clone())
    big = 127 if kp.dtype == torch.int8 else 1e30
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


# (B, T, NH, KH, D, page, committed lengths, int8 pool): llama_7b decode
# at B = 12 over int8 pages (live lengths spread over 0-1008, some
# page-aligned, two slots inactive), and llama_1b decode over a q-typed pool
PAGED_CASES = [
    (12, 16, 32, 32, 128, 128,
     [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700, 1008], True),
    (4, 16, 32, 4, 64, 128, [300, None, 64, 1008], False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_paged_kernel_matches_plain_and_verify_kernel(cuda_device, dtype,
                                                      case):
    """K4: within ``kernel_tolerance`` of its plain version; two runs
    bitwise equal; each active slot bitwise equal to the verify kernel on
    the slot's gathered dense KV; poison past kv_limit, in pages outside
    the tables and in the scratch page changes nothing; one count per
    launch."""
    B, T, NH, KH, D, page, committed, int8 = PAGED_CASES[case]
    args, active, spare = paged_case(B, T, NH, KH, D, page, committed, dtype,
                                     int8, cuda_device, seed=case)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(paged_block_attention, counter)
    got = paged_block_attention(*args)
    again = paged_block_attention(*args)
    poisoned = paged_block_attention(*poison_pages(args, active, spare,
                                                   page))
    torch.cuda.synchronize()
    assert getattr(paged_block_attention, counter) == before + 3
    ref = paged_block_attention_ref(*args)[active]
    excess = (got[active].float() - ref.float()).abs() - kernel_tolerance(ref)
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got[active], poisoned[active])
    q, kp, vp, tables, win, lims, ks, vs = args
    for b in active:
        tb = tables[b:b + 1]
        kd, vd = gather_pages(kp, tb), gather_pages(vp, tb)
        sc = () if ks is None else (gather_pages(ks, tb),
                                    gather_pages(vs, tb))
        mask = window_to_mask(win[b:b + 1], lims[b:b + 1], T, page,
                              kd.shape[2])
        dense = flash_block_attention(q[b:b + 1].contiguous(), kd, vd, mask,
                                      lims[b], *sc)
        assert torch.equal(got[b], dense[0]), f"slot {b}"
