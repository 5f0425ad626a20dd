"""The CUDA kernels against their plain PyTorch versions: the verify
attention (with k/v of q's type and in int8-KV mode), its paged mode over
a page pool (K4), the int4 weight-streaming matmul, and the per-request
Philox noise (bit for bit, and read afresh by every graph replay).

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
from samd_tpu_torch.ops.request_noise import (request_uniforms,
                                              request_uniforms_plain)
from samd_tpu_torch.ops.treeops import tree_mask_from_parents


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_case(T, NH, KH, D, S, cache_len, dtype, device, seed=0,
              prefill=False, parents=None):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    q, k, v = normal(1, T, NH, D), normal(1, KH, S, D), normal(1, KH, S, D)
    if prefill:
        mask = prefill_mask(1, T, S, device).contiguous()
    else:
        if parents is None:
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
@pytest.mark.parametrize("R", [1, 13, 16, 60, 64, 128, 192, 200, 256,
                               288])
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
               seed=0, parents=None):
    """A page pool with shuffled tables: slot b holds ``committed[b]``
    tokens plus its block of T (None: an inactive slot, table all -1,
    kv_limit T); a random tree block mask per slot, or the tree of
    ``parents`` in every slot.  Returns (args of
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
        par = parents if parents is not None else \
            [-1] + [int(rng.integers(0, i)) for i in range(1, T)]
        tree = tree_mask_from_parents(torch.tensor(par)).to(device)
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


# ----------------------------------------------------------------------
# the host engines' tree masks (M = 60) and their K3 block of 60 rows
# ----------------------------------------------------------------------

def tree_parents(name):
    """The Token-Recycle topology (the first 60 nodes of
    rank_probability_tree(61)), or a corpus SAM's frequency tree of 60
    nodes (8 deep), self-parent padded as the engines pack it."""
    from samd_tpu_torch.drafters import rank_probability_tree
    from samd_tpu_torch.ops.treeops import pack_draft_host
    from samd_tpu_torch.sam import build_corpus_sam

    if name == "token_recycle":
        return rank_probability_tree(61)[:60].tolist()
    rng = np.random.default_rng(0)
    sam = build_corpus_sam([rng.integers(0, 6, 4000).tolist()], eos_token=0,
                           topk=8)
    sam.feed(rng.integers(0, 6, 2).tolist(), grow=False)
    toks, par = sam.tree_draft(sam.cur_state, 1, 60, 8)
    return pack_draft_host(toks, par, 60)[1].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tree", ["token_recycle", "sam_frequency"])
def test_tree_mask_kernel_matches_plain(cuda_device, tree, int8, dtype):
    """The verify kernel on the host engines' tree masks: llama_1b T = 60
    (k/v of q's type), llama_7b KH 32, D 128, T = 60 in int8-KV mode:
    within ``kernel_tolerance``, two runs bitwise equal, poison past
    kv_limit changes nothing."""
    T, NH, KH, D, S, cl = ((60, 32, 32, 128, 1024, 700) if int8
                           else (60, 32, 4, 64, 2048, 700))
    q, k, v, mask, lim = make_case(T, NH, KH, D, S, cl,
                                   torch.float32 if int8 else dtype,
                                   cuda_device, seed=5,
                                   parents=tree_parents(tree))
    q = q.to(dtype)
    if int8:
        (k, ks), (v, vs) = (quantize_kv_block(t) for t in (k, v))
        args = [q, k, v, mask, lim, ks, vs]
    else:
        args = [q, k, v, mask, lim]
    got = flash_block_attention(*args)
    again = flash_block_attention(*args)
    ref = flash_block_attention_ref(*args)
    args[1][:, :, cl + T:] = 127 if int8 else 1e30
    args[2][:, :, cl + T:] = -127 if int8 else -1e30
    if int8:
        args[5][:, :, cl + T:] = 1e30
        args[6][:, :, cl + T:] = 1e30
    poisoned = flash_block_attention(*args)
    torch.cuda.synchronize()
    excess = ((got.float() - ref.float()).abs() - kernel_tolerance(ref))
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got, poisoned)


@pytest.mark.cuda
@pytest.mark.parametrize("tree", ["token_recycle", "sam_frequency"])
def test_tree_mask_paged_kernel(cuda_device, tree):
    """K4 over bf16 pages at llama_1b B = 4 with the tree's boundary
    windows: within ``kernel_tolerance``, two runs bitwise equal, each
    active slot bitwise equal to the verify kernel on its gathered KV,
    poison changes nothing."""
    T, page = 60, 128
    args, active, spare = paged_case(4, T, 32, 4, 64, page,
                                     [300, None, 64, 900], torch.bfloat16,
                                     False, cuda_device, seed=7,
                                     parents=tree_parents(tree))
    got = paged_block_attention(*args)
    again = paged_block_attention(*args)
    poisoned = paged_block_attention(*poison_pages(args, active, spare,
                                                   page))
    torch.cuda.synchronize()
    ref = paged_block_attention_ref(*args)[active]
    excess = (got[active].float() - ref.float()).abs() - kernel_tolerance(ref)
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got[active], poisoned[active])
    q, kp, vp, tables, win, lims, _, _ = args
    for b in active:
        tb = tables[b:b + 1]
        kd, vd = gather_pages(kp, tb), gather_pages(vp, tb)
        mask = window_to_mask(win[b:b + 1], lims[b:b + 1], T, page,
                              kd.shape[2])
        dense = flash_block_attention(q[b:b + 1].contiguous(), kd, vd, mask,
                                      lims[b])
        assert torch.equal(got[b], dense[0]), f"slot {b}"


@pytest.mark.cuda
@pytest.mark.parametrize("IN,OUT", K3_SHAPES)
def test_int4_kernel_r60_rows_equal_r16(cuda_device, IN, OUT):
    """The host engines' 60-row block: each 16-row block of an R = 60 call
    (the last one ragged inside its 64-row tile) is the same bits as those
    rows at R = 16."""
    x, packed, scale = int4_case(2, IN, OUT, 60, cuda_device, seed=4)
    layer = 1
    if OUT == 32000:
        packed, scale, layer = packed[1], scale[1], None
    for out_dtype in (torch.bfloat16, torch.float32):
        big = k3.int4_matmul(x, packed, scale, layer, out_dtype=out_dtype)
        for a in (0, 16, 32, 44):
            small = k3.int4_matmul(x[a:a + 16].contiguous(), packed, scale,
                                   layer, out_dtype=out_dtype)
            assert torch.equal(small, big[a:a + 16]), (out_dtype, a)


# the fused drafters' shapes: the hybrid's relabelled 61-node tree padded
# to M = 64 (int8 KV, llama_7b), PLD's 11-node chain and the fused
# Token-Recycle 61-node tree (llama_1b), the server block's 23-node tree
# in B = 12 int8 page windows, and K3 at R = 64 and 12 x 24 = 288
# ----------------------------------------------------------------------

def fused_parents(name):
    from samd_tpu_torch.fused_hybrid import build_tr_topology

    if name == "pld11":
        return list(range(-1, 10))
    n, pad = {"hybrid64": (61, 3), "tr61": (61, 0), "hybrid24": (23, 1)}[name]
    return build_tr_topology(n, 8)[0].tolist() + list(range(n, n + pad))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tree,T,NH,KH,D,S,cl,int8", [
    ("hybrid64", 64, 32, 32, 128, 1024, 700, True),
    ("pld11", 11, 32, 4, 64, 2048, 700, False),
    ("tr61", 61, 32, 4, 64, 2048, 700, False)])
def test_fused_drafter_masks_kernel_matches_plain(cuda_device, tree, T, NH,
                                                  KH, D, S, cl, int8, dtype):
    """The verify kernel on the fused drafters' masks: within
    ``kernel_tolerance``, two runs bitwise equal, poison past kv_limit
    changes nothing."""
    q, k, v, mask, lim = make_case(T, NH, KH, D, S, cl,
                                   torch.float32 if int8 else dtype,
                                   cuda_device, seed=9,
                                   parents=fused_parents(tree))
    q = q.to(dtype)
    if int8:
        (k, ks), (v, vs) = (quantize_kv_block(t) for t in (k, v))
        args = [q, k, v, mask, lim, ks, vs]
    else:
        args = [q, k, v, mask, lim]
    got = flash_block_attention(*args)
    again = flash_block_attention(*args)
    ref = flash_block_attention_ref(*args)
    args[1][:, :, cl + T:] = 127 if int8 else 1e30
    args[2][:, :, cl + T:] = -127 if int8 else -1e30
    if int8:
        args[5][:, :, cl + T:] = 1e30
        args[6][:, :, cl + T:] = 1e30
    poisoned = flash_block_attention(*args)
    torch.cuda.synchronize()
    excess = ((got.float() - ref.float()).abs() - kernel_tolerance(ref))
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got, poisoned)


@pytest.mark.cuda
def test_hybrid_tree_int8_paged_kernel(cuda_device):
    """K4 over int8 pages at llama_7b B = 12, T = 24 with the 23-node tree
    in every window: within ``kernel_tolerance``, two runs bitwise equal,
    each active slot bitwise equal to the verify kernel on its gathered
    KV, poison changes nothing."""
    T, page = 24, 128
    args, active, spare = paged_case(
        12, T, 32, 32, 128, page,
        [0, 112, None, 128, 200, 255, 256, 384, None, 640, 700, 1000],
        torch.bfloat16, True, cuda_device, seed=8,
        parents=fused_parents("hybrid24"))
    got = paged_block_attention(*args)
    again = paged_block_attention(*args)
    poisoned = paged_block_attention(*poison_pages(args, active, spare,
                                                   page))
    torch.cuda.synchronize()
    ref = paged_block_attention_ref(*args)[active]
    excess = (got[active].float() - ref.float()).abs() - kernel_tolerance(ref)
    assert excess.max().item() <= 0, excess.max().item()
    assert torch.equal(got, again)
    assert torch.equal(got[active], poisoned[active])
    q, kp, vp, tables, win, lims, ks, vs = args
    for b in active:
        tb = tables[b:b + 1]
        kd, vd = gather_pages(kp, tb), gather_pages(vp, tb)
        mask = window_to_mask(win[b:b + 1], lims[b:b + 1], T, page,
                              kd.shape[2])
        dense = flash_block_attention(q[b:b + 1].contiguous(), kd, vd, mask,
                                      lims[b], gather_pages(ks, tb),
                                      gather_pages(vs, tb))
        assert torch.equal(got[b], dense[0]), f"slot {b}"


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 288])
@pytest.mark.parametrize("IN,OUT", K3_SHAPES)
def test_int4_kernel_fused_blocks_rows_equal_r16(cuda_device, IN, OUT, R):
    """The fused hybrid's blocks, 64 rows (one stream) and 288 (B = 12 x
    24, a ragged fifth 64-row tile): every 16-row block is the same bits
    as those rows at R = 16."""
    x, packed, scale = int4_case(2, IN, OUT, R, cuda_device, seed=6)
    layer = 1
    if OUT == 32000:
        packed, scale, layer = packed[1], scale[1], None
    for out_dtype in (torch.bfloat16, torch.float32):
        big = k3.int4_matmul(x, packed, scale, layer, out_dtype=out_dtype)
        for a in range(0, R, 16):
            small = k3.int4_matmul(x[a:a + 16].contiguous(), packed, scale,
                                   layer, out_dtype=out_dtype)
            assert torch.equal(small, big[a:a + 16]), (out_dtype, a)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "flash_int8", "paged", "int4"])
def test_kernels_refuse_inputs_that_require_grad(cuda_device, kernel):
    """No kernel has a backward: on the card each wrapper raises on an
    input that requires grad while grad mode is on, launches nothing, and
    runs as before under no_grad."""
    T, NH, KH, D, S = 4, 4, 2, 64, 128
    if kernel.startswith("flash"):
        q, k, v, mask, lim = make_case(T, NH, KH, D, S, 20, torch.float32,
                                       cuda_device)
        args = [q, k, v, mask, lim]
        if kernel == "flash_int8":
            kq, ks = quantize_kv_block(k)
            vq, vs = quantize_kv_block(v)
            args = [q, kq, vq, mask, lim, ks, vs]

        def call():
            return flash_block_attention(*args)
    elif kernel == "paged":
        page = 64
        q = torch.randn(1, T, NH, D, device=cuda_device)
        kp = torch.randn(4, KH, page, D, device=cuda_device)
        vp = torch.randn(4, KH, page, D, device=cuda_device)
        tables = torch.tensor([[2, 0]], dtype=torch.int32,
                              device=cuda_device)
        lims = torch.tensor([70], dtype=torch.int32, device=cuda_device)
        tree = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                     device=cuda_device))
        win = boundary_mask_window(tree[None], lims - T, page).contiguous()
        args = [q, kp, vp, tables, win, lims]

        def call():
            return paged_block_attention(*args)
    else:
        x, packed, scale = int4_case(1, 128, 256, 16, cuda_device, seed=0)
        args = [x, packed, scale, 0]

        def call():
            return k3.int4_matmul(*args)
    with torch.no_grad():
        want = call()
    args[0] = args[0].clone().requires_grad_(True)
    counts = (flash_block_attention.launches,
              flash_block_attention.launches_int8,
              paged_block_attention.launches, k3.int4_matmul.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert counts == (flash_block_attention.launches,
                      flash_block_attention.launches_int8,
                      paged_block_attention.launches,
                      k3.int4_matmul.launches)
    with torch.no_grad():
        assert torch.equal(call(), want)


# (B, n): the 1b B = 4 chain step under rejection (M 16) and nucleus, the
# server's rejection step (B 12, M 16, V 32000), the paged hybrid's nucleus
# tree step (B 12, M 24), a first-token draw, and ragged lengths
NOISE_SHAPES = [(4, 16 + 32000), (4, 16 + 17 * 32000), (12, 16 + 32000),
                (12, 24 * 24 + 25 * 32000), (1, 32000), (3, 1), (5, 4099),
                (2, 7)]


def noise_case(B, seed, device):
    rng = np.random.default_rng(seed)
    seeds = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=B,
                                          dtype=np.int64)).to(device)
    draws = torch.from_numpy(rng.integers(0, 1 << 31, size=B).astype(
        np.int32)).to(device)
    mask = torch.from_numpy(rng.random(B) < 0.7).to(device)
    return seeds, draws, mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", NOISE_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_request_noise_kernel_matches_plain(cuda_device, B, n, masked):
    """The Philox kernel equals its plain version bit for bit, on the card
    and on the CPU; a masked-out row is zeros."""
    seeds, draws, mask = noise_case(B, B * n, cuda_device)
    mask = mask if masked else None
    before = request_uniforms.launches
    got = request_uniforms(seeds, draws, n, mask)
    torch.cuda.synchronize()
    assert request_uniforms.launches == before + 1
    assert got.shape == (B, n) and got.dtype == torch.float32
    assert torch.equal(got, request_uniforms_plain(seeds, draws, n, mask))
    cpu = request_uniforms_plain(seeds.cpu(), draws.cpu(), n,
                                 None if mask is None else mask.cpu())
    assert torch.equal(got.cpu(), cpu)
    if masked:
        assert not got[~mask].any()


@pytest.mark.cuda
def test_request_noise_replay_reads_current_counters(cuda_device):
    """A captured draw reads the seeds and draws from device memory at
    every replay: advancing the counter in place gives the next draw."""
    seeds, draws, mask = noise_case(12, 0, cuda_device)
    out = torch.zeros((12, 16 + 32000), device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    request_uniforms(seeds, draws, out.shape[1], mask)   # warm-up
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out.copy_(request_uniforms(seeds, draws, out.shape[1], mask))
        draws.add_(mask.to(torch.int32))
    start = draws.clone()
    for i in range(3):
        graph.replay()
        torch.cuda.synchronize()
        now = start + i * mask.to(torch.int32)
        assert torch.equal(out, request_uniforms_plain(seeds, now,
                                                       out.shape[1], mask))
    assert torch.equal(draws, start + 3 * mask.to(torch.int32))


@pytest.mark.cuda
def test_request_noise_refuses_what_it_does_not_take(cuda_device):
    seeds, draws, mask = noise_case(4, 1, cuda_device)
    for args in ((seeds.int(), draws), (seeds, draws.long()),
                 (seeds, draws.cpu()), (seeds[::2], draws[::2])):
        with pytest.raises(ValueError):
            request_uniforms(*args, 64)
    with pytest.raises(ValueError):
        request_uniforms(seeds, draws, 64, mask.int())
