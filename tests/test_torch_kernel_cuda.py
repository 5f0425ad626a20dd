"""The CUDA kernels against their plain PyTorch versions: the verify
attention (with k/v of q's type and in int8-KV mode) and the int4
weight-streaming matmul.

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
# prefill, and a llama_7b (KH >= 8) shape
SHAPES = [(8, 8, 2, 16, 128, 40, False), (16, 16, 8, 32, 256, 180, False),
          (60, 32, 4, 64, 2048, 700, False), (1, 32, 4, 64, 2048, 300, False),
          (128, 32, 4, 64, 2048, 0, True), (60, 32, 32, 128, 2048, 300, False)]


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
# decode at several live lengths and its T = 128 prefill, a llama_1b shape
Q8_SHAPES = [(8, 8, 2, 16, 128, 40, False), (16, 32, 32, 128, 1024, 0, False),
             (16, 32, 32, 128, 1024, 200, False),
             (16, 32, 32, 128, 1024, 1008, False),
             (128, 32, 32, 128, 1024, 0, True),
             (60, 32, 4, 64, 2048, 700, False)]


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


def int4_case(L, IN, OUT, R, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((L, IN, OUT), generator=gen, device=device) * 0.02
    t = quantize_weight4(w)
    x = torch.randn((R, IN), generator=gen, device=device)
    return x.to(torch.bfloat16), t.packed, t.scale


# (in, out) of llama_7b's projections and head, at decode rows and the
# prefill buckets 128 and 256
K3_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [16, 128, 256])
@pytest.mark.parametrize("IN,OUT", K3_SHAPES)
def test_int4_kernel_matches_plain(cuda_device, IN, OUT, R):
    """Within ``ops.int4_matmul.kernel_tolerance`` of the plain version in
    bf16 and f32 outputs; two runs bitwise equal; row invariance: each row
    equals the same x row run alone at R = 1 and placed at another row of
    another block, bitwise; one count per launch."""
    x, packed, scale = int4_case(2, IN, OUT, R, cuda_device, seed=IN + OUT)
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
    for r in (0, 5, R - 1):
        alone = k3.int4_matmul(x[r:r + 1].contiguous(), packed, scale, layer,
                               out_dtype=torch.float32)
        other = torch.randn((7, IN), device=cuda_device).to(torch.bfloat16)
        other[6] = x[r]
        placed = k3.int4_matmul(other, packed, scale, layer,
                                out_dtype=torch.float32)
        assert torch.equal(alone[0], got[r]) and torch.equal(placed[6],
                                                             got[r])
