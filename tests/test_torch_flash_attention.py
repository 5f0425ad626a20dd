"""Verify-block attention of samd_tpu_torch against the JAX Pallas kernel.

On the CPU the port's wrapper takes its plain version; it is held against
JAX's ``flash_block_attention`` run in interpret mode, K1 (KH < 8) and K2
(KH >= 8) shapes included.  ``tiled_order_attention``, the CPU model of the
tensor-core kernel's order and rounding, is held against both in bf16,
with k/v in bf16 and in int8.  The CUDA kernel itself is held against the
plain version in ``test_torch_kernel_cuda.py``, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import QuantizedKV as JaxQKV
from samd_tpu.models.llama import block_decode_mask
from samd_tpu.ops.pallas_attention import flash_block_attention as jax_flash
from samd_tpu.sam.trees import ancestor_closure
from samd_tpu_torch.cache import quantize_kv_block
from samd_tpu_torch.ops.flash_attention import (flash_block_attention,
                                                flash_block_attention_ref,
                                                kernel_tolerance, row_layout,
                                                tiled_order_attention)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def make_case(T, NH, KH, D, S, cache_len, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, T, NH, D)).astype(np.float32)
    k = rng.standard_normal((1, KH, S, D)).astype(np.float32)
    v = rng.standard_normal((1, KH, S, D)).astype(np.float32)
    parents = np.full(T, -1, np.int32)
    for i in range(1, T):
        parents[i] = rng.integers(0, i)
    tree = jnp.asarray(ancestor_closure(parents))
    mask = np.array(block_decode_mask(tree, jnp.int32(cache_len), S))
    return q, k, v, mask, cache_len + T


def port_args(q, k, v, mask, kv_limit, device="cpu"):
    return (torch.from_numpy(q).to(device), torch.from_numpy(k).to(device),
            torch.from_numpy(v).to(device), torch.from_numpy(mask).to(device),
            torch.tensor(kv_limit, dtype=torch.int32, device=device))


@pytest.mark.parametrize("T,NH,KH,D,S,cache_len,block_s", [
    (8, 4, 4, 16, 128, 40, 64),      # MHA
    (8, 8, 2, 16, 128, 40, 64),      # GQA G=4
    (16, 4, 2, 32, 256, 100, 64),    # bigger
    (8, 4, 2, 16, 128, 120, 64),     # kv_limit == S boundary
    (8, 8, 8, 16, 128, 40, 64),      # KH>=8: K2 (fold-KV) regime
    (16, 16, 8, 32, 256, 180, 64),   # K2, GQA, deeper prefix
    (128, 8, 2, 16, 256, 0, 128),    # T = 128 block at cache_len 0
])
def test_matches_jax_pallas(T, NH, KH, D, S, cache_len, block_s):
    q, k, v, mask, kv_limit = make_case(T, NH, KH, D, S, cache_len)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), jnp.int32(kv_limit),
                     block_s=block_s, interpret=True)
    before = flash_block_attention.launches
    got = flash_block_attention(*port_args(q, k, v, mask, kv_limit))
    assert flash_block_attention.launches == before   # CPU: plain version
    assert got.shape == (1, T, NH * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_dead_tail_not_read():
    """Poison past kv_limit leaves the result bitwise unchanged."""
    q, k, v, mask, kv_limit = make_case(8, 4, 4, 16, 128, 40, seed=1)
    got1 = flash_block_attention(*port_args(q, k, v, mask, kv_limit))
    k2, v2 = k.copy(), v.copy()
    k2[:, :, kv_limit:] = 1e30
    v2[:, :, kv_limit:] = -1e30
    got2 = flash_block_attention(*port_args(q, k2, v2, mask, kv_limit))
    assert torch.equal(got1, got2)


def test_kernel_tolerance_admits_one_bf16_rounding():
    """The bound the kernel is held to on the card: in bf16 it admits two
    f32 results a few ulps apart, each rounded to bf16, and rejects a
    result four bf16 ulps off at the largest output; in f32 it is 1e-4."""
    q, k, v, mask, kv_limit = make_case(16, 4, 2, 32, 256, 100, seed=2)
    ref32 = flash_block_attention(*port_args(q, k, v, mask, kv_limit))
    assert torch.equal(kernel_tolerance(ref32), torch.full_like(ref32, 1e-4))
    ref = ref32.to(torch.bfloat16)
    tol = kernel_tolerance(ref)
    other_order = (ref32 * (1 + 2.0 ** -21)).to(torch.bfloat16)
    assert not torch.equal(other_order, ref)
    assert ((other_order.float() - ref.float()).abs() <= tol).all()
    i = int(ref.float().abs().argmax())
    r = ref.flatten()[i].float().abs()
    ulp = 2.0 ** (torch.floor(torch.log2(r)) - 7)
    assert 4 * ulp > tol.flatten()[i]


def _bad_inputs():
    q, k, v, mask, lim = port_args(*make_case(8, 4, 2, 16, 128, 40))
    yield "batch", (q.repeat(2, 1, 1, 1), k, v, mask, lim), \
        NotImplementedError, "items 9"
    q129, k2, v2, m129, lim2 = port_args(*make_case(129, 4, 2, 16, 256, 0))
    yield "long_block", (q129, k2, v2, m129, lim2), ValueError, "T = 129"
    yield "int8_kv", (q, k.to(torch.int8), v.to(torch.int8), mask, lim), \
        ValueError, "k_scale"
    kds = k.transpose(2, 3).contiguous()
    yield "ds_layout", (q, kds, kds, mask, lim), NotImplementedError, "'ds'"
    yield "mask_dtype", (q, k, v, mask.to(torch.int8), lim), ValueError, \
        "mask"
    yield "kv_limit_int", (q, k, v, mask, 48), ValueError, "kv_limit"
    yield "dtype_mix", (q.to(torch.bfloat16), k, v, mask, lim), ValueError, \
        "share"
    yield "strided", (q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      mask, lim), ValueError, "contiguous"


@pytest.mark.parametrize("name", [c[0] for c in _bad_inputs()])
def test_wrapper_rejects(name):
    _, args, exc, match = next(c for c in _bad_inputs() if c[0] == name)
    with pytest.raises(exc, match=match):
        flash_block_attention(*args)



def bf16_case(T, NH, KH, D, S, cache_len, int8, seed=0):
    """bf16 q (and bf16 k/v, or int8 k/v with f32 scales from the port's
    quantizer) as torch tensors, plus JAX's arguments holding the same
    values."""
    q, k, v, mask, kv_limit = make_case(T, NH, KH, D, S, cache_len, seed)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    if int8:
        (kq, ks), (vq, vs) = (quantize_kv_block(torch.from_numpy(x))
                              for x in (k, v))
        port = (qt, kq, vq, torch.from_numpy(mask),
                torch.tensor(kv_limit, dtype=torch.int32), ks, vs)
        jk = JaxQKV(jnp.asarray(kq.numpy().transpose(0, 1, 3, 2)),
                    jnp.asarray(ks.numpy()))
        jv = JaxQKV(jnp.asarray(vq.numpy().transpose(0, 1, 3, 2)),
                    jnp.asarray(vs.numpy()))
        extra = dict(pre_transposed=True)
    else:
        kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        port = (qt, kt, vt, torch.from_numpy(mask),
                torch.tensor(kv_limit, dtype=torch.int32))
        jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (kt, vt))
        extra = {}
    jq = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
    return port, (jq, jk, jv, jnp.asarray(mask), jnp.int32(kv_limit)), extra


# (T, NH, KH, D, S, cache_len, block_s): each row layout of the kernel —
# column quarters at R = G*T <= 16 (tiny MHA; llama_7b decode at
# cache_len 200 and 0, where three warps' quarters hold no live column),
# 64-row tiles above (GQA; K2's fold-KV regime; a T = 128 block)
MODEL_CASES = [
    (8, 4, 4, 16, 128, 40, 64),
    (16, 32, 32, 128, 256, 200, 256),
    (16, 32, 32, 128, 256, 0, 256),
    (8, 8, 2, 16, 128, 40, 64),
    (16, 16, 8, 32, 256, 180, 64),
    (128, 8, 2, 16, 256, 0, 128),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,NH,KH,D,S,cache_len,block_s", MODEL_CASES)
def test_tiled_order_model_within_tolerance(T, NH, KH, D, S, cache_len,
                                            block_s, int8):
    """The kernel's order and rounding (64-column tiles, mma chains, bf16
    hi/lo P, the int8 scale reassociation, the quarter combine at R <= 16)
    stay within ``kernel_tolerance`` of JAX's interpreted Pallas kernel and
    of the plain version, in bf16."""
    port, jargs, extra = bf16_case(T, NH, KH, D, S, cache_len, int8)
    got = tiled_order_attention(*port)
    assert got.dtype == torch.bfloat16 and got.shape == (1, T, NH * D)
    want = jax_flash(*jargs, block_s=block_s, interpret=True, **extra)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    plain = flash_block_attention_ref(*port)
    for ref in (want, plain):
        excess = (got.float() - ref.float()).abs() - kernel_tolerance(ref)
        assert excess.max().item() <= 0, excess.max().item()


@pytest.mark.parametrize("T,NH,KH", [(16, 4, 4), (8, 8, 2)])
def test_tiled_order_model_is_s_invariant(T, NH, KH):
    """The same live prefix in a 256- and a 1024-column cache gives the
    same bits: the tiles stop at kv_limit, whatever S is."""
    port, _, _ = bf16_case(T, NH, KH, 32, 1024, 200, False, seed=3)
    q, k, v, mask, lim = port
    cut = (q, k[:, :, :256].contiguous(), v[:, :, :256].contiguous(),
           mask[:, :, :256].contiguous(), lim)
    assert torch.equal(tiled_order_attention(*port),
                       tiled_order_attention(*cut))


def test_row_layout_by_shape():
    """Column quarters exactly at R = G*T <= 16: llama_7b decode (G 1,
    T 16) and llama_1b at T = 1 (G 8); 64-row tiles at llama_1b decode
    (T 60) and the T = 128 prefill."""
    assert row_layout(16, 32, 32) == "quarters"
    assert row_layout(1, 32, 4) == "quarters"
    assert row_layout(13, 32, 32) == "quarters"
    assert row_layout(17, 32, 32) == "rows"
    assert row_layout(60, 32, 4) == "rows"
    assert row_layout(128, 32, 32) == "rows"
