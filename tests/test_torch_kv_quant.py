"""The int8 KV cache of samd_tpu_torch against samd_tpu's: the quantizer's
bytes, compaction, the verify attention's int8 mode (its plain version,
against JAX's interpret-mode int8 kernel), the forward with ``kv_quant``,
and int4 + int8-KV engines against their own oracle and JAX's engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import QuantizedKV as JaxQKV
from samd_tpu.cache import compact_accepted as jax_compact
from samd_tpu.cache import dequantize_kv as jax_dequantize_kv
from samd_tpu.cache import quantize_kv_block as jax_quantize_kv_block
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.ops.pallas_attention import flash_block_attention as jax_flash
from samd_tpu.ops.quant import quantize_llama_params
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import (QuantizedKV, compact_accepted,
                                  dequantize_kv, init_kv_cache,
                                  quantize_kv_block)
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
from samd_tpu_torch.ops.flash_attention import flash_block_attention
from samd_tpu_torch.ops.quant import INT4, quantize_llama_params as t_quant
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config
from test_torch_quant import forward_both, kernel_cfg


def bf16_to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_block_matches_jax(dtype):
    """Bytes and scales equal the reference's quantizer as its engines run
    it, under jit."""
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((1, 4, 33, 16))
         * rng.random((1, 4, 33, 1)) * 3).astype(np.float32)
    b[0, 1, 2] = 0                       # an all-zero row: the 1e-12 floor
    jb = jnp.asarray(b).astype(getattr(jnp, dtype))
    want_q, want_s = jax.jit(jax_quantize_kv_block)(jb)
    tb = torch.from_numpy(b) if dtype == "float32" else bf16_to_torch(jb)
    got_q, got_s = quantize_kv_block(tb)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the bf16 pre-dequant of the plain attention route, bitwise
    want = jax_dequantize_kv(JaxQKV(want_q, want_s), jnp.bfloat16,
                             ds_layout=False)
    got = dequantize_kv(QuantizedKV(got_q, got_s), torch.bfloat16)
    assert torch.equal(got, bf16_to_torch(want))


@pytest.mark.parametrize("seed", range(3))
def test_compact_quantized_kv_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    L, KH, S, D, M = 2, 2, 48, 8, 12
    q = rng.integers(-127, 128, (L, 1, KH, S, D)).astype(np.int8)
    s = rng.random((L, 1, KH, S)).astype(np.float32)
    offset = int(rng.integers(0, S - M + 1))
    idx = rng.integers(0, M, M).astype(np.int32)
    want = jax_compact(JaxQKV(jnp.asarray(q), jnp.asarray(s)),
                       jnp.int32(offset), jnp.asarray(idx), M)
    kv = QuantizedKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
    out = compact_accepted(kv, torch.tensor(offset), torch.from_numpy(idx), M)
    assert out is kv                                  # in place
    np.testing.assert_array_equal(kv.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(kv.scale.numpy(), np.asarray(want.scale))


def test_quantized_cache_views_and_reset():
    cfg = dataclasses.replace(port_config(tiny_config()), kv_quant=True)
    k, _ = init_kv_cache(cfg, 1, 32, "cpu")
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert isinstance(k, QuantizedKV) and tuple(k.shape) == (L, 1, KH, 32, D)
    assert k.scale.shape == (L, 1, KH, 32) and k.scale.dtype == torch.float32
    layer = k[1]
    layer.q.fill_(3)
    layer.scale.fill_(0.5)
    assert (k.q[1] == 3).all() and (k.scale[1] == 0.5).all()   # views
    assert k.zero_() is k and not k.q.any() and not k.scale.any()


@pytest.mark.parametrize("T,NH,KH,D,S,cache_len,block_s", [
    (5, 4, 2, 16, 64, 23, 32),       # K1 regime, GQA
    (8, 8, 2, 16, 128, 40, 64),
    (8, 4, 4, 16, 128, 120, 64),     # kv_limit == S
    (5, 8, 8, 16, 128, 37, 512),     # K2 (fold-KV) regime, KH >= 8
    (16, 16, 8, 32, 256, 180, 128),  # K2, GQA, deeper prefix
    (16, 4, 2, 16, 1024, 1000, 512),  # several tiles, live prefix near S
    (16, 10, 10, 16, 512, 300, 128),  # K2 at a head count not a power of 2
])
def test_int8_attention_matches_jax_interpret(T, NH, KH, D, S, cache_len,
                                              block_s):
    """The int8 mode's plain version against the reference's int8 kernel
    (its "ds" layout, interpret mode) on the same quantized cache, within
    2e-4."""
    rng = np.random.default_rng(T + S)

    def cache():
        return (rng.integers(-127, 128, (1, KH, S, D)).astype(np.int8),
                (0.01 + rng.random((1, KH, S))).astype(np.float32))

    (kq, ks), (vq, vs) = cache(), cache()
    q = rng.standard_normal((1, T, NH, D)).astype(np.float32)
    tree = jnp.tril(jnp.ones((T, T), bool))
    mask = np.array(jax_block_mask(tree, jnp.int32(cache_len), S))
    kv_limit = cache_len + T
    want = jax_flash(
        jnp.asarray(q),
        JaxQKV(jnp.asarray(kq.transpose(0, 1, 3, 2)), jnp.asarray(ks)),
        JaxQKV(jnp.asarray(vq.transpose(0, 1, 3, 2)), jnp.asarray(vs)),
        jnp.asarray(mask), jnp.int32(kv_limit), block_s=block_s,
        pre_transposed=True, interpret=True)
    before = flash_block_attention.launches_int8
    got = flash_block_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(mask), torch.tensor(kv_limit, dtype=torch.int32),
        torch.from_numpy(ks), torch.from_numpy(vs))
    assert flash_block_attention.launches_int8 == before  # CPU: plain
    assert got.shape == (1, T, NH * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_int8_attention_dead_tail_not_read():
    """int8 bytes of ±127 and scales of 1e30 past kv_limit change nothing."""
    rng = np.random.default_rng(3)
    KH, S, D, T, cl = 2, 64, 16, 5, 20
    args = [torch.from_numpy(rng.standard_normal((1, T, 4, D))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(-127, 128, (1, KH, S, D))
                             .astype(np.int8)),
            torch.from_numpy(rng.integers(-127, 128, (1, KH, S, D))
                             .astype(np.int8))]
    scales = [torch.rand(1, KH, S) + 0.01, torch.rand(1, KH, S) + 0.01]
    tree = torch.tril(torch.ones(T, T, dtype=torch.bool))
    from samd_tpu_torch.models import block_decode_mask
    mask = block_decode_mask(tree, cl, S).contiguous()
    lim = torch.tensor(cl + T, dtype=torch.int32)
    got = flash_block_attention(*args, mask, lim, *scales)
    for t in args[1:]:
        t[:, :, cl + T:] = 127
    for t in scales:
        t[:, :, cl + T:] = 1e30
    assert torch.equal(got, flash_block_attention(*args, mask, lim, *scales))


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_forward_kv_quant_matches_jax(route):
    """Logits within 1e-4, and the int8 cache equal to JAX's (the "ds"
    cache permuted to "sd").  The two packages' f32 matmuls sum in other
    orders, so a K or V row can reach the quantizer a few ulps apart: where
    a row's scale (its amax / 127) agrees to the bit, its bytes must too;
    elsewhere the scale agrees to 1e-5 and a byte to one step.  The JAX
    flash route needs its "ds" layout; its plain route runs "sd"."""
    jcfg = dataclasses.replace(tiny_config(vocab_size=128), kv_quant=True)
    if route == "flash":
        jcfg = dataclasses.replace(jcfg, kv_layout="ds", flash_block_s=32,
                                   attention_impl="flash_interpret")
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = port_config(jcfg)
    assert tcfg.kv_quant and tcfg.kv_layout == "sd"
    pairs, (jk, jv), (tk, tv) = forward_both(jcfg, jp, tcfg, tp)
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for j, t in ((jk, tk), (jv, tv)):
        jq = np.asarray(j.q)
        if route == "flash":
            jq = jq.transpose(0, 1, 2, 4, 3)
        same = t.scale.numpy() == np.asarray(j.scale)
        assert same.mean() > 0.5
        np.testing.assert_array_equal(t.q.numpy()[same], jq[same])
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-5, atol=0)
        assert np.abs(t.q.numpy().astype(int) - jq).max() <= 1


@pytest.fixture(scope="module")
def int4_kv_model():
    """int4 weights on the reference's kernel test shape, with int8 KV."""
    jcfg = kernel_cfg(int4_impl="kernel_interpret", kv_quant=True)
    jp = quantize_llama_params(init_params(jcfg, jax.random.PRNGKey(0),
                                           scale=0.4), dtype=jnp.int4)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_fused_int4_kv_quant_matches_jax(int4_kv_model):
    """The port's int4 + int8-KV engine, its own block-M oracle and the
    reference's engine (its interpret-mode int4 kernel, plain attention)
    give the same tokens; the port's flash route gives them too."""
    jcfg, jp, tp = int4_kv_model
    M, S, new = 8, 128, 16
    prompt = np.random.default_rng(7).integers(3, 512, size=12).tolist()
    kw = dict(max_cache_len=S, eos_token_id=-1, prefill_buckets=(16,))
    want = JaxFused(jcfg, jp, JaxFsc(n_predicts=M - 1, steps_per_call=64,
                                     corpus_capacity=256, len_bias=0), **kw
                    ).generate(prompt, JaxGen(max_new_tokens=new,
                                              max_cache_len=S))
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    for impl in ("xla", "flash"):
        tcfg = dataclasses.replace(port_config(jcfg), attention_impl=impl)
        assert tcfg.int4_impl == "kernel" and tcfg.kv_quant
        got = FusedSamEngine(tcfg, tp, FusedSamConfig(
            n_predicts=M - 1, corpus_capacity=256, len_bias=0),
            device="cpu", **kw).generate(prompt, gen)
        ref = ArBaseline(tcfg, tp, block_size=M, device="cpu",
                         **kw).generate(prompt, gen)
        assert got.output_ids == ref.output_ids, impl
        assert got.output_ids == want.output_ids, impl
        assert got.decode_steps == want.decode_steps, impl


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_fused_int4_kv_quant_equals_own_oracle(impl):
    """int4 + int8 KV, fused engine against its own ArBaseline(block_size=M)
    on a corpus holding the oracle's own output (long accepted drafts,
    compaction of the int8 cache in the oracle) and on a repetitive
    prompt."""
    jcfg = tiny_config(vocab_size=128)
    tcfg = dataclasses.replace(port_config(jcfg), kv_quant=True,
                               int4_impl="kernel", attention_impl=impl)
    tp = t_quant(params_from_jax(jax.tree.map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(1), scale=0.4)),
        "cpu"), dtype=INT4)
    fc = FusedSamConfig(n_predicts=15, len_bias=0)
    gen = GenerationConfig(max_new_tokens=40, max_cache_len=256)
    kw = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,),
              device="cpu")
    oracle = ArBaseline(tcfg, tp, block_size=fc.block, **kw)
    rng = np.random.default_rng(11)
    for p in (rng.integers(3, 128, size=24).tolist(), [7, 8, 9] * 8):
        ref = oracle.generate(p, gen)
        out = FusedSamEngine(tcfg, tp, fc, corpus=ref.output_ids + [0],
                             **kw).generate(p, gen)
        assert out.output_ids == ref.output_ids
        assert len(out.output_ids) == len(p) + 40


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bucketed_prompt_over_128_equals_oracle(kv_quant):
    """A prompt whose prefill bucket exceeds the flash route's 128 rows
    prefills through the plain attention into a cache bucket W smaller than
    the oracle's S; the two prefills must still agree, so the tokens equal
    the oracle's."""
    jcfg = tiny_config(vocab_size=128)
    tcfg = dataclasses.replace(port_config(jcfg), kv_quant=kv_quant)
    tp = params_from_jax(jax.tree.map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(2), scale=0.4)),
        "cpu")
    fc = FusedSamConfig(n_predicts=15, len_bias=0, cache_buckets=(256, 384))
    gen = GenerationConfig(max_new_tokens=24, max_cache_len=512)
    kw = dict(max_cache_len=512, eos_token_id=-1, prefill_buckets=(128, 256),
              device="cpu")
    prompt = np.random.default_rng(12).integers(3, 128, size=150).tolist()
    ref = ArBaseline(tcfg, tp, block_size=fc.block, **kw).generate(prompt,
                                                                    gen)
    eng = FusedSamEngine(tcfg, tp, fc, **kw)
    out = eng.generate(prompt, gen)
    assert eng.kv_k.shape[3] == 256                   # W = 256 < S = 512
    assert out.output_ids == ref.output_ids
