"""Long prompts over caches of several buckets, and the fused engine on
int8 and fp8 weights: samd_tpu_torch against samd_tpu at tiny sizes.

A prompt that fills the largest prefill bucket (120 tokens in the 128-row
bucket, the verify attention's largest block) over a 512-slot cache that
the single stream cuts into buckets: the prefill's and a decode block's
logits within 1e-4 of JAX's (its interpret-mode Pallas kernel), and the
single-stream and paged engines token for token equal to JAX's.  Then
``FusedSamEngine`` on int8 and ``float8_e4m3fn`` weights carried from
JAX by the bridge, equal to JAX's engine and to the port's own block-M
``ArBaseline``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.fused_sam import PagedBatchedFusedSamEngine as JaxPaged
from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.ops.quant import quantize_llama_params
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import init_kv_cache
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_sam import (FusedSamConfig, FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.models import block_decode_mask, forward, prefill_mask
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

S = 512                      # the cache; the single stream cuts it to W
BUCKETS = (64, 128)          # prefill buckets: 120 tokens fill the largest
CACHE_BUCKETS = (256, 384)
M = 16                       # verify block (n_predicts 15)
NEW = 24
LOGITS_TOL = 1e-4            # f32 logits, two summation orders


@pytest.fixture(scope="module")
def tiny_model():
    """The tiny f32 model with the reference's flash route (its Pallas
    kernel in interpret mode) and the port's counterpart config."""
    jcfg = dataclasses.replace(tiny_config(vocab_size=128),
                               attention_impl="flash_interpret")
    jp = init_params(jcfg, jax.random.PRNGKey(3), scale=0.4)
    tcfg = port_config(jcfg)
    assert tcfg.attention_impl == "flash"
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def long_prompts(n=3, seed=31):
    """A 120-token prompt (the 128-row bucket, nearly full), then prompts
    of 100 and 60 tokens (the 128- and 64-row buckets)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 128, size=s).tolist() for s in (120, 100, 60)[:n]]


def test_full_bucket_prefill_logits_match_jax(tiny_model):
    """The 120-token prompt's prefill in the 128-row bucket over 512 slots,
    then a 16-row chain block behind it: each block's logits within 1e-4
    of JAX's, the argmax equal, through the verify attention (the plain
    version of the kernel on the CPU) in the port and JAX's
    interpret-mode kernel."""
    jcfg, jp, tcfg, tp = tiny_model
    prompt = long_prompts(1)[0]
    P, n = BUCKETS[-1], len(prompt)
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :n] = prompt
    pos = np.arange(P, dtype=np.int32)[None]
    jk, jv = jax_init_kv(jcfg, 1, S)
    tk, tv = init_kv_cache(tcfg, 1, S, "cpu")
    jl, _, jk, jv = jax_forward(jp, jcfg, jnp.asarray(tokens),
                                jnp.asarray(pos), jk, jv, jnp.int32(0),
                                jax_prefill_mask(1, P, S))
    tl, _ = forward(tp, tcfg, torch.from_numpy(tokens),
                    torch.from_numpy(pos), tk, tv, 0, prefill_mask(1, P, S))
    pairs = [(np.asarray(jl)[0, :n], tl.numpy()[0, :n])]
    chain = np.tril(np.ones((M, M), bool))
    block = np.random.default_rng(5).integers(3, 128, (1, M)).astype(
        np.int32)
    bpos = (np.arange(M, dtype=np.int32) + n)[None]
    jl, _, jk, jv = jax_forward(
        jp, jcfg, jnp.asarray(block), jnp.asarray(bpos), jk, jv,
        jnp.int32(n), jax_block_mask(jnp.asarray(chain), jnp.int32(n), S))
    tl, _ = forward(tp, tcfg, torch.from_numpy(block),
                    torch.from_numpy(bpos), tk, tv,
                    torch.tensor(n, dtype=torch.int32),
                    block_decode_mask(torch.from_numpy(chain), n, S))
    pairs.append((np.asarray(jl)[0], tl.numpy()[0]))
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_full_bucket_single_stream_matches_jax(tiny_model):
    """The three prompts through ``FusedSamEngine`` with cache buckets of
    256 and 384 under S 512: tokens, decode steps and the cache bucket
    equal JAX's engine; the port's own ArBaseline(block_size=16) over the
    whole 512-slot cache gives the same tokens."""
    jcfg, jp, tcfg, tp = tiny_model
    kw = dict(max_cache_len=S, eos_token_id=-1, prefill_buckets=BUCKETS)
    jeng = JaxFused(jcfg, jp, JaxFsc(n_predicts=M - 1, steps_per_call=8,
                                     len_bias=0,
                                     cache_buckets=CACHE_BUCKETS), **kw)
    teng = FusedSamEngine(tcfg, tp, FusedSamConfig(
        n_predicts=M - 1, len_bias=0, cache_buckets=CACHE_BUCKETS),
        device="cpu", **kw)
    oracle = ArBaseline(tcfg, tp, block_size=M, device="cpu", **kw)
    for p in long_prompts():
        want = jeng.generate(p, JaxGen(max_new_tokens=NEW, max_cache_len=S))
        gen = GenerationConfig(max_new_tokens=NEW, max_cache_len=S)
        got = teng.generate(p, gen)
        assert teng.kv_k.shape[3] == 256            # W = 256 < S = 512
        assert got.output_ids == want.output_ids
        assert got.decode_steps == want.decode_steps
        assert got.output_ids == oracle.generate(p, gen).output_ids


def test_full_bucket_paged_matches_jax(tiny_model):
    """The three prompts through the paged engine, two slots over pages of
    16 (the 120-token prompt's bucket takes 8 pages): tokens and steps
    equal JAX's paged engine (its interpret-mode K4), every page back."""
    jcfg, jp, tcfg, tp = tiny_model
    fsc = dict(n_predicts=M - 1, steps_per_call=6, corpus_capacity=256)
    kw = dict(max_cache_len=S, eos_token_id=-1, prefill_buckets=BUCKETS,
              batch_size=2, n_pages=48, page_size=16)
    ps = long_prompts()
    jeng = JaxPaged(jcfg, jp, JaxFsc(**fsc), interpret=True, **kw)
    ids = [jeng.add_request(p, JaxGen(max_new_tokens=NEW, max_cache_len=S))
           for p in ps]
    jout = jeng.run()
    teng = PagedBatchedFusedSamEngine(tcfg, tp, FusedSamConfig(**fsc),
                                      device="cpu", **kw)
    tids = [teng.add_request(p, GenerationConfig(max_new_tokens=NEW,
                                                 max_cache_len=S))
            for p in ps]
    tout = teng.run()
    for i, t in zip(ids, tids):
        assert tout[t].output_ids == jout[i].output_ids
        assert tout[t].decode_steps == jout[i].decode_steps
    assert len(teng.pool._free) == 48 and teng.live_kv_tokens() == 0


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn"])
def test_fused_quantized_weights_match_jax(qdtype):
    """``FusedSamEngine`` on int8 or fp8 (e4m3) weights, quantized by JAX
    and carried across by the bridge (the dequantize-then-matmul route of
    both packages): tokens and steps equal JAX's engine and the port's own
    ArBaseline(block_size=16), on a plain prompt and with the oracle's
    output as the corpus (long accepted drafts)."""
    jcfg = tiny_config(vocab_size=128)
    jp = quantize_llama_params(init_params(jcfg, jax.random.PRNGKey(4),
                                           scale=0.4),
                               dtype=getattr(jnp, qdtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["layers"]["wq"].q.dtype == getattr(torch, qdtype)
    tcfg = port_config(jcfg)
    kw = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
    gen = GenerationConfig(max_new_tokens=32, max_cache_len=256)
    prompt = np.random.default_rng(9).integers(3, 128, size=20).tolist()
    ref = ArBaseline(tcfg, tp, block_size=M, device="cpu", **kw).generate(
        prompt, gen)
    for corpus in (None, ref.output_ids + [0]):
        want = JaxFused(jcfg, jp, JaxFsc(n_predicts=M - 1, steps_per_call=8,
                                         len_bias=0), corpus=corpus, **kw
                        ).generate(prompt, JaxGen(max_new_tokens=32,
                                                  max_cache_len=256))
        got = FusedSamEngine(tcfg, tp, FusedSamConfig(n_predicts=M - 1,
                                                      len_bias=0),
                             corpus=corpus, device="cpu", **kw
                             ).generate(prompt, gen)
        assert got.output_ids == want.output_ids == ref.output_ids
        assert got.decode_steps == want.decode_steps
    assert got.decode_steps < NEW        # the corpus run drafted long
