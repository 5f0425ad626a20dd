"""The reference's remaining model families in the port, against samd_tpu
at tiny sizes: a Qwen2 tree quantized to int4 (its biases kept) and its
forward, Qwen2 and MoE trees quantized to each type, a grouped-query group
of 7 (Qwen2-7B's 28 query heads over 4 KV heads), retrieval over Qwen2's
152064-token vocabulary with ids past 2^17, and the full-width presets
field by field.

Tolerances: logits within 1e-4 (f32 products summed in another order, as
``test_torch_model.py`` and ``test_torch_quant.py`` hold them); packed
bytes, scales, drafts and greedy streams exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu import models as jm
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_base import _retrieval_draft_argform as jax_draft_fn
from samd_tpu.fused_base import build_optional_index as jax_index_of
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.ops import quant as jq
from samd_tpu_torch import models as tm
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_base import (_retrieval_draft_argform,
                                       build_optional_index,
                                       load_corpus_buffer)
from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
from samd_tpu_torch.models.configs import check_supported
from samd_tpu_torch.ops import quant as tq
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config
from test_torch_quant import forward_both, kernel_cfg, raw

QWEN2_V = 152064          # Qwen2's vocabulary: ids up to 2^17 + 21000
HIGH = 1 << 17


def to_port(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def same_bytes(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(raw(a), raw(b))


def quantized_parts(w):
    return [getattr(w, f.name) for f in dataclasses.fields(w)]


def check_close(pairs):
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------------------
# (a) Qwen2 on int4 weights
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_int4_tree_matches_jax(dtype):
    """A Qwen2 tree (q/k/v biases) through ``quantize_llama_params(dtype=
    INT4)`` in each package: packed bytes and scales equal, the biases
    the very tensors given, in their own type."""
    jcfg = jm.tiny_qwen2_config(vocab_size=64, dtype=getattr(jnp, dtype))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(5), scale=0.1)
    want = to_port(jq.quantize_llama_params(jp, dtype=jnp.int4))
    tp = to_port(jp)
    got = tq.quantize_llama_params(tp, dtype=tq.INT4)
    for name in tq.PROJECTIONS:
        w = got["layers"][name]
        assert isinstance(w, tq.Int4Tensor), name
        for a, b in zip(quantized_parts(w),
                        quantized_parts(want["layers"][name])):
            assert same_bytes(a, b), name
    for a, b in zip(quantized_parts(got["lm_head"]),
                    quantized_parts(want["lm_head"])):
        assert same_bytes(a, b)
    for name in ("bq", "bk", "bv"):
        assert got["layers"][name] is tp["layers"][name]
        assert got["layers"][name].dtype == getattr(torch, dtype)
        assert same_bytes(got["layers"][name], want["layers"][name])


@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
def test_qwen2_int4_forward_matches_jax(impl):
    """Each package quantizes its own copy of one float Qwen2 tree; a
    prefill and a tree verify over the int4 weights agree within 1e-4,
    the port's kernel route (K3's plain version on the CPU) against the
    reference's interpret-mode Pallas kernel."""
    jcfg = kernel_cfg(int4_impl=impl, attn_bias=True, rope_theta=1e6)
    jfloat = jm.init_params(jcfg, jax.random.PRNGKey(2), scale=0.1)
    jp = jq.quantize_llama_params(jfloat, dtype=jnp.int4)
    tp = tq.quantize_llama_params(to_port(jfloat), dtype=tq.INT4)
    assert isinstance(tp["layers"]["wq"], tq.Int4Tensor)
    pairs, (jk, jv), (tk, tv) = forward_both(jcfg, jp, port_config(jcfg), tp)
    check_close(pairs)
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------------
# (b) the other quantized types over both families' stacks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn", "int4"])
@pytest.mark.parametrize("family", ["qwen2", "moe"])
def test_family_tree_quantization_matches_jax(family, qdtype):
    """A bf16 Qwen2 tree (q/k/v biases; [L, in, out] stacks) and an MoE
    tree ([L, E, in, out] expert stacks, a router) through
    ``quantize_llama_params`` in each package: every leaf's bytes equal,
    the biases and the router kept as given."""
    make = {"qwen2": jm.tiny_qwen2_config, "moe": jm.tiny_moe_config}[family]
    jcfg = make(vocab_size=64, dtype=jnp.bfloat16)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3), scale=0.3)
    want = to_port(jq.quantize_llama_params(
        jp, dtype=jnp.int4 if qdtype == "int4" else getattr(jnp, qdtype)))
    tp = to_port(jp)
    got = tq.quantize_llama_params(
        tp, dtype=tq.INT4 if qdtype == "int4" else getattr(torch, qdtype))
    want_t, got_t = list(tq.tensors(want)), list(tq.tensors(got))
    assert len(want_t) == len(got_t)
    for a, b in zip(want_t, got_t):
        assert same_bytes(a, b)
    kept = ("bq", "bk", "bv") if family == "qwen2" else ("router",)
    for name in kept:
        assert got["layers"][name] is tp["layers"][name]


# ----------------------------------------------------------------------
# (c) a group of 7 query heads per KV head
# ----------------------------------------------------------------------

def g7_config():
    """Qwen2-7B's group G = 7 at a tiny width: 14 query heads over 2 KV
    heads of 16, q/k/v biases, rope theta 1e6, f32."""
    return dataclasses.replace(jm.tiny_qwen2_config(vocab_size=128),
                               num_heads=14, num_kv_heads=2)


@pytest.fixture(scope="module")
def g7_model():
    jcfg = g7_config()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(9), scale=0.4)
    return jcfg, jp, to_port(jp)


@pytest.mark.parametrize("impl", ["xla", "flash_interpret"])
def test_g7_forward_matches_jax(g7_model, impl):
    """A prefill and a tree verify at G 7 within 1e-4 of JAX's; on the
    flash route the port's plain version of the verify kernel against
    JAX's interpret-mode kernel, rows packed as r = g·T + t."""
    jcfg, jp, tp = g7_model
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    assert port_config(jcfg).kv_groups == 7
    pairs, (jk, jv), (tk, tv) = forward_both(jcfg, jp, port_config(jcfg),
                                             tp)
    check_close(pairs)
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("own_corpus", [False, True])
def test_g7_fused_stream_matches_jax_and_oracle(g7_model, own_corpus):
    """The fused-SAM greedy stream at G 7 on the flash route equals JAX's
    engine (interpret-mode kernel) and the port's own block-M oracle, the
    steps too; with the oracle's output as the corpus it drafts long."""
    jcfg, jp, tp = g7_model
    tcfg = port_config(jcfg)               # attention_impl "flash"
    fc_kw = dict(n_predicts=15, len_bias=0)
    kw = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
    new = 40
    prompt = np.random.default_rng(11).integers(3, 128, size=24).tolist()
    oracle = ArBaseline(tcfg, tp, block_size=16, device="cpu", **kw)
    ref = oracle.generate(prompt, GenerationConfig(max_new_tokens=new,
                                                   max_cache_len=256))
    corpus = ref.output_ids + [0] if own_corpus else None
    jflash = dataclasses.replace(jcfg, attention_impl="flash_interpret")
    want = JaxFused(jflash, jp, JaxFsc(steps_per_call=8, **fc_kw),
                    corpus=corpus, **kw).generate(
        prompt, JaxGen(max_new_tokens=new, max_cache_len=256))
    got = FusedSamEngine(tcfg, tp, FusedSamConfig(**fc_kw), corpus=corpus,
                         device="cpu", **kw).generate(
        prompt, GenerationConfig(max_new_tokens=new, max_cache_len=256))
    assert got.output_ids == want.output_ids == ref.output_ids
    assert (got.decode_steps, got.decode_tokens) \
        == (want.decode_steps, want.decode_tokens)
    if own_corpus:
        assert got.decode_steps < new // 2


# ----------------------------------------------------------------------
# (d) retrieval over a 152064-token vocabulary
# ----------------------------------------------------------------------

def high_ids(rng, n):
    return rng.integers(HIGH, QWEN2_V, size=n)


def high_corpus(rng):
    """Token ids in [2^17, 152064): random stretches and one repeated
    eight-token stretch."""
    return np.concatenate([high_ids(rng, 300), np.tile(high_ids(rng, 8), 12),
                           high_ids(rng, 200)]).astype(np.int32)


@pytest.mark.parametrize("indexed", [False, True])
def test_retrieval_drafts_high_ids_match_jax(indexed):
    """The fused engines' retrieval draft (the history's own suffix match
    against the corpus scan, or the n-gram index probe) at ids past 2^17:
    match lengths, sources, draft tokens and available lengths equal
    JAX's exactly, slot by slot."""
    rng = np.random.default_rng(17)
    S, cap = 256, 1024
    corpus = high_corpus(rng)
    fc = dict(corpus_capacity=cap, indexed=indexed, len_bias=0)
    tcfg, jcfg = FusedSamConfig(**fc), JaxFsc(**fc)
    tbuf, tlen = load_corpus_buffer(corpus.tolist(), cap, "cpu")
    jbuf = jnp.asarray(tbuf.numpy())
    tidx = build_optional_index(corpus.tolist(), tcfg, "cpu")
    jidx = jax_index_of(corpus.tolist(), jcfg)
    assert (tidx is None) == (jidx is None) == (not indexed)
    kw = dict(S=S, max_ngram=tcfg.max_ngram, ext=tcfg.ext, len_bias=0,
              block=tcfg.block)
    tdraft, jdraft = _retrieval_draft_argform(**kw), jax_draft_fn(**kw)
    hist = np.full((8, S), -1, np.int32)
    lens, starts = [], []
    for b in range(8):
        n = int(rng.integers(20, 120))
        if b % 3 == 0:                     # a corpus stretch: long matches
            a = int(rng.integers(0, len(corpus) - n - 1))
            row, start = corpus[a:a + n], corpus[a + n]
        elif b % 3 == 1:                   # its own repeats: history wins
            row = np.tile(high_ids(rng, 5), n // 5 + 1)[:n]
            start = row[n - 5]
        else:
            row, start = high_ids(rng, n), high_ids(rng, 1)[0]
        hist[b, :n] = row
        lens.append(n)
        starts.append(int(start))
    got = tdraft(tbuf, tlen, torch.from_numpy(hist),
                 torch.tensor(lens, dtype=torch.int32),
                 torch.tensor(starts, dtype=torch.int32), tidx)
    matches = []
    for b in range(8):
        want = jdraft(jbuf, jnp.int32(len(corpus)), jidx,
                      jnp.asarray(hist[b]), jnp.int32(lens[b]),
                      jnp.int32(starts[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
        matches.append(int(want[0]))
    assert min(matches[0::3]) > 0 and min(matches[1::3]) > 0
    assert int(got[2][:, 1:].max()) >= HIGH


@pytest.fixture(scope="module")
def qwen2_vocab_model():
    jcfg = jm.tiny_qwen2_config(vocab_size=QWEN2_V)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3), scale=0.4)
    return jcfg, jp, to_port(jp)


@pytest.mark.parametrize("indexed", [False, True])
def test_fused_stream_vocab_152064_matches_jax(qwen2_vocab_model, indexed):
    """A tiny Qwen2 at the full 152064-token vocabulary (hidden 64): a
    prompt of ids past 2^17 and a corpus of them holding the engine's own
    continuation; the greedy stream and its steps equal JAX's, through
    the corpus scan or the index probe."""
    jcfg, jp, tp = qwen2_vocab_model
    rng = np.random.default_rng(23)
    prompt = high_ids(rng, 24).tolist()
    kw = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
    fc = dict(n_predicts=15, len_bias=0, corpus_capacity=1024,
              indexed=indexed)
    gen_kw = dict(max_new_tokens=32, max_cache_len=256)
    probe = JaxFused(jcfg, jp, JaxFsc(steps_per_call=8, **fc), **kw
                     ).generate(prompt, JaxGen(**gen_kw))
    corpus = high_ids(rng, 64).tolist() + probe.output_ids + [0]
    want = JaxFused(jcfg, jp, JaxFsc(steps_per_call=8, **fc), corpus=corpus,
                    **kw).generate(prompt, JaxGen(**gen_kw))
    got = FusedSamEngine(port_config(jcfg), tp, FusedSamConfig(**fc),
                         corpus=corpus, device="cpu", **kw).generate(
        prompt, GenerationConfig(**gen_kw))
    assert got.output_ids == want.output_ids == probe.output_ids
    assert (got.decode_steps, got.decode_tokens) \
        == (want.decode_steps, want.decode_tokens)
    assert got.decode_steps < probe.decode_steps
    assert max(got.output_ids) >= HIGH


# ----------------------------------------------------------------------
# (e) the full-width presets
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2_7b", "llama3_8b", "llama_7b",
                                  "llama_13b", "llama_1b", "mixtral_8x7b"])
def test_presets_match_jax(name):
    """Every field of the port's preset equals JAX's, but the two routes,
    which the port defaults to its kernels; ``check_supported`` takes
    each."""
    got = getattr(tm, name)()
    want = port_config(getattr(jm, name)())
    assert (got.attention_impl, got.int4_impl) == ("flash", "kernel")
    assert dataclasses.replace(got, attention_impl=want.attention_impl,
                               int4_impl=want.int4_impl) == want
    check_supported(got)
