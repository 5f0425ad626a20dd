"""samd_tpu_torch's fused SAM engine against samd_tpu's: suffix retrieval
integer for integer, and token streams and step counts on shared weights;
and the port's fused engine against its own block-M AR oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.fused_sam import suffix_match as jax_suffix_match
from samd_tpu.models import init_params, tiny_config
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
from samd_tpu_torch.fused_sam import suffix_match
from samd_tpu_torch.models import ModelConfig
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def both_match(buf, buf_len, query, tail, tail_len, Q, ext):
    want = jax_suffix_match(jnp.asarray(buf, jnp.int32), jnp.int32(buf_len),
                            jnp.asarray(query, jnp.int32),
                            jnp.asarray(tail, jnp.int32),
                            jnp.int32(tail_len), max_ngram=Q, ext=ext)
    got = suffix_match(torch.tensor(buf, dtype=torch.int32),
                       torch.tensor(buf_len, dtype=torch.int32),
                       torch.tensor(query, dtype=torch.int32),
                       torch.tensor(tail, dtype=torch.int32),
                       torch.tensor(tail_len, dtype=torch.int32),
                       max_ngram=Q, ext=ext)
    assert [int(x) for x in got] == [int(x) for x in want]
    return [int(x) for x in got]


def test_suffix_match_cases():
    # first occurrence of [4, 5, 6] ends at index 2
    assert both_match([4, 5, 6, 7, 1, 4, 5, 6, 0, 0], 8, [-1, 4, 5, 6],
                      [-1] * 8, 0, 4, 8) == [3, 2]
    # window match of 3 at end=5, extended backwards by [1, 2, 3]
    assert both_match([1, 2, 3, 4, 5, 6, 9, 1, 2, 3, 4, 5, 6, 0, 0, 0], 13,
                      [4, 5, 6], [-1] * 5 + [1, 2, 3], 3, 3, 8) == [6, 5]
    # no match
    assert both_match([1, 2, 3, 0], 3, [-1, 7, 8], [-1] * 4, 0, 3,
                      4)[0] == 0
    # ties: several equally long matches, the earliest end wins
    assert both_match([7, 8, 7, 8, 7, 8, 0, 0], 6, [-1, 7, 8], [-1] * 4, 0,
                      3, 4) == [2, 1]


@pytest.mark.parametrize("seed", range(12))
def test_suffix_match_random_matches_jax(seed):
    rng = np.random.default_rng(seed)
    L, Q, ext = 64, 4, 6
    vocab = 3 if seed % 2 else 5          # small vocab: many matches, ties
    buf = rng.integers(0, vocab, L)
    buf_len = int(rng.integers(0, L + 1))
    buf[buf_len:] = -1 if seed % 3 == 0 else buf[buf_len:]
    q_valid = int(rng.integers(0, Q + 1))          # -1 padding on the left
    query = np.concatenate([np.full(Q - q_valid, -1),
                            rng.integers(0, vocab, q_valid)])
    tail_len = int(rng.integers(0, ext + 1))
    tail = np.concatenate([np.full(ext - tail_len, -1),
                           rng.integers(0, vocab, tail_len)])
    both_match(buf.tolist(), buf_len, query.tolist(), tail.tolist(),
               tail_len, Q, ext)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = ModelConfig(**{**fields, "dtype": torch.float32})
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def run_both(tiny_model, impl, prompt, *, corpus=None, eos=-1, new=32,
             n_predicts=15, cache_buckets=()):
    jcfg, jp, tcfg, tp = tiny_model
    jimpl = {"xla": "xla", "flash": "flash_interpret"}[impl]
    kw = dict(corpus=corpus, max_cache_len=256, eos_token_id=eos,
              prefill_buckets=(32,))
    want = JaxFused(dataclasses.replace(jcfg, attention_impl=jimpl), jp,
                    JaxFsc(n_predicts=n_predicts, steps_per_call=8,
                           len_bias=0, cache_buckets=cache_buckets), **kw
                    ).generate(prompt, JaxGen(max_new_tokens=new,
                                              max_cache_len=256))
    got = FusedSamEngine(dataclasses.replace(tcfg, attention_impl=impl), tp,
                         FusedSamConfig(n_predicts=n_predicts, len_bias=0,
                                        cache_buckets=cache_buckets),
                         device="cpu", **kw
                         ).generate(prompt, GenerationConfig(
                             max_new_tokens=new, max_cache_len=256))
    assert got.output_ids == want.output_ids
    assert got.decode_steps == want.decode_steps
    assert got.decode_tokens == want.decode_tokens
    return got


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_fused_matches_jax(tiny_model, impl):
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 128, size=20).tolist()
    plain = run_both(tiny_model, impl, prompt)
    # a corpus holding the engine's own continuation: long drafts
    corpus = plain.output_ids + [0]
    fast = run_both(tiny_model, impl, prompt, corpus=corpus)
    assert fast.decode_steps < plain.decode_steps
    # a repetitive prompt: drafts from the request's own history
    run_both(tiny_model, impl, [5, 9, 17, 33] * 5)
    # EOS inside an accepted draft ends the request there
    eos = plain.output_ids[len(prompt) + 6]
    out = run_both(tiny_model, impl, prompt, corpus=corpus, eos=eos)
    gen = out.output_ids[len(prompt):]
    assert gen.index(eos) == len(gen) - 1


def test_fused_cache_bucket_matches_jax(tiny_model):
    """A request whose reachable length fits a smaller cache bucket runs
    on a cache of that size, in both packages alike."""
    prompt = np.random.default_rng(3).integers(3, 128, size=20).tolist()
    run_both(tiny_model, "xla", prompt, new=24, cache_buckets=(64, 128))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_fused_equals_own_oracle(tiny_model, impl):
    _, _, tcfg, tp = tiny_model
    cfg = dataclasses.replace(tcfg, attention_impl=impl)
    fc = FusedSamConfig(n_predicts=15, len_bias=0)
    gen = GenerationConfig(max_new_tokens=40, max_cache_len=256)
    oracle = ArBaseline(cfg, tp, max_cache_len=256, eos_token_id=-1,
                        prefill_buckets=(32,), block_size=fc.block,
                        device="cpu")
    rng = np.random.default_rng(7)
    for p in (rng.integers(3, 128, size=24).tolist(), [7, 8, 9] * 8):
        ref = oracle.generate(p, gen)
        eng = FusedSamEngine(cfg, tp, fc, corpus=ref.output_ids[:40],
                             max_cache_len=256, eos_token_id=-1,
                             prefill_buckets=(32,), device="cpu")
        out = eng.generate(p, gen)
        assert out.output_ids == ref.output_ids
        assert len(out.output_ids) == len(p) + 40
