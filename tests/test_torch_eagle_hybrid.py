"""samd_tpu_torch's SAM[EAGLE-2] hybrid against samd_tpu's:
``FusedHybridEagleEngine`` (greedy, with a corpus),
``BatchedFusedHybridEagleEngine`` (against JAX's and the single stream,
readmission, mixed sampling, an int8 target) and
``PagedBatchedFusedHybridEagleEngine`` (pools of q's type and int8).  Token
streams, decode steps and retrieval steps equal JAX's exactly.  The draft
net's parameters are JAX's (``bridge.eagle_params_from_jax``).  Mirrors
``tests/test_batched_eagle.py`` and ``tests/test_fused_hybrid.py:99,123``.
"""

import jax
import numpy as np
import pytest

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.drafters.eagle.net import EagleNetConfig as JaxNetCfg
from samd_tpu.drafters.eagle.net import init_eagle_params as jax_init_net
from samd_tpu.fused_hybrid import BatchedFusedHybridEagleEngine as JaxBatched
from samd_tpu.fused_hybrid import FusedHybridEagleConfig as JaxHy
from samd_tpu.fused_hybrid import FusedHybridEagleEngine as JaxSingle
from samd_tpu.fused_hybrid import \
    PagedBatchedFusedHybridEagleEngine as JaxPaged
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops.quant import quantize_llama_params as jax_quant
from samd_tpu_torch.bridge import eagle_params_from_jax, params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEagleEngine,
                                         FusedHybridEagleConfig,
                                         FusedHybridEagleEngine,
                                         PagedBatchedFusedHybridEagleEngine)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
# the reference tests' two configurations
HY = dict(max_ngram=4, ext=12, n_predicts=8, len_threshold=2, len_bias=0,
          eagle_depth=2, eagle_topk=3, eagle_total=7, max_block=16,
          corpus_capacity=1024)
SINGLE = dict(n_predicts=12, eagle_depth=3, eagle_topk=4, eagle_total=15,
              max_block=16, steps_per_call=6, corpus_capacity=256)


def bridge(jcfg, jp, jnet):
    return (jcfg, jp, jnet, port_config(jcfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            eagle_params_from_jax(jax.tree.map(np.asarray, jnet), "cpu"))


@pytest.fixture(scope="module")
def model():
    """``test_batched_eagle.py``'s model (scale 0.3) and net (key 3)."""
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.3)
    return bridge(jcfg, jp, jax_init_net(JaxNetCfg.from_target(jcfg),
                                         jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def tiny_model():
    """``test_fused_hybrid.py``'s model (scale 0.4) and the reference
    engines' default net (key 7)."""
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return bridge(jcfg, jp, jax_init_net(JaxNetCfg.from_target(jcfg),
                                         jax.random.PRNGKey(7)))


def prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 128, size=int(rng.integers(10, 24))).tolist()
            for _ in range(n)]


def gens(n, **kw):
    return (JaxGen(max_new_tokens=n, max_cache_len=256, **kw),
            GenerationConfig(max_new_tokens=n, max_cache_len=256, **kw))


def same(got, want):
    assert got.output_ids == want.output_ids
    assert got.decode_tokens == want.decode_tokens
    assert got.decode_steps == want.decode_steps


def serve(engine, ps, gen):
    gs = gen if isinstance(gen, list) else [gen] * len(ps)
    ids = [engine.add_request(p, g) for p, g in zip(ps, gs)]
    out = engine.run()
    return [out[i] for i in ids]


def batched(m, params=None, paged=False, steps=4, **kw):
    ctor = PagedBatchedFusedHybridEagleEngine if paged \
        else BatchedFusedHybridEagleEngine
    return ctor(m[3], m[4] if params is None else params,
                FusedHybridEagleConfig(steps_per_call=steps, **HY),
                net_params=m[5], device="cpu", **{**KW, **kw})


def jax_batched(m, params=None, paged=False, steps=4, **kw):
    ctor = JaxPaged if paged else JaxBatched
    return ctor(m[0], m[1] if params is None else params,
                JaxHy(steps_per_call=steps, **HY), net_params=m[2],
                **{**KW, **kw})


# ---------------------------------------------------------------------------
# batched and paged
# ---------------------------------------------------------------------------

def test_batched_eagle_matches_jax_and_single_stream(model):
    """Three requests in three slots over a corpus of their prompts: each
    equals the single-stream engine's output and JAX's batched engine's,
    steps and retrieval steps included."""
    jg, tg = gens(24)
    ps = prompts(3)
    corpus = sum([p + [0] for p in ps], [])
    eng = batched(model, corpus=corpus, batch_size=3)
    outs = serve(eng, ps, tg)
    jeng = jax_batched(model, corpus=corpus, batch_size=3)
    for o, w in zip(outs, serve(jeng, ps, jg)):
        same(o, w)
    assert eng.sam_steps_total == jeng.sam_steps_total
    for p, o in zip(ps, outs):
        single = FusedHybridEagleEngine(
            model[3], model[4], FusedHybridEagleConfig(**HY),
            net_params=model[5], corpus=corpus, device="cpu", **KW)
        assert single.generate(p, tg).output_ids == o.output_ids


def test_batched_eagle_more_requests_than_slots(model):
    """Five requests through two slots (readmission): each equals the
    block-16 AR oracle's and JAX's."""
    jg, tg = gens(16)
    ps = prompts(5, seed=11)
    ar = ArBaseline(model[3], model[4], block_size=16, device="cpu", **KW)
    outs = serve(batched(model, batch_size=2), ps, tg)
    for p, o, w in zip(ps, outs, serve(jax_batched(model, batch_size=2), ps,
                                       jg)):
        assert o.output_ids == ar.generate(p, tg).output_ids
        same(o, w)


def test_batched_eagle_mixed_sampling(model):
    """A sampled slot beside greedy ones: the greedy outputs equal the AR
    oracle's; the run repeats exactly, the sampled request included."""
    tg = gens(16)[1]
    ts = GenerationConfig(max_new_tokens=16, max_cache_len=256, greedy=False,
                          temperature=0.8, seed=3)
    ps = prompts(3, seed=13)
    ar = ArBaseline(model[3], model[4], block_size=16, device="cpu", **KW)

    def run_once():
        return [o.output_ids for o in serve(batched(model, batch_size=3), ps,
                                            [tg, tg, ts])]

    a, b = run_once(), run_once()
    assert a == b
    for p, o in zip(ps[:2], a[:2]):
        assert o == ar.generate(p, tg).output_ids
    assert a[2][:len(ps[2])] == ps[2] and len(a[2]) == len(ps[2]) + 16


def test_batched_eagle_quantized_head(model):
    """int8 target weights: the expansion reads the quantized head; the
    batched outputs equal the single stream's and JAX's."""
    jq = jax_quant(model[1])
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    jg, tg = gens(12)
    ps = prompts(2, seed=17)
    outs = serve(batched(model, tq, batch_size=2), ps, tg)
    for o, w in zip(outs, serve(jax_batched(model, jq, batch_size=2), ps,
                                jg)):
        same(o, w)
    for p, o in zip(ps, outs):
        single = FusedHybridEagleEngine(
            model[3], tq, FusedHybridEagleConfig(**HY), net_params=model[5],
            device="cpu", **KW)
        assert single.generate(p, tg).output_ids == o.output_ids


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_batched_eagle_matches_jax_and_dense(model, quantized):
    """The target KV on pages of 16 (f32 or int8), the net KV dense: every
    output equals JAX's paged engine's and, for the f32 pool, the dense
    engine's; every page comes back."""
    jg, tg = gens(20)
    ps = prompts(4, seed=21)
    pages = dict(batch_size=2, n_pages=32, page_size=16,
                 quantized_kv=quantized)
    eng = batched(model, paged=True, steps=5, **pages)
    outs = serve(eng, ps, tg)
    assert len(eng.pool._free) == 32
    for o, w in zip(outs, serve(jax_batched(model, paged=True, steps=5,
                                            **pages), ps, jg)):
        same(o, w)
    if not quantized:
        dense = serve(batched(model, steps=5, batch_size=2), ps, tg)
        assert [o.output_ids for o in outs] == \
            [o.output_ids for o in dense]


# ---------------------------------------------------------------------------
# one stream
# ---------------------------------------------------------------------------

def test_hybrid_eagle_equals_ar_and_jax(tiny_model):
    m = tiny_model
    jg, tg = gens(32)
    eng = FusedHybridEagleEngine(m[3], m[4], FusedHybridEagleConfig(**SINGLE),
                                 net_params=m[5], device="cpu", **KW)
    jeng = JaxSingle(m[0], m[1], JaxHy(**SINGLE), net_params=m[2], **KW)
    ar = ArBaseline(m[3], m[4], device="cpu", **KW)
    rng = np.random.default_rng(10)
    for _ in range(2):
        p = rng.integers(3, 128, size=20).tolist()
        out = eng.generate(p, tg)
        assert out.output_ids == ar.generate(p, tg).output_ids
        same(out, jeng.generate(p, jg))
        assert eng.sam_steps == jeng.sam_steps


def test_hybrid_eagle_uses_retrieval_with_corpus(tiny_model):
    """With its own output as the corpus the hybrid drafts retrieval
    chains, takes fewer steps and keeps the output; as JAX's does."""
    m = tiny_model
    jg, tg = gens(32)
    hy = dict(SINGLE, len_bias=0)
    p = np.random.default_rng(11).integers(3, 128, size=20).tolist()
    ref = FusedHybridEagleEngine(m[3], m[4], FusedHybridEagleConfig(**hy),
                                 net_params=m[5], device="cpu",
                                 **KW).generate(p, tg)
    corpus = ref.output_ids + [0]
    eng = FusedHybridEagleEngine(m[3], m[4], FusedHybridEagleConfig(**hy),
                                 net_params=m[5], corpus=corpus,
                                 device="cpu", **KW)
    out = eng.generate(p, tg)
    assert out.output_ids == ref.output_ids
    assert out.decode_steps < ref.decode_steps and eng.sam_steps > 0
    jeng = JaxSingle(m[0], m[1], JaxHy(**hy), net_params=m[2], corpus=corpus,
                     **KW)
    same(out, jeng.generate(p, jg))
    assert eng.sam_steps == jeng.sam_steps
