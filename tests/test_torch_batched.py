"""samd_tpu_torch's batched serving against samd_tpu's: ``update_slot``,
the forward with per-slot ``[B]`` write offsets (plain and int8 caches),
batched retrieval, and ``BatchedFusedSamEngine``'s token streams (plain and
int8 weights, corpus, inline prefill, EOS and readmission) against JAX's
batched engine, the port's single-stream engine and its own ``alpha=0``
oracle; streaming chunks; sampling raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import QuantizedKV as JaxQKV
from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.cache import update_slot as jax_update_slot
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import BatchedFusedSamEngine as JaxBatched
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.ops.quant import quantize_llama_params
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import QuantizedKV, init_kv_cache, update_slot
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.fused_base import _retrieval_draft_argform
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine, suffix_match)
from samd_tpu_torch.models import block_decode_mask, forward
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

FSC = dict(n_predicts=15, steps_per_call=6, corpus_capacity=256)
# one compile for every call of a shape (JAX's eager scan compiles anew)
jax_forward_jit = jax.jit(jax_forward, static_argnums=(1,))
KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def prompts(n, seed=5, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [int(rng.integers(10, 24)) for _ in range(n)]
    return [rng.integers(3, 128, size=s).tolist() for s in sizes[:n]]


def serve_jax(jcfg, jp, ps, new, fsc=None, **kw):
    eng = JaxBatched(jcfg, jp, JaxFsc(**(fsc or FSC)), **{**KW, **kw})
    ids = [eng.add_request(p, JaxGen(max_new_tokens=new, max_cache_len=256))
           for p in ps]
    out = eng.run()
    return [out[i] for i in ids]


def serve(engine, ps, new):
    ids = [engine.add_request(p, GenerationConfig(max_new_tokens=new,
                                                  max_cache_len=256))
           for p in ps]
    out = engine.run()
    assert set(out) == set(ids)
    return [out[i] for i in ids]


def batched(tcfg, tp, fsc=None, **kw):
    return BatchedFusedSamEngine(tcfg, tp, FusedSamConfig(**(fsc or FSC)),
                                 device="cpu", **{**KW, **kw})


def same_streams(got, want, steps=True):
    for g, w in zip(got, want):
        assert g.output_ids == w.output_ids
        assert g.decode_tokens == w.decode_tokens
        if steps:
            assert g.decode_steps == w.decode_steps


@pytest.mark.parametrize("quant", [False, True])
def test_update_slot_matches_jax(quant):
    rng = np.random.default_rng(1)
    L, B, KH, S, D = 2, 3, 2, 16, 8
    if quant:
        def pair(b):
            return (rng.integers(-127, 128, (L, b, KH, S, D)).astype(np.int8),
                    rng.random((L, b, KH, S)).astype(np.float32))
        (kq, ks), (fq, fs) = pair(B), pair(1)
        want = jax_update_slot(JaxQKV(jnp.asarray(kq), jnp.asarray(ks)),
                               JaxQKV(jnp.asarray(fq), jnp.asarray(fs)),
                               jnp.int32(1))
        kv = QuantizedKV(torch.from_numpy(kq.copy()),
                         torch.from_numpy(ks.copy()))
        out = update_slot(kv, QuantizedKV(torch.from_numpy(fq),
                                          torch.from_numpy(fs)), 1)
        assert out is kv
        np.testing.assert_array_equal(kv.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(kv.scale.numpy(),
                                      np.asarray(want.scale))
    else:
        k = rng.standard_normal((L, B, KH, S, D)).astype(np.float32)
        f = rng.standard_normal((L, 1, KH, S, D)).astype(np.float32)
        want = jax_update_slot(jnp.asarray(k), jnp.asarray(f), jnp.int32(2))
        kv = torch.from_numpy(k.copy())
        assert update_slot(kv, torch.from_numpy(f), 2) is kv
        np.testing.assert_array_equal(kv.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="batch-1"):
        update_slot(torch.zeros(L, B, KH, S, D), torch.zeros(L, 1, KH, 8, D),
                    0)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_per_slot_offset_forward_matches_jax(tiny_model, kv_quant):
    """Three slots prefilled at other lengths (JAX's batch-1 prefills,
    written into both batched caches with each package's update_slot, so
    the two start from the same bytes), then one [B, M] tree-verify block
    at per-slot offsets, one of them past S - M (the clamped write): logits
    within 1e-4 of JAX's, every int8 cache byte equal.  (The two packages'
    f32 matmuls sum in other orders, so a block's K or V row can reach the
    quantizer a few ulps apart: its scale then agrees to 1e-5, and in rare
    rows a byte moves one step, which moves later logits by ~1e-2.  These
    inputs have no such byte, as the check shows.)"""
    jcfg, jp, tcfg, tp = tiny_model
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tcfg = dataclasses.replace(tcfg, kv_quant=kv_quant)
    B, S, P, M = 3, 64, 32, 8
    rng = np.random.default_rng(4)
    lens = [20, 7, 60]
    jk, jv = jax_init_kv(jcfg, B, S)
    tk, tv = init_kv_cache(tcfg, B, S, "cpu")
    for b, n in enumerate(lens):
        tok = np.zeros((1, P), np.int32)
        tok[0, :min(n, P)] = rng.integers(0, 128, min(n, P))
        pos = np.arange(P, dtype=np.int32)[None]
        fk, fv = jax_init_kv(jcfg, 1, S)
        _, _, fk, fv = jax_forward_jit(jp, jcfg, jnp.asarray(tok),
                                   jnp.asarray(pos), fk, fv, jnp.int32(0),
                                   jax_prefill_mask(1, P, S))
        jk = jax_update_slot(jk, fk, jnp.int32(b))
        jv = jax_update_slot(jv, fv, jnp.int32(b))
        for cache, f in ((tk, fk), (tv, fv)):
            if kv_quant:
                f = QuantizedKV(torch.from_numpy(np.array(f.q)),
                                torch.from_numpy(np.array(f.scale)))
            else:
                f = torch.from_numpy(np.array(f))
            update_slot(cache, f, b)
    parents = np.array([-1] + [rng.integers(0, i) for i in range(1, M)])
    tree = np.tril(np.ones((M, M), bool))
    for i in range(M):                    # ancestor closure of parents
        tree[i] = False
        j = i
        while j >= 0:
            tree[i, j] = True
            j = parents[j]
    offs = np.array(lens, np.int32)
    vtok = rng.integers(0, 128, (B, M)).astype(np.int32)
    vpos = (offs[:, None] + np.arange(M)).astype(np.int32)
    jmask = jnp.stack([jax_block_mask(jnp.asarray(tree), jnp.int32(o), S)[0]
                       for o in offs])
    jl, _, jk, jv = jax_forward_jit(jp, jcfg, jnp.asarray(vtok),
                                jnp.asarray(vpos), jk, jv, jnp.asarray(offs),
                                jmask)
    tmask = block_decode_mask(torch.from_numpy(tree).expand(B, M, M),
                              torch.from_numpy(offs), S)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    tl, _ = forward(tp, tcfg, torch.from_numpy(vtok), torch.from_numpy(vpos),
                    tk, tv, torch.from_numpy(offs), tmask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for t, j in ((tk, jk), (tv, jv)):
        if kv_quant:
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-4)


def test_batched_retrieval_equals_per_slot():
    """The slot axis of suffix_match and of the draft function: each slot
    equals its unbatched (B = 1) call, integer for integer."""
    rng = np.random.default_rng(4)
    B, S, C, Q, ext, M = 5, 64, 48, 4, 6, 8
    hist = torch.from_numpy(rng.integers(0, 4, (B, S)).astype(np.int32))
    lens = torch.tensor([0, 1, 17, 40, 64], dtype=torch.int32)
    starts = torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))
    corpus = torch.from_numpy(rng.integers(0, 4, C).astype(np.int32))
    clen = torch.tensor(C - 5, dtype=torch.int32)
    draft = _retrieval_draft_argform(S=S, max_ngram=Q, ext=ext, len_bias=1,
                                     block=M)
    got = draft(corpus, clen, hist, lens, starts)
    for b in range(B):
        one = draft(corpus, clen, hist[b:b + 1], lens[b:b + 1],
                    starts[b:b + 1])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o[0])
    query = torch.from_numpy(rng.integers(-1, 4, (B, Q)).astype(np.int32))
    tail = torch.from_numpy(rng.integers(-1, 4, (B, ext)).astype(np.int32))
    tlen = torch.tensor([0, 2, 6, 3, 1], dtype=torch.int32)
    m, e = suffix_match(hist, lens, query, tail, tlen, max_ngram=Q, ext=ext)
    for b in range(B):
        mb, eb = suffix_match(hist[b], lens[b], query[b], tail[b], tlen[b],
                              max_ngram=Q, ext=ext)
        assert (int(m[b]), int(e[b])) == (int(mb), int(eb))


def test_batched_matches_jax_and_single(tiny_model):
    """Five requests through two slots (readmission): token streams and
    step counts equal JAX's batched engine, tokens equal the port's
    single-stream engine."""
    jcfg, jp, tcfg, tp = tiny_model
    ps = prompts(5)
    want = serve_jax(jcfg, jp, ps, 24, batch_size=2)
    got = serve(batched(tcfg, tp, batch_size=2), ps, 24)
    same_streams(got, want)
    single = FusedSamEngine(tcfg, tp, FusedSamConfig(**FSC), device="cpu",
                            **KW)
    for g, p in zip(got, ps):
        s = single.generate(p, GenerationConfig(max_new_tokens=24,
                                                max_cache_len=256))
        assert g.output_ids == s.output_ids
        assert g.decode_tokens == s.decode_tokens


def test_batched_int8_weights_and_corpus_match_jax(tiny_model):
    """int8 weights with a corpus holding the requests' own continuation:
    long accepted drafts, equal to JAX's engine token for token."""
    jcfg, jp, tcfg, _ = tiny_model
    qp = quantize_llama_params(jp)
    tqp = params_from_jax(jax.tree.map(np.asarray, qp), "cpu")
    ps = prompts(3, seed=9, sizes=[12, 20, 16])
    probe = serve(batched(tcfg, tqp, batch_size=2), ps[:1], 24)[0]
    corpus = probe.output_ids + [0]
    want = serve_jax(jcfg, qp, ps, 24, batch_size=2, corpus=corpus)
    got = serve(batched(tcfg, tqp, batch_size=2, corpus=corpus), ps, 24)
    same_streams(got, want)
    assert got[0].output_ids == probe.output_ids
    assert got[0].decode_steps < probe.decode_steps


def test_batched_equals_own_alpha0_oracle(tiny_model):
    """Speculative batched decoding equals the same engine at alpha = 0
    (draft length 1: block-M AR through the same [B, M] forward), with a
    corpus of the oracle's own output and a repetitive prompt, on the
    plain and the flash route."""
    _, _, tcfg, tp = tiny_model
    ps = prompts(3, seed=21, sizes=[14, 22, 9]) + [[7, 8, 9] * 6]
    for impl in ("xla", "flash"):
        cfg = dataclasses.replace(tcfg, attention_impl=impl)
        oracle = serve(batched(cfg, tp, {**FSC, "alpha": 0.0},
                               batch_size=3), ps, 30)
        corpus = sum((o.output_ids + [0] for o in oracle[:2]), [])
        fast = serve(batched(cfg, tp, batch_size=3, corpus=corpus), ps, 30)
        for f, o in zip(fast, oracle):
            assert f.output_ids == o.output_ids
        assert sum(f.decode_steps for f in fast) \
            < sum(o.decode_steps for o in oracle)


def test_inline_prefill_matches_jax(tiny_model):
    """Inline prefill (the prompt streams through the decode steps, M
    tokens at a time) against JAX's inline engine and the port's one-shot
    prefill: prompts shorter than, equal to and longer than a block, an EOS
    inside a prompt, five requests through two slots."""
    jcfg, jp, tcfg, tp = tiny_model
    kw = dict(prefill_buckets=(64,), batch_size=2, eos_token_id=7)
    rng = np.random.default_rng(13)
    ps = [rng.integers(3, 128, size=s).tolist() for s in (5, 16, 17, 33, 40)]
    ps[0][2] = 7
    want = serve_jax(jcfg, jp, ps, 24, inline_prefill=True, **kw)
    got = serve(batched(tcfg, tp, inline_prefill=True, **kw), ps, 24)
    same_streams(got, want)
    same_streams(got, serve(batched(tcfg, tp, **kw), ps, 24), steps=False)


def test_inline_prefill_with_corpus_matches_single(tiny_model):
    """Inline prefill with a corpus of the prompts themselves equals the
    single-stream engine (the reference's own check,
    ``tests/test_inline_prefill.py:65-84``)."""
    _, _, tcfg, tp = tiny_model
    rng = np.random.default_rng(11)
    ps = [rng.integers(3, 128, size=s).tolist() for s in (5, 16, 17)]
    corpus = sum([p + [0] for p in ps], [])
    got = serve(batched(tcfg, tp, inline_prefill=True, corpus=corpus,
                        batch_size=3, prefill_buckets=(64,)), ps, 24)
    single = FusedSamEngine(tcfg, tp, FusedSamConfig(**FSC), corpus=corpus,
                            device="cpu", **{**KW, "prefill_buckets": (64,)})
    for g, p in zip(got, ps):
        assert g.output_ids == single.generate(p, GenerationConfig(
            max_new_tokens=24, max_cache_len=256)).output_ids


def test_streaming_chunks_equal_outputs(tiny_model):
    """Progress listeners receive each request's generated tokens, in
    segment-sized chunks that concatenate to its output; a listener that
    raises does not stop the batch."""
    _, _, tcfg, tp = tiny_model
    ps = prompts(3, seed=31)
    eng = batched(tcfg, tp, batch_size=2)
    seen = {0: [], 2: []}
    eng.progress_listeners[0] = seen[0].extend
    eng.progress_listeners[2] = seen[2].extend

    def broken(chunk):
        raise RuntimeError("client went away")

    eng.progress_listeners[1] = broken
    out = serve(eng, ps, 20)
    for rid in (0, 2):
        assert seen[rid] == out[rid].output_ids[len(ps[rid]):]
        assert len(seen[rid]) == 20


def test_sampling_request_raises(tiny_model):
    _, _, tcfg, tp = tiny_model
    eng = batched(tcfg, tp, batch_size=2)
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.add_request([5, 6, 7], GenerationConfig(
            max_new_tokens=4, greedy=False, temperature=0.8))
    with pytest.raises(ValueError, match="non-empty"):
        eng.add_request([])
