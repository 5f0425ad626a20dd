"""samd_tpu_torch's fused SAM[Token Recycle] hybrid against samd_tpu's:
the constant draft buffers, a tree block's logits, ``FusedHybridEngine``
(greedy with and without a corpus, zero weights, cache buckets, int8 KV,
sampled), ``BatchedFusedHybridEngine`` (against JAX's and the single
stream, readmission, mixed sampling, inline prefill, int8 KV),
``PagedBatchedFusedHybridEngine`` (pools of q's type and int8, int4
weights) and ``paged_kv.paged_compact_block``.  Token streams, decode
steps, retrieval steps and harvest tables equal JAX's exactly; logits agree
within 1e-4 (f32).  Mirrors ``tests/test_fused_hybrid.py``,
``test_batched_hybrid.py``, ``test_paged_fused.py:143,246``,
``test_inline_prefill.py:151`` and ``test_kv_quant.py:110,223``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_hybrid import BatchedFusedHybridEngine as JaxBatched
from samd_tpu.fused_hybrid import FusedHybridConfig as JaxHy
from samd_tpu.fused_hybrid import FusedHybridEngine as JaxHybrid
from samd_tpu.fused_hybrid import PagedBatchedFusedHybridEngine as JaxPaged
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops.treeops import unpack_draft as jax_unpack
from samd_tpu.paged_kv import PagedKV as JaxPagedKV
from samd_tpu.paged_kv import paged_compact_block as jax_compact
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEngine,
                                         FusedHybridConfig, FusedHybridEngine,
                                         PagedBatchedFusedHybridEngine,
                                         build_tr_topology, constant_buffers)
from samd_tpu_torch.models import block_decode_mask, forward
from samd_tpu_torch.ops.quant import INT4, quantize_llama_params as t_quant
from samd_tpu_torch.paged_kv import PagedKV, paged_compact_block
from test_torch_batched import jax_forward_jit
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
# the reference tests' two small hybrid configurations
SMALL = dict(n_predicts=12, tree_nodes=15, topk=4, max_block=16,
             steps_per_call=6, corpus_capacity=256)
HY = dict(max_ngram=4, ext=12, n_predicts=8, len_threshold=2, len_bias=0,
          tree_nodes=13, topk=4, max_block=16, corpus_capacity=1024,
          steps_per_call=4)
PAGE = 16


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def prompts(n, seed=7, lo=10, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 128, size=int(rng.integers(lo, hi))).tolist()
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


def single(tcfg, tp, hy=SMALL, **kw):
    return FusedHybridEngine(tcfg, tp, FusedHybridConfig(**hy),
                             device="cpu", **{**KW, **kw})


def batched(tcfg, tp, hy=HY, paged=False, **kw):
    ctor = PagedBatchedFusedHybridEngine if paged \
        else BatchedFusedHybridEngine
    return ctor(tcfg, tp, FusedHybridConfig(**hy), device="cpu",
                **{**KW, **kw})


def oracle(tcfg, tp, M=16):
    return ArBaseline(tcfg, tp, block_size=M, device="cpu", **KW)


# ---------------------------------------------------------------------------
# the draft's constant buffers and a tree block's logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_predicts,tree_nodes,M,topk", [
    (12, 15, 16, 4), (8, 13, 16, 4), (20, 23, 24, 8), (40, 61, 64, 8)])
def test_constant_buffers_match_jax(n_predicts, tree_nodes, M, topk):
    """The chain, the tree (both self-parent padded to M) and the
    full-block chain, unpacked once on the host: mask, depths and paths
    equal JAX's in-loop ``unpack_draft``."""
    parents = build_tr_topology(tree_nodes, topk)[0]
    for p in (np.concatenate([np.arange(-1, n_predicts - 1),
                              np.arange(n_predicts, M)]),
              np.concatenate([parents, np.arange(len(parents), M)]),
              np.arange(-1, M - 1)):
        got = constant_buffers(p, M)
        want = jax_unpack(jnp.stack([jnp.zeros(M, jnp.int32),
                                     jnp.asarray(p, jnp.int32)]), M)[1:]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tree_block_logits_match_jax(tiny_model):
    """One verify forward of a 15-node tree block padded to 16 over a
    prefilled cache, from the same weights: logits within 1e-4."""
    jcfg, jp, tcfg, tp = tiny_model
    M, P, S = 16, 32, 64
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 128, (1, P)).astype(np.int32)
    tokens = rng.integers(0, 128, (1, M)).astype(np.int32)
    parents = np.concatenate([build_tr_topology(15, 4)[0], [15]])
    mask, depths, _ = constant_buffers(parents, M)
    jk, jv = (jnp.zeros((jcfg.num_layers, 1, jcfg.num_kv_heads, S,
                         jcfg.head_dim), jnp.float32),) * 2
    from samd_tpu.models.llama import block_decode_mask as jmask
    from samd_tpu.models.llama import prefill_mask as jpre
    _, _, jk, jv = jax_forward_jit(jp, jcfg, jnp.asarray(prefix),
                                   jnp.arange(P)[None], jk, jv,
                                   jnp.int32(0), jpre(1, P, S))
    jl, _, _, _ = jax_forward_jit(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(depths.numpy())[None] + P,
        jk, jv, jnp.int32(P), jmask(jnp.asarray(mask.numpy()), P, S))
    tk = torch.from_numpy(np.asarray(jk).copy())
    tv = torch.from_numpy(np.asarray(jv).copy())
    tl, _ = forward(tp, tcfg, torch.from_numpy(tokens), depths[None] + P,
                    tk, tv, P, block_decode_mask(mask, P, S))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# FusedHybridEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_single(tiny_model):
    jcfg, jp, _, _ = tiny_model
    return JaxHybrid(jcfg, jp, JaxHy(**SMALL), **KW)


def test_hybrid_equals_ar_and_jax(tiny_model, jax_single):
    """Three requests through one engine on each side: streams, decode and
    retrieval steps, and the harvest and seen tables after the run equal
    JAX's; every output equals the block-16 AR oracle's."""
    _, _, tcfg, tp = tiny_model
    eng = single(tcfg, tp)
    ar = oracle(tcfg, tp)
    jg, tg = gens(32)
    for p in prompts(3, seed=0, lo=20, hi=21):
        got = eng.generate(p, tg)
        same(got, jax_single.generate(p, jg))
        assert eng.sam_steps == jax_single.sam_steps
        assert got.output_ids == ar.generate(p, tg).output_ids
    np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                  np.asarray(jax_single.harvest))
    np.testing.assert_array_equal(eng.seens[0].numpy(),
                                  np.asarray(jax_single.seen))
    assert eng.steps_total == jax_single.steps_total


def test_hybrid_uses_retrieval_with_corpus(tiny_model):
    """A corpus holding the output: retrieval chains carry it, with the
    same retrieval steps as JAX's engine, in fewer steps than without."""
    jcfg, jp, tcfg, tp = tiny_model
    jg, tg = gens(32)
    p = prompts(1, seed=1, lo=20, hi=21)[0]
    ref = single(tcfg, tp).generate(p, tg)
    corpus = ref.output_ids + [0]
    hy = {**SMALL, "len_bias": 0}
    eng = single(tcfg, tp, hy, corpus=corpus)
    jeng = JaxHybrid(jcfg, jp, JaxHy(**hy), corpus=corpus, **KW)
    got = eng.generate(p, tg)
    same(got, jeng.generate(p, jg))
    assert got.output_ids == ref.output_ids
    assert got.decode_steps < ref.decode_steps
    assert eng.sam_steps == jeng.sam_steps > 0


def test_hybrid_tree_branch_on_deterministic_stream(tiny_model, jax_single):
    """Zero weights: once 0's top-K is harvested every tree path is a
    0-chain (each level repeats one token: the duplicate-row scatter), and
    whole paths are accepted before retrieval can; steps and tables equal
    JAX's from fresh tables."""
    _, jp, tcfg, _ = tiny_model
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jax_single.params = zeros
    jax_single.harvest = jnp.zeros_like(jax_single.harvest)
    jax_single.seen = jnp.zeros_like(jax_single.seen)
    eng = single(tcfg, params_from_jax(jax.tree.map(np.asarray, zeros),
                                       "cpu"))
    p = prompts(1, seed=2, lo=24, hi=25)[0]
    jg, tg = gens(40)
    try:
        got = eng.generate(p, tg)
        same(got, jax_single.generate(p, jg))
    finally:
        jax_single.params = jp
    assert got.output_ids[len(p):] == [0] * 40
    assert got.decode_steps < 20
    np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                  np.asarray(jax_single.harvest))


@pytest.mark.parametrize("mode", ["rejection", "typical", "nucleus"])
def test_hybrid_sampling_mode(tiny_model, mode):
    """Seeded sampling under each tree rule is reproducible on a fresh
    engine (the harvest persists across requests) and another seed draws
    another stream; a point-mass request (every draw forced) equals the
    greedy oracle."""
    _, _, tcfg, tp = tiny_model
    p = prompts(1, seed=3, lo=18, hi=19)[0]
    knobs = {"rejection": dict(top_k=50), "typical": {},
             "nucleus": dict(top_p=0.9)}[mode]

    def run(seed, temperature=0.8, **kw):
        g = GenerationConfig(max_new_tokens=20, max_cache_len=256,
                             greedy=False, temperature=temperature,
                             seed=seed, accept_mode=mode, **{**knobs, **kw})
        return single(tcfg, tp).generate(p, g)

    a, b, c = run(5), run(5), run(6)
    assert a.output_ids == b.output_ids and a.decode_tokens == 20
    assert c.output_ids != a.output_ids
    point = dict(top_p=1e-6) if mode == "nucleus" else dict(top_k=1)
    if mode != "typical":
        want = oracle(tcfg, tp).generate(p, gens(20)[1]).output_ids
        assert run(9, temperature=1e-5, **point).output_ids == want


def test_hybrid_cache_buckets_match_full_cache(tiny_model):
    """``cache_buckets``: a request in a 64-slot window equals the
    full-cache engine's, and the window is what it ran in."""
    _, _, tcfg, tp = tiny_model
    base = dict(n_predicts=12, len_threshold=3, tree_nodes=13, topk=4,
                steps_per_call=5, corpus_capacity=256, max_block=16)
    g = gens(20)[1]
    full = single(tcfg, tp, base)
    win = single(tcfg, tp, {**base, "cache_buckets": (64, 128)})
    for p in prompts(2, seed=23, lo=16, hi=17):
        assert win.generate(p, g).output_ids == \
            full.generate(p, g).output_ids
        assert win.kv_k.shape[3] == 64 and full.kv_k.shape[3] == 256


def test_hybrid_kv_quant_lossless(tiny_model):
    """Tree drafts and their compaction through the int8 KV cache: equal
    to JAX's int8-KV engine (streams, steps, tables) and to the port's
    int8-KV block-16 oracle."""
    jcfg, jp, tcfg, tp = tiny_model
    jq = dataclasses.replace(jcfg, kv_quant=True)
    tq = dataclasses.replace(tcfg, kv_quant=True)
    hy = {k: v for k, v in HY.items() if k != "steps_per_call"}
    eng = single(tq, tp, hy)
    jeng = JaxHybrid(jq, jp, JaxHy(**hy), **KW)
    jg, tg = gens(24)
    p = prompts(1, seed=4, lo=20, hi=21)[0]
    got = eng.generate(p, tg)
    same(got, jeng.generate(p, jg))
    assert got.output_ids == oracle(tq, tp).generate(p, tg).output_ids
    np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                  np.asarray(jeng.harvest))


# ---------------------------------------------------------------------------
# BatchedFusedHybridEngine
# ---------------------------------------------------------------------------

def test_batched_hybrid_matches_jax_and_single_stream(tiny_model):
    """Five requests through two slots with a corpus (readmission): streams,
    decode and retrieval steps and each slot's harvest and seen tables
    equal JAX's batched engine's; the first three equal the port's
    single-stream engine on fresh tables and the block-16 oracle."""
    jcfg, jp, tcfg, tp = tiny_model
    ps = prompts(5, seed=11)
    corpus = sum([p + [0] for p in ps[:3]], [])
    jg, tg = gens(24)
    eng = batched(tcfg, tp, corpus=corpus, batch_size=2)
    got = serve(eng, ps, tg)
    jeng = JaxBatched(jcfg, jp, JaxHy(**HY), corpus=corpus, batch_size=2,
                      **KW)
    ids = [jeng.add_request(p, jg) for p in ps]
    want = jeng.run()
    for g, i in zip(got, ids):
        same(g, want[i])
    assert eng.sam_steps_total == jeng.sam_steps_total > 0
    assert eng.steps_total == jeng.steps_total
    np.testing.assert_array_equal(eng.harvests.numpy(),
                                  np.asarray(jeng.harvests))
    np.testing.assert_array_equal(eng.seens.numpy(), np.asarray(jeng.seens))
    ar = oracle(tcfg, tp)
    for g, p in zip(got, ps):
        assert g.output_ids == ar.generate(p, tg).output_ids
    for g, p in zip(got[:3], ps):
        one = single(tcfg, tp, HY, corpus=corpus).generate(p, tg)
        assert one.output_ids == g.output_ids


def test_batched_hybrid_mixed_sampling(tiny_model):
    """A sampled slot beside greedy ones: greedy outputs equal the oracle,
    the whole batch is reproducible, and a point-mass slot equals the
    greedy oracle."""
    _, _, tcfg, tp = tiny_model
    ps = prompts(3, seed=13)
    g = gens(16)[1]
    s = GenerationConfig(max_new_tokens=16, max_cache_len=256, greedy=False,
                         temperature=0.8, seed=3)
    refs = [oracle(tcfg, tp).generate(p, g).output_ids for p in ps]

    def run(gs):
        return [o.output_ids for o in serve(batched(tcfg, tp, batch_size=3),
                                            ps, gs)]

    a, b = run([g, g, s]), run([g, g, s])
    assert a == b and a[:2] == refs[:2]
    assert a[2][:len(ps[2])] == ps[2] and len(a[2]) == len(ps[2]) + 16
    pm = GenerationConfig(max_new_tokens=16, max_cache_len=256,
                          greedy=False, temperature=1e-5, top_k=1, seed=4)
    assert run([pm, g, pm]) == refs


def test_inline_prefill_hybrid_matches_one_shot(tiny_model):
    """Inline prefill: the per-block harvest covers the prompt rows as the
    one-shot prefill's does, so outputs and later tree drafts (hence the
    decode steps) match the one-shot engine's, dense and paged; every page
    comes back."""
    _, _, tcfg, tp = tiny_model
    ps = prompts(5, seed=29)
    g = gens(20)[1]
    kw = dict(batch_size=2, prefill_buckets=(64,))
    want = serve(batched(tcfg, tp, **kw), ps, g)
    for eng in (batched(tcfg, tp, inline_prefill=True, **kw),
                batched(tcfg, tp, paged=True, n_pages=32, page_size=PAGE,
                        inline_prefill=True, **kw)):
        got = serve(eng, ps, g)
        for a, b in zip(got, want):
            assert a.output_ids == b.output_ids
    assert len(eng.pool._free) == 32


def test_batched_hybrid_kv_quant_lossless(tiny_model):
    """Batched trees over the int8 dense cache (compact_accepted_batched on
    values and scales): every output equals the int8-KV block-16 oracle's."""
    _, _, tcfg, tp = tiny_model
    tq = dataclasses.replace(tcfg, kv_quant=True)
    g = gens(16)[1]
    ps = prompts(3, seed=9, lo=10, hi=20)
    ar = oracle(tq, tp)
    for o, p in zip(serve(batched(tq, tp, batch_size=2), ps, g), ps):
        assert o.output_ids == ar.generate(p, g).output_ids


# ---------------------------------------------------------------------------
# PagedBatchedFusedHybridEngine and paged_compact_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_paged_hybrid_matches_jax_and_dense(tiny_model, quantized):
    """Tree drafts compacted on the pages: over a pool of q's type the
    streams equal the dense engine's; over int8 pages they equal JAX's
    paged engine's (streams and steps); every page comes back."""
    jcfg, jp, tcfg, tp = tiny_model
    hy = dict(n_predicts=12, len_threshold=3, tree_nodes=13, topk=4,
              steps_per_call=5, corpus_capacity=256, max_block=16)
    jg, g = gens(20)
    ps = prompts(4, seed=21)
    eng = batched(tcfg, tp, hy, paged=True, batch_size=2, n_pages=32,
                  page_size=PAGE, quantized_kv=quantized)
    got = serve(eng, ps, g)
    assert len(eng.pool._free) == 32
    if not quantized:
        want = serve(batched(tcfg, tp, hy, batch_size=2), ps, g)
        for a, b in zip(got, want):
            same(a, b)
        return
    jeng = JaxPaged(jcfg, jp, JaxHy(**hy), batch_size=2, n_pages=32,
                    page_size=PAGE, quantized_kv=True, interpret=True, **KW)
    ids = [jeng.add_request(p, jg) for p in ps]
    want = jeng.run()
    for a, i in zip(got, ids):
        same(a, want[i])


def test_int4_paged_hybrid_matches_dense():
    """int4 weights (the K3 route's plain version) through the dense and
    the paged hybrid: the same streams and steps."""
    jcfg = tiny_config(vocab_size=128)
    tcfg = port_config(jcfg)
    tp = t_quant(params_from_jax(jax.tree.map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(1), scale=0.4)),
        "cpu"), dtype=INT4)
    hy = dict(steps_per_call=4, tree_nodes=7, n_predicts=6, max_block=8)
    g = gens(12)[1]
    ps = prompts(3, seed=13, lo=10, hi=18)
    want = serve(batched(tcfg, tp, hy, batch_size=2), ps, g)
    eng = batched(tcfg, tp, hy, paged=True, batch_size=2, n_pages=24,
                  page_size=PAGE)
    for a, b in zip(serve(eng, ps, g), want):
        same(a, b)
    assert len(eng.pool._free) == 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_compact_block_matches_jax(dtype):
    """Shuffled page tables, a block that crosses a page boundary, a slot
    without pages (its rows read and write the scratch page) and tree
    paths: every page but the scratch page equals JAX's compaction, values
    and (int8) scales."""
    L, KH, D, page, n = 2, 2, 8, 4, 12
    B, M, A, P = 3, 6, 5, 4
    rng = np.random.default_rng(len(dtype))
    perm = rng.permutation(n)
    tables = np.full((B, P), -1, np.int32)
    tables[0, :3] = perm[:3]
    tables[1, :4] = perm[3:7]          # slot 2 holds no pages
    offsets = np.array([3, 9, 5], np.int32)
    paths = np.stack([np.sort(rng.choice(M, A, replace=False))
                      for _ in range(B)]).astype(np.int32)
    paths[:, 0] = 0
    shape = (L, n + 1, KH, page, D)
    if dtype == "int8":
        pool = rng.integers(-127, 128, shape).astype(np.int8)
        scale = rng.random(shape[:-1]).astype(np.float32)
    else:
        pool = rng.standard_normal(shape).astype(np.float32)
        scale = None
    tdt = getattr(torch, dtype)
    tc = PagedKV(torch.from_numpy(pool.copy()).to(tdt),
                 None if scale is None else torch.from_numpy(scale.copy()))
    jc = JaxPagedKV(
        jnp.asarray(np.swapaxes(pool, -1, -2)).astype(getattr(jnp, dtype)),
        None if scale is None else jnp.asarray(scale[:, :, :, None, :]))
    assert paged_compact_block(tc, torch.from_numpy(tables),
                               torch.from_numpy(offsets),
                               torch.from_numpy(paths), M, n) is tc
    want = jax_compact(jc, jnp.asarray(tables), jnp.asarray(offsets),
                       jnp.asarray(paths), M, n)
    wp = np.swapaxes(np.asarray(want.pool.astype(jnp.float32)), -1, -2)
    np.testing.assert_array_equal(tc.pool[:, :n].float().numpy(),
                                  wp[:, :n])
    if scale is not None:
        np.testing.assert_array_equal(tc.scale[:, :n].numpy(),
                                      np.asarray(want.scale)[:, :n, :, 0])
    # pages outside every table are untouched
    free = perm[7:]
    np.testing.assert_array_equal(tc.pool[:, free].float().numpy(),
                                  torch.from_numpy(pool).to(tdt)[:, free]
                                  .float().numpy())
