"""samd_tpu_torch's paged serving against samd_tpu's: the boundary mask
window, the scratch-page remap, the page writes (bf16 rows, int8 bytes and
scales), K4's plain version against JAX's interpret-mode kernel, the paged
forward, and ``PagedBatchedFusedSamEngine``'s token streams: over pools
of q's type and int8 pages against JAX's paged engine; a tight pool and
inline prefill against the dense engine, int8 weights with a corpus
against the single-stream engine (the reference's own checks), with every
page recycled; and int4 weights over int8 pages against the engine's own
``alpha=0`` oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import PagedBatchedFusedSamEngine as JaxPaged
from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.ops.paged_attention import \
    boundary_mask_window as jax_window
from samd_tpu.ops.paged_attention import \
    paged_block_attention as jax_paged_attention
from samd_tpu.ops.paged_attention import window_pages as jax_window_pages
from samd_tpu.ops.quant import quantize_llama_params
from samd_tpu.paged_kv import PagedAux as JaxAux
from samd_tpu.paged_kv import PagedKVPool as JaxPool
from samd_tpu.paged_kv import PagedRequest as JaxRequest
from samd_tpu.paged_kv import PagedKV as JaxPagedKV
from samd_tpu.paged_kv import paged_flat_indices as jax_flat_indices
from samd_tpu.paged_kv import paged_write_block as jax_write_block
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.fused_sam import (FusedSamConfig, FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.models import forward
from samd_tpu_torch.ops.paged_attention import (boundary_mask_window,
                                                paged_block_attention,
                                                paged_block_attention_ref,
                                                window_pages)
from samd_tpu_torch.ops.quant import INT4, quantize_llama_params as t_quant
from samd_tpu_torch.paged_kv import (PagedAux, PagedKV, PagedKVPool,
                                     PagedRequest, paged_flat_indices,
                                     paged_write_block)
from test_torch_batched import (FSC, KW, batched, jax_forward_jit, prompts,
                                same_streams, serve)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

PAGE = 16


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def dp_to_port(a):
    """JAX's "dp" pages [..., KH, D, page] → the port's [..., KH, page, D]."""
    return np.swapaxes(np.asarray(a), -1, -2)


def random_tree(rng, T):
    tree = np.tril(np.ones((T, T), bool)) & (rng.random((T, T)) < 0.8)
    np.fill_diagonal(tree, True)
    return tree


@pytest.mark.parametrize("cache_len", [0, 5, 15, 16, 17, 31, 48])
def test_boundary_mask_window_matches_jax(cache_len):
    T = 8
    tree = random_tree(np.random.default_rng(cache_len), T)
    assert window_pages(T, PAGE) == jax_window_pages(T, PAGE)
    want = np.asarray(jax_window(jnp.asarray(tree), jnp.int32(cache_len),
                                 PAGE))
    got = boundary_mask_window(torch.from_numpy(tree), cache_len, PAGE)
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched form: one tree and one length per slot
    lens = torch.tensor([cache_len, 3, 40])
    trees = torch.from_numpy(np.stack([tree, tree[::-1, ::-1].T, tree]))
    both = boundary_mask_window(trees, lens, PAGE)
    for b in range(3):
        assert torch.equal(both[b], boundary_mask_window(trees[b],
                                                         int(lens[b]), PAGE))


def test_flat_indices_match_jax():
    """-1 table entries and rows past the table go to the scratch page,
    exactly as the reference's remap sends them."""
    rng = np.random.default_rng(2)
    tables = np.array([[4, 1, -1, -1], [0, 2, 3, 5], [-1, -1, -1, -1]],
                      np.int32)
    for offs in ([0, 40, 7], [30, 58, 0], [14, 63, 100]):
        offs = np.array(offs, np.int32)
        want = jax_flat_indices(jnp.asarray(tables), jnp.asarray(offs), 10,
                                PAGE, 6)
        got = paged_flat_indices(torch.from_numpy(tables),
                                 torch.from_numpy(offs), 10, PAGE, 6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (got[0] == 6).any()
        dest = got[0] * PAGE + got[1]
        live = dest[got[0] != 6]
        assert len(set(live.tolist())) == len(live)   # no clash off scratch
    del rng


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_write_block_matches_jax(quantized):
    """bf16 rows land where the reference puts them; int8 bytes and scales
    equal its jitted quantizer's, after the layout permutation."""
    rng = np.random.default_rng(3)
    n, KH, D, B, T = 6, 2, 8, 2, 10
    tables = np.array([[2, 0, -1], [5, 1, 3]], np.int32)
    offs = np.array([9, 30], np.int32)
    block = (rng.standard_normal((B, KH, T, D)) * 2).astype(np.float32)
    jt = jnp.asarray(tables)
    fp, fs = jax_flat_indices(jt, jnp.asarray(offs), T, PAGE, n)
    tp, ts = paged_flat_indices(torch.from_numpy(tables),
                                torch.from_numpy(offs), T, PAGE, n)
    if quantized:
        jcache = JaxPagedKV(jnp.zeros((n + 1, KH, D, PAGE), jnp.int8),
                            jnp.zeros((n + 1, KH, 1, PAGE), jnp.float32))
        want = jax.jit(jax_write_block)(jcache, jnp.asarray(block), fp, fs)
        cache = PagedKV(torch.zeros((n + 1, KH, PAGE, D), dtype=torch.int8),
                        torch.zeros((n + 1, KH, PAGE)))
        out = paged_write_block(cache, torch.from_numpy(block), tp, ts)
        assert out is cache
        np.testing.assert_array_equal(cache.pool.numpy(),
                                      dp_to_port(want.pool))
        np.testing.assert_array_equal(cache.scale.numpy(),
                                      np.asarray(want.scale)[:, :, 0])
    else:
        jb = jnp.asarray(block).astype(jnp.bfloat16)
        jcache = JaxPagedKV(jnp.zeros((n + 1, KH, D, PAGE), jnp.bfloat16),
                            None)
        want = jax_write_block(jcache, jb, fp, fs)
        tb = torch.from_numpy(np.array(jb).view(np.uint16)).view(
            torch.bfloat16)
        cache = PagedKV(torch.zeros((n + 1, KH, PAGE, D),
                                    dtype=torch.bfloat16), None)
        paged_write_block(cache, tb, tp, ts)
        got = cache.pool.view(torch.int16).numpy()
        np.testing.assert_array_equal(
            got[:n], dp_to_port(np.asarray(want.pool).view(np.int16))[:n])


def paged_inputs(rng, B, T, NH, KH, D, n_pages, committed, int8=False):
    """Shuffled tables over a random pool (JAX "dp" layout), windows of
    random trees, kv_limits = committed + T."""
    P = 4
    kp = rng.standard_normal((n_pages, KH, D, PAGE)).astype(np.float32)
    vp = rng.standard_normal((n_pages, KH, D, PAGE)).astype(np.float32)
    perm = rng.permutation(n_pages)
    tables = np.full((B, P), -1, np.int32)
    at = 0
    for b, c in enumerate(committed):
        npg = -(-(c + T) // PAGE)
        tables[b, :npg] = perm[at:at + npg]
        at += npg
    wins = np.stack([np.asarray(jax_window(jnp.asarray(random_tree(rng, T)),
                                           jnp.int32(c), PAGE))
                     for c in committed])
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    return q, kp, vp, tables, wins, np.array(committed, np.int32) + T


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_plain_matches_jax_kernel(int8):
    """The plain version against JAX's kernel in interpret mode: uneven
    live lengths (one page-aligned, one within the first page), shuffled
    tables, within 2e-5; the wrapper on CPU tensors takes it."""
    rng = np.random.default_rng(4 + int8)
    B, T, NH, KH, D = 3, 8, 4, 2, 16
    q, kp, vp, tables, wins, lims = paged_inputs(rng, B, T, NH, KH, D, 12,
                                                 [29, 8, 0])
    scales = ()
    tscales = ()
    if int8:
        def quant(p):            # per (page, head, row) over D
            s = np.maximum(np.abs(p).max(axis=2, keepdims=True) / 127.0,
                           1e-12).astype(np.float32)
            return np.clip(np.round(p / s), -127, 127).astype(np.int8), s
        (kp, ks), (vp, vs) = quant(kp), quant(vp)
        scales = (jnp.asarray(ks), jnp.asarray(vs))
        tscales = tuple(torch.from_numpy(np.ascontiguousarray(s[:, :, 0]))
                        for s in (ks, vs))
    kw = dict(k_scale=scales[0], v_scale=scales[1]) if int8 else {}
    want = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(wins), jnp.asarray(lims),
                               interpret=True, **kw)
    args = (torch.from_numpy(q), torch.from_numpy(dp_to_port(kp).copy()),
            torch.from_numpy(dp_to_port(vp).copy()),
            torch.from_numpy(tables), torch.from_numpy(wins),
            torch.from_numpy(lims)) + tscales
    got = paged_block_attention_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    before = paged_block_attention.launches
    assert torch.equal(paged_block_attention(*args), got)
    assert paged_block_attention.launches == before      # no kernel on CPU


def test_paged_attention_rejects_bad_inputs():
    rng = np.random.default_rng(6)
    q, kp, vp, tables, wins, lims = paged_inputs(rng, 2, 8, 4, 2, 16, 8,
                                                 [3, 20])
    args = [torch.from_numpy(q), torch.from_numpy(dp_to_port(kp).copy()),
            torch.from_numpy(dp_to_port(vp).copy()),
            torch.from_numpy(tables), torch.from_numpy(wins),
            torch.from_numpy(lims)]
    for i, bad, match in [
            (3, args[3].long(), "tables"), (4, args[4][:, :, :-1], "window"),
            (5, args[5][:1], "kv_limits"), (1, args[1].to(torch.int8), "scale"),
            (2, args[2][..., :8], "match")]:
        with pytest.raises(ValueError, match=match):
            paged_block_attention(*(args[:i] + [bad] + args[i + 1:]))


def test_paged_forward_matches_jax(tiny_model):
    """One [B, T] block through the paged forward over shuffled pages that
    hold each slot's prefill: logits within 1e-4 of JAX's paged forward,
    the written pages equal after the layout permutation."""
    jcfg, jp, tcfg, tp = tiny_model
    rng = np.random.default_rng(7)
    B, T, Pf = 2, 6, 32
    lens = [20, 13]
    L, KH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    n = 12
    perm = rng.permutation(n)
    tables = np.full((B, 4), -1, np.int32)
    tables[0, :3], tables[1, :2] = perm[:3], perm[3:5]
    jpk = np.zeros((L, n + 1, KH, D, PAGE), np.float32)
    jpv = np.zeros_like(jpk)
    for b, m in enumerate(lens):     # prefill each slot, write its pages
        tok = np.zeros((1, Pf), np.int32)
        tok[0, :m] = rng.integers(3, 128, m)
        fk, fv = jax_init_kv(jcfg, 1, Pf)
        _, _, fk, fv = jax_forward_jit(jp, jcfg, jnp.asarray(tok),
                                   jnp.arange(Pf)[None], fk, fv,
                                   jnp.int32(0), jax_prefill_mask(1, Pf, Pf))
        for j in range(-(-m // PAGE)):
            sl = slice(j * PAGE, (j + 1) * PAGE)
            jpk[:, tables[b, j]] = np.asarray(fk)[:, 0, :, sl].swapaxes(-1,
                                                                        -2)
            jpv[:, tables[b, j]] = np.asarray(fv)[:, 0, :, sl].swapaxes(-1,
                                                                        -2)
    blocks = rng.integers(3, 128, (B, T)).astype(np.int32)
    offs = np.array(lens, np.int32)
    pos = offs[:, None] + np.arange(T, dtype=np.int32)
    tri = np.tril(np.ones((T, T), bool))
    wins = np.stack([np.asarray(jax_window(jnp.asarray(tri), jnp.int32(o),
                                           PAGE)) for o in offs])
    jl, _, jk, jv = jax_forward(
        jp, jcfg, jnp.asarray(blocks), jnp.asarray(pos),
        JaxPagedKV(jnp.asarray(jpk), None), JaxPagedKV(jnp.asarray(jpv), None),
        jnp.asarray(offs), jnp.asarray(wins),
        paged=JaxAux(jnp.asarray(tables), n, True))
    tk = PagedKV(torch.from_numpy(dp_to_port(jpk).copy()), None)
    tv = PagedKV(torch.from_numpy(dp_to_port(jpv).copy()), None)
    tl, _ = forward(tp, tcfg, torch.from_numpy(blocks), torch.from_numpy(pos),
                    tk, tv, torch.from_numpy(offs), torch.from_numpy(wins),
                    paged=PagedAux(torch.from_numpy(tables), n))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tk.pool.numpy()[:, :n],
                               dp_to_port(jk.pool)[:, :n], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="paged mode"):
        forward(tp, tcfg, torch.from_numpy(blocks), torch.from_numpy(pos),
                tk, tv, 0, torch.from_numpy(wins),
                paged=PagedAux(torch.from_numpy(tables), n))


def serve_jax_paged(jcfg, jp, ps, new, fsc=None, **kw):
    eng = JaxPaged(jcfg, jp, JaxFsc(**(fsc or FSC)), interpret=True,
                   **{**KW, **kw})
    ids = [eng.add_request(p, JaxGen(max_new_tokens=new, max_cache_len=256))
           for p in ps]
    out = eng.run()
    return [out[i] for i in ids]


def paged(tcfg, tp, fsc=None, **kw):
    return PagedBatchedFusedSamEngine(tcfg, tp, FusedSamConfig(
        **(fsc or FSC)), device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_paged_engine_matches_jax(tiny_model, quantized_kv):
    """Token streams and step counts equal JAX's paged engine (its
    interpret-mode K4) over a pool of q's type and over int8 pages, four
    requests through two slots; every page back in the free list."""
    jcfg, jp, tcfg, tp = tiny_model
    kw = dict(batch_size=2, n_pages=32, page_size=PAGE,
              quantized_kv=quantized_kv)
    ps = prompts(4, seed=11 if quantized_kv else 5)
    want = serve_jax_paged(jcfg, jp, ps, 20, **kw)
    eng = paged(tcfg, tp, **kw)
    got = serve(eng, ps, 20)
    same_streams(got, want)
    assert len(eng.pool._free) == 32
    assert eng.live_kv_tokens() == 0
    assert 0 < eng.peak_pages <= 32


@pytest.mark.parametrize("case", ["tight_pool", "inline"])
def test_paged_engine_matches_dense(tiny_model, case):
    """The reference's own checks (``tests/test_paged_fused.py:116-140``,
    ``tests/test_inline_prefill.py:125-149``): a pool too small for a
    segment's pre-allocation (8 pages for two slots) shortens segments and
    retries stalled slots; inline prefill grows pages per segment; both
    equal the dense one-shot engine, every page back."""
    _, _, tcfg, tp = tiny_model
    kw = dict(batch_size=2)
    if case == "tight_pool":
        ps, new, n_pages = prompts(3, seed=13), 16, 8
    else:
        rng = np.random.default_rng(23)
        ps = [rng.integers(3, 128, size=s).tolist() for s in (5, 16, 17, 33,
                                                             40)]
        new, n_pages = 24, 32
        kw.update(prefill_buckets=(64,))
    want = serve(batched(tcfg, tp, **kw), ps, new)
    eng = paged(tcfg, tp, n_pages=n_pages, page_size=PAGE,
                inline_prefill=case == "inline", **kw)
    got = serve(eng, ps, new)
    for g, w in zip(got, want):
        assert g.output_ids == w.output_ids
    assert len(eng.pool._free) == n_pages
    assert eng.live_kv_tokens() == 0


def test_paged_int8_weights_corpus_matches_single(tiny_model):
    """int8 weights and a corpus of the request's own continuation through
    the paged loop: equal to the single-stream engine's tokens, with long
    accepted drafts (the reference's ``tests/test_paged_fused.py:93-113``)."""
    jcfg, jp, tcfg, _ = tiny_model
    tqp = params_from_jax(jax.tree.map(np.asarray,
                                       quantize_llama_params(jp)), "cpu")
    p = prompts(1, seed=6, sizes=[20])[0]
    gen = GenerationConfig(max_new_tokens=20, max_cache_len=256)
    single = FusedSamEngine(tcfg, tqp, FusedSamConfig(**FSC), device="cpu",
                            **KW)
    probe = single.generate(p, gen)
    corpus = probe.output_ids + [0]
    got = serve(paged(tcfg, tqp, corpus=corpus, batch_size=2, n_pages=32,
                      page_size=PAGE), [p] * 3, 20)
    assert all(g.output_ids == probe.output_ids for g in got)
    assert all(g.decode_steps < probe.decode_steps for g in got)


def test_int4_int8_pages_equal_dense_and_own_oracle():
    """The 7B path's combination at tiny size: int4 weights (the K3 route)
    over int8 pages equals the paged engine's alpha = 0 oracle, with a
    corpus and a repetitive prompt; a 40-token prompt prefills at bucket 64
    across a page boundary.  (The dense int8-KV engine is another
    trajectory: its prefill attends the int8 cache, the paged prefill its
    bf16 batch-1 cache, as in the reference.)"""
    jcfg = tiny_config(vocab_size=128)
    tcfg = port_config(jcfg)
    tp = t_quant(params_from_jax(jax.tree.map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(1), scale=0.4)),
        "cpu"), dtype=INT4)
    kw = dict(batch_size=3, prefill_buckets=(32, 64))
    ps = prompts(4, seed=17, sizes=[12, 40, 9, 20]) + [[7, 8, 9] * 5]
    oracle = serve(paged(tcfg, tp, {**FSC, "alpha": 0.0}, n_pages=40,
                         page_size=PAGE, quantized_kv=True, **kw), ps, 28)
    corpus = oracle[0].output_ids + [0]
    eng = paged(tcfg, tp, n_pages=40, page_size=PAGE, quantized_kv=True,
                corpus=corpus, **kw)
    fast = serve(eng, ps, 28)
    for f, o in zip(fast, oracle):
        assert f.output_ids == o.output_ids
    assert fast[0].decode_steps < oracle[0].decode_steps
    assert len(eng.pool._free) == 40


def test_page_allocation_matches_jax(tiny_model):
    """Two requests growing and releasing pages on a 6-page pool: the
    same pages, tables, capacities and free lists as the reference's
    allocator, including best-effort growth when the pool runs short."""
    jcfg, _, tcfg, _ = tiny_model
    jpool = JaxPool(jcfg, n_pages=6, page_size=PAGE, layout="dp")
    tpool = PagedKVPool(tcfg, n_pages=6, page_size=PAGE, device="cpu")
    reqs = [(JaxRequest(jpool, 64), PagedRequest(tpool, 64))
            for _ in range(2)]
    steps = [("ensure", 0, 20), ("upto", 1, 50), ("upto", 0, 64),
             ("release", 1, 0), ("upto", 0, 200), ("ensure", 1, 16),
             ("release", 0, 0), ("upto", 1, 40)]
    for op, i, n in steps:
        j, t = reqs[i]
        if op == "ensure":
            j.ensure(n)
            t.ensure(n)
        elif op == "upto":
            assert t.ensure_upto(n) == j.ensure_upto(n)
        else:
            j.release()
            t.release()
        for j, t in reqs:
            np.testing.assert_array_equal(t.host_table(), j.host_table())
        assert tpool._free == jpool._free
    with pytest.raises(ValueError, match="max_len"):
        reqs[0][1].ensure(65)


def test_paged_engine_rejects_settings(tiny_model):
    _, _, tcfg, tp = tiny_model
    with pytest.raises(ValueError, match="kv_quant=False"):
        paged(dataclasses.replace(tcfg, kv_quant=True), tp, page_size=PAGE)
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged(tcfg, tp, page_size=48)
    pool = PagedKVPool(tcfg, n_pages=4, page_size=PAGE, device="cpu")
    assert pool.k.pool.shape == (2, 5, 2, PAGE, 16)
    with pytest.raises(MemoryError, match="exhausted"):
        pool.alloc(5)
