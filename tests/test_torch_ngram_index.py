"""samd_tpu_torch's n-gram corpus index against samd_tpu's
(``tests/test_ngram_index.py``): the hashes and every table (also the
latest-position tables) equal JAX's byte for byte; ``indexed_suffix_match``
over a slot axis equals JAX's exactly on random, repetitive (overflowing)
and matchless corpora, and equals the scan on corpora without repeats; the
indexed single-stream, batched and paged engines give JAX's indexed
engines' greedy streams on shared weights and the port's scan engines';
and a 2^18-token corpus is served through the index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import BatchedFusedSamEngine as JaxBatched
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.fused_sam import PagedBatchedFusedSamEngine as JaxPaged
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops import ngram_index as jax_index
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.fused_base import build_optional_index
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine,
                                      PagedBatchedFusedSamEngine,
                                      suffix_match)
from samd_tpu_torch.ops import ngram_index
from test_ngram_index import brute_force_match, query_arrays
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

Q, EXT = 8, 56
W = Q + EXT
GRAMS = (32, 16, 8, 7, 6, 5, 4, 3, 2, 1)


def corpora():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 12, size=400).astype(np.int32),
        "repetitive": np.tile(rng.integers(0, 3, size=5), 60
                              ).astype(np.int32),
        "constant": np.zeros(200, np.int32),
        "short": np.arange(50, dtype=np.int32),
        "large_vocab": rng.integers(0, 32000, size=3000).astype(np.int32),
    }


def test_hashes_match_numpy():
    """The probe's int64 hash of every gram size equals the uint32 numpy
    hash, over the full token range (ids past 2^16 included), and the
    port's host hash equals JAX's module's."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 2 ** 31 - 1, size=500).astype(np.int32)
    for n in (1, 2, 7, 32):
        np.testing.assert_array_equal(ngram_index._hash_ngrams_np(toks, n),
                                      jax_index._hash_ngrams_np(toks, n))
    win = torch.from_numpy(rng.integers(-1, 2 ** 31 - 1, (6, W)
                                        ).astype(np.int32))
    got = ngram_index.window_hashes(
        win, ngram_index.hash_powers(32, "cpu")).numpy()
    for b in range(6):
        for n in range(1, 33):
            oldest_first = win[b, :n].numpy()[::-1].copy()
            assert got[b, n - 1] == int(jax_index._hash_ngrams_np(
                oldest_first, n)[0])


@pytest.mark.parametrize("keep_latest", [0, 3])
@pytest.mark.parametrize("name", ["random", "repetitive", "short",
                                  "large_vocab"])
def test_tables_match_jax(name, keep_latest):
    corpus = corpora()[name]
    want = jax_index.build_ngram_index(corpus, grams=GRAMS, bucket_cap=4,
                                       keep_latest=keep_latest)
    got = ngram_index.build_ngram_index(corpus, grams=GRAMS, bucket_cap=4,
                                        keep_latest=keep_latest,
                                        device="cpu")
    assert got.grams == want.grams and got.bucket_cap == want.bucket_cap
    assert got.table.shape[1] == max(1024, 1 << (len(corpus) - 1
                                                 ).bit_length())
    assert got.table.shape[0] == len(want.tables) == len(GRAMS)
    for a, b in zip(got.table, want.tables):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    if keep_latest:
        assert got.latest.shape == got.table.shape[:2] + (keep_latest,)
        assert len(want.latest_tables) == len(GRAMS)
        for a, b in zip(got.latest, want.latest_tables):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    else:
        assert got.latest is None and want.latest_tables == ()


def probes(corpus, n, rng):
    """n (query, tail, tail_len, window) probes: half replay a corpus
    slice (long matches), half are random."""
    out = []
    for trial in range(n):
        hlen = int(rng.integers(0, 70))
        if trial % 2 == 0 and 0 < hlen < len(corpus) - 1:
            s = int(rng.integers(0, len(corpus) - hlen))
            history = corpus[s:s + hlen].tolist()
            start = int(corpus[s + hlen]) if s + hlen < len(corpus) else 0
        else:
            top = int(corpus.max()) + 2
            history = rng.integers(0, top, size=hlen).tolist()
            start = int(rng.integers(0, top))
        out.append(query_arrays(history, start))
    return out


def port_match(corpus, index, ps):
    q, t, tl, _ = zip(*ps)
    m, e = ngram_index.indexed_suffix_match(
        torch.from_numpy(corpus), torch.tensor(len(corpus),
                                               dtype=torch.int32),
        index, torch.from_numpy(np.stack(q)), torch.from_numpy(np.stack(t)),
        torch.tensor(tl, dtype=torch.int32), max_ngram=Q, ext=EXT)
    return list(zip(m.tolist(), e.tolist()))


@pytest.mark.parametrize("cap,keep_latest", [(4, 0), (1, 2), (512, 0)])
@pytest.mark.parametrize("name", ["random", "repetitive", "constant",
                                  "short"])
def test_indexed_match_equals_jax(name, cap, keep_latest):
    """Exact integer equality with JAX's probe, one slot at a time there
    and all slots at once here; small caps overflow the repetitive
    corpora's buckets.  With a cap no bucket reaches, also equal to the
    scan and to brute force on the corpora without repeats (on a
    repetitive one the scan extends only its earliest full-window match, so
    it may stop short of the longest)."""
    corpus = corpora()[name]
    rng = np.random.default_rng(len(name) + cap)
    ps = probes(corpus, 24, rng)
    jidx = jax_index.build_ngram_index(corpus, grams=GRAMS, bucket_cap=cap,
                                       keep_latest=keep_latest)
    want = [tuple(int(x) for x in jax_index.indexed_suffix_match(
        jnp.asarray(corpus), jnp.int32(len(corpus)), jidx, jnp.asarray(q),
        jnp.asarray(t), jnp.int32(tl), max_ngram=Q, ext=EXT))
        for q, t, tl, _ in ps]
    tidx = ngram_index.build_ngram_index(corpus, grams=GRAMS,
                                         bucket_cap=cap,
                                         keep_latest=keep_latest,
                                         device="cpu")
    got = port_match(corpus, tidx, ps)
    assert got == want
    assert any(m > 0 for m, _ in got)
    if cap == 512 and name in ("random", "short"):
        q, t, tl, _ = zip(*ps)
        m, e = suffix_match(torch.from_numpy(corpus)[None],
                            torch.tensor(len(corpus), dtype=torch.int32),
                            torch.from_numpy(np.stack(q)),
                            torch.from_numpy(np.stack(t)),
                            torch.tensor(tl, dtype=torch.int32),
                            max_ngram=Q, ext=EXT)
        scan = list(zip(m.tolist(), e.tolist()))
        for (gm, ge), (sm, se), p in zip(got, scan, ps):
            bl, be = brute_force_match(corpus, p[3])
            assert gm == sm == min(bl, W)
            if gm:
                assert ge == se == be


def test_no_match_and_earliest():
    corpus = np.arange(50, dtype=np.int32)
    idx = ngram_index.build_ngram_index(corpus, device="cpu")
    assert port_match(corpus, idx, [query_arrays([1000, 1001], 999)]) \
        == [(0, 0)]
    corpus = np.asarray([5, 1, 5, 2, 5], np.int32)
    idx = ngram_index.build_ngram_index(corpus, device="cpu")
    assert port_match(corpus, idx, [query_arrays([], 5)]) == [(1, 0)]


def test_build_optional_index():
    cfg = FusedSamConfig(corpus_capacity=64)
    assert build_optional_index([1, 2, 3], cfg, "cpu") is None
    icfg = FusedSamConfig(corpus_capacity=64, indexed=True, max_ngram=4,
                          ext=4)
    assert build_optional_index([], icfg, "cpu") is None
    idx = build_optional_index(list(range(100)), icfg, "cpu")
    assert idx.grams == (8, 7, 6, 5, 4, 3, 2, 1)   # up to max_ngram + ext
    assert int(idx.table.max()) == 63               # capacity-cut corpus


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

FSC = dict(n_predicts=11, steps_per_call=6, corpus_capacity=1024)
KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
GEN_KW = dict(max_new_tokens=28, max_cache_len=256)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=64)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.5)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def workload(tiny_model):
    """Three prompts and a corpus of their no-corpus greedy outputs, with
    a repeated stretch that overflows small buckets."""
    jcfg, jp, _, _ = tiny_model
    rng = np.random.default_rng(3)
    ps = [rng.integers(2, 64, size=int(n)).tolist() for n in (24, 18, 30)]
    probe = JaxFused(jcfg, jp, JaxFsc(**FSC), **KW)
    outs = [probe.generate(p, JaxGen(**GEN_KW)).output_ids for p in ps]
    corpus = sum((o + [0] for o in outs[:2]), []) + [7, 8] * 40
    return ps, corpus


def jax_outputs(kind, jcfg, jp, corpus, ps, cap, keep_latest=0):
    fc = JaxFsc(**FSC, indexed=True, index_bucket_cap=cap,
                index_keep_latest=keep_latest)
    if kind == "single":
        eng = JaxFused(jcfg, jp, fc, corpus=corpus, **KW)
        return [eng.generate(p, JaxGen(**GEN_KW)) for p in ps]
    ctor = JaxPaged if kind == "paged" else JaxBatched
    extra = dict(n_pages=48, page_size=16) if kind == "paged" else {}
    eng = ctor(jcfg, jp, fc, corpus=corpus, batch_size=2, **KW, **extra)
    ids = [eng.add_request(p, JaxGen(**GEN_KW)) for p in ps]
    out = eng.run()
    return [out[i] for i in ids]


def port_outputs(kind, tcfg, tp, corpus, ps, indexed, cap=8, keep_latest=0):
    fc = FusedSamConfig(**FSC, indexed=indexed, index_bucket_cap=cap,
                        index_keep_latest=keep_latest)
    if kind == "single":
        eng = FusedSamEngine(tcfg, tp, fc, corpus=corpus, device="cpu",
                             **KW)
        return [eng.generate(p, GenerationConfig(**GEN_KW)) for p in ps]
    if kind == "paged":
        eng = PagedBatchedFusedSamEngine(tcfg, tp, fc, corpus=corpus,
                                         batch_size=2, n_pages=48,
                                         page_size=16, device="cpu", **KW)
    else:
        eng = BatchedFusedSamEngine(tcfg, tp, fc, corpus=corpus,
                                    batch_size=2, device="cpu", **KW)
    ids = [eng.add_request(p, GenerationConfig(**GEN_KW)) for p in ps]
    out = eng.run()
    assert eng.stats_corpus_steps > 0
    return [out[i] for i in ids]


@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
def test_indexed_engines_match_jax_and_scan(tiny_model, workload, kind):
    """Tokens and step counts equal JAX's indexed engine (cap 2: buckets
    overflow on the repeated stretch); with a cap no bucket reaches, the
    port's indexed engine takes the scan engine's drafts exactly."""
    jcfg, jp, tcfg, tp = tiny_model
    ps, corpus = workload
    want = jax_outputs(kind, jcfg, jp, corpus, ps, cap=2)
    got = port_outputs(kind, tcfg, tp, corpus, ps, True, cap=2)
    for g, w in zip(got, want):
        assert g.output_ids == w.output_ids
        assert g.decode_steps == w.decode_steps
    wide = port_outputs(kind, tcfg, tp, corpus, ps, True, cap=256)
    scan = port_outputs(kind, tcfg, tp, corpus, ps, False)
    for a, b in zip(wide, scan):
        assert a.output_ids == b.output_ids
        assert a.decode_steps == b.decode_steps
    assert sum(o.decode_steps for o in got[:2]) < 2 * GEN_KW[
        "max_new_tokens"]


@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
def test_indexed_engines_keep_latest_match_jax(tiny_model, workload, kind):
    """``index_keep_latest``: each bucket's latest positions probed beside
    its earliest ones (cap 1, two latest, so the repeated stretch overflows
    both); tokens and step counts equal JAX's engine with the same
    option."""
    jcfg, jp, tcfg, tp = tiny_model
    ps, corpus = workload
    want = jax_outputs(kind, jcfg, jp, corpus, ps, cap=1, keep_latest=2)
    got = port_outputs(kind, tcfg, tp, corpus, ps, True, cap=1,
                       keep_latest=2)
    for g, w in zip(got, want):
        assert g.output_ids == w.output_ids
        assert g.decode_steps == w.decode_steps


def test_engine_serves_large_corpus(tiny_model):
    """A 2^18-token corpus (noise with a trajectory embedded) served
    through the index: the output equals the no-corpus output, and the
    corpus cuts the verify steps."""
    _, _, tcfg, tp = tiny_model
    prompt = np.random.default_rng(3).integers(2, 64, size=24).tolist()
    gen = GenerationConfig(max_new_tokens=24, max_cache_len=256)
    traj = FusedSamEngine(tcfg, tp, FusedSamConfig(**FSC), device="cpu",
                          **KW).generate(prompt, gen)
    big = np.random.default_rng(9).integers(0, 64, size=1 << 18
                                            ).astype(np.int32)
    doc = np.asarray(traj.output_ids + [0], np.int32)
    big[200_000:200_000 + len(doc)] = doc
    eng = FusedSamEngine(
        tcfg, tp, FusedSamConfig(n_predicts=11, corpus_capacity=1 << 18,
                                 indexed=True),
        corpus=big, device="cpu", **KW)
    assert eng.corpus_index.table.shape == (10, 1 << 18, 8)
    out = eng.generate(prompt, gen)
    assert out.output_ids == traj.output_ids
    assert out.decode_steps < out.decode_tokens
