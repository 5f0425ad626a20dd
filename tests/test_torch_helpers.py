"""The public helpers of samd_tpu that the port gained last, each against
JAX's on the same inputs (CPU): the tree depths and paths, the SAM's
breadth-first draft, the native engine's ``extend`` and availability, the
n-gram index's candidate count, ``param_count`` on dense, int8, int4 and
MoE trees, ``ModelConfig.with_dtype``, ``PhaseTimer.phase``, the paged
attention's ``NEG_INF`` and ``fused_base.harvest_topk``.  Integers must be
equal exactly."""

import functools
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu import fused_base as jax_fused_base
from samd_tpu import profiling as jax_profiling
from samd_tpu import sam as jsam
from samd_tpu.models import init_params as jax_init_params
from samd_tpu.models import param_count as jax_param_count
from samd_tpu.models import tiny_config, tiny_moe_config
from samd_tpu.ops import depths_from_parents as jax_depths
from samd_tpu.ops import ngram_index as jax_index
from samd_tpu.ops import paged_attention as jax_paged
from samd_tpu.ops import paths_from_parents as jax_paths
from samd_tpu.ops import quant as jq
from samd_tpu.sam import native as jnative
from samd_tpu_torch import engine, fused_base, profiling
from samd_tpu_torch import sam as tsam
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.models import param_count
from samd_tpu_torch.ops import depths_from_parents, paths_from_parents
from samd_tpu_torch.ops import ngram_index
from samd_tpu_torch.ops import paged_attention
from samd_tpu_torch.ops import quant as tq
from samd_tpu_torch.sam import native as tnative
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config


def random_parents(rng, M, n_pad, pad):
    """A random tree of M - n_pad nodes (each parent earlier, some extra
    roots) and n_pad padding nodes: -1 (roots), self-parented, or any
    index at all."""
    real = M - n_pad
    par = [-1 if i == 0 or rng.random() < 0.1 else int(rng.integers(0, i))
           for i in range(real)]
    for i in range(real, M):
        par.append({"minus_one": -1, "self": i,
                    "any": int(rng.integers(-1, M))}[pad])
    return np.asarray(par, np.int32)


@pytest.mark.parametrize("pad", ["minus_one", "self", "any"])
@pytest.mark.parametrize("seed", range(3))
def test_depths_and_paths_equal_jax(seed, pad):
    rng = np.random.default_rng(seed)
    for M in (1, 7, 40):
        par = random_parents(rng, M, int(rng.integers(0, M)), pad)
        want_d = np.asarray(jax_depths(jnp.asarray(par)))
        got_d = depths_from_parents(torch.from_numpy(par))
        assert got_d.dtype == torch.int32
        np.testing.assert_array_equal(got_d.numpy(), want_d)
        for max_depth in range(1, int(want_d.max()) + 2):
            want = np.asarray(jax_paths(jnp.asarray(par),
                                        jnp.asarray(want_d), max_depth))
            got = paths_from_parents(torch.from_numpy(par), got_d, max_depth)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          f"M {M} max_depth {max_depth}")


def test_depths_and_paths_batched_rows():
    """A leading axis: each row as JAX computes it alone."""
    rng = np.random.default_rng(9)
    par = np.stack([random_parents(rng, 24, 5, "self") for _ in range(6)])
    d = depths_from_parents(torch.from_numpy(par))
    p = paths_from_parents(torch.from_numpy(par), d, 8)
    for b in range(6):
        jd = jax_depths(jnp.asarray(par[b]))
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(
            p[b].numpy(), np.asarray(jax_paths(jnp.asarray(par[b]), jd, 8)))


def built_pair(vocab, n, seed):
    """JAX's and the port's Python automata over the same corpus."""
    rng = random.Random(seed)
    corpus = [[rng.randrange(vocab) for _ in range(rng.randrange(1, n))]
              for _ in range(5)]
    j, t = jsam.SuffixAutomaton(), tsam.SuffixAutomaton()
    j.index_corpus(corpus, eos_token=0)
    t.index_corpus(corpus, eos_token=0)
    return j, t, rng


@pytest.mark.parametrize("vocab,n", [(3, 40), (8, 120), (50, 200)])
def test_neighborhood_tree_draft_equals_jax(vocab, n):
    j, t, rng = built_pair(vocab, n, vocab * 7 + n)
    for state in list(range(min(j.num_states, 60))):
        for n_nodes in (1, 2, 5, 16, 64):
            start = rng.randrange(vocab)
            want = j.neighborhood_tree_draft(state, start, n_nodes)
            got = t.neighborhood_tree_draft(state, start, n_nodes)
            assert got == want, (state, n_nodes)
            assert len(got[0]) <= n_nodes and got[1][0] == -1


@pytest.mark.parametrize("track_counts", [False, True])
@pytest.mark.parametrize("vocab", [2, 5, 40])
def test_native_extend_equals_python_and_jax(vocab, track_counts):
    """Tokens indexed one ``extend`` at a time, with cursor walks between:
    the port's native engine holds the port's Python automaton's tables and
    cursor (extend leaves the cursor alone), and JAX's native engine's
    tables (its extend also moves its cursor, so only the index is
    compared there)."""
    rng = random.Random(vocab)
    py = tsam.SuffixAutomaton(track_counts=track_counts)
    jpy = jsam.SuffixAutomaton(track_counts=track_counts)
    cc = tnative.NativeSuffixAutomaton(track_counts=track_counts)
    jcc = jnative.NativeSuffixAutomaton(track_counts=track_counts)
    for i in range(300):
        tok = rng.randrange(vocab)
        for sam in (py, jpy, cc, jcc):
            sam.extend(tok)
        if i % 7 == 0:
            walk = rng.randrange(vocab)
            for sam in (py, jpy, cc):
                sam.advance_cursor(walk)
        assert (cc.cur_state, cc.cur_length) == \
            (py.cur_state, py.cur_length) == (jpy.cur_state, jpy.cur_length)
    want = tsam.to_arrays(py)
    assert want["link"].size == py.num_states == cc.num_states
    for k, v in cc.to_arrays().items():
        np.testing.assert_array_equal(v, want[k], k)
        np.testing.assert_array_equal(jcc.to_arrays()[k], v, k)
        np.testing.assert_array_equal(jsam.to_arrays(jpy)[k], v, k)


def test_native_available(monkeypatch, tmp_path):
    """True where the engine builds; False, with nothing substituted,
    where it cannot."""
    assert tnative.native_available() is jnative.native_available() is True
    bad = tmp_path / "sam_engine.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    tnative.load_library.cache_clear()
    try:
        assert tnative.native_available() is False
        with pytest.raises(RuntimeError, match="failed to build"):
            tnative.NativeSuffixAutomaton()
    finally:
        monkeypatch.undo()
        tnative.load_library.cache_clear()
    assert tnative.native_available() is True


@pytest.mark.parametrize("cap,keep_latest", [(4, 0), (4, 4), (8, 0), (8, 8)])
def test_num_candidates_equals_jax(cap, keep_latest):
    corpus = np.random.default_rng(cap).integers(0, 30, 600)
    grams = (6, 3, 1)
    want = jax_index.build_ngram_index(corpus, grams=grams, bucket_cap=cap,
                                       keep_latest=keep_latest)
    got = ngram_index.build_ngram_index(corpus, grams=grams, bucket_cap=cap,
                                        keep_latest=keep_latest, device="cpu")
    assert got.num_candidates == want.num_candidates


def test_num_candidates_is_the_probe_width():
    """With ``keep_latest`` other than the bucket size the count is what a
    probe reads: every bucket and every latest slot (the reference's
    property counts two buckets a gram there)."""
    corpus = np.random.default_rng(1).integers(0, 30, 600)
    idx = ngram_index.build_ngram_index(corpus, grams=(6, 3, 1), bucket_cap=8,
                                        keep_latest=3, device="cpu")
    assert idx.num_candidates == 3 * (8 + 3)


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """JAX trees: dense, int8, int4 (tiny_config) and dense MoE."""
    cfg = tiny_config(vocab_size=64)
    dense = jax_init_params(cfg, jax.random.PRNGKey(0))
    moe = jax_init_params(tiny_moe_config(vocab_size=64),
                          jax.random.PRNGKey(1))
    return {"dense": dense,
            "int8": jq.quantize_llama_params(dense, dtype=jnp.int8),
            "int4": jq.quantize_llama_params(dense, dtype=jnp.int4),
            "moe": moe,
            "moe_int8": jq.quantize_llama_params(moe, dtype=jnp.int8)}


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "moe", "moe_int8"])
def test_param_count_equals_jax(kind):
    jp = _jax_trees()[kind]
    got = param_count(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    assert got == jax_param_count(jp) > 0


def test_param_count_of_port_quantized_trees():
    """The port's own quantizer gives trees of JAX's counts."""
    trees = _jax_trees()
    dense = params_from_jax(jax.tree.map(np.asarray, trees["dense"]), "cpu")
    assert param_count(tq.quantize_llama_params(dense)) == \
        jax_param_count(trees["int8"])
    assert param_count(tq.quantize_llama_params(dense, dtype=tq.INT4)) == \
        jax_param_count(trees["int4"])


def test_with_dtype_equals_jax():
    for make in (tiny_config, tiny_moe_config):
        jcfg = make(vocab_size=64)
        cfg = port_config(jcfg)
        got = cfg.with_dtype(torch.bfloat16)
        assert got == port_config(jcfg.with_dtype(jnp.bfloat16))
        assert got.dtype == torch.bfloat16 and cfg.dtype == torch.float32


def test_phase_timer_phase():
    """Totals and counts as JAX's timer keeps them, an exception inside
    the block included."""
    timers = (profiling.PhaseTimer(), jax_profiling.PhaseTimer())
    for t in timers:
        with t.phase("draft"):
            time.sleep(0.01)
        with t.phase("draft"):
            pass
        with pytest.raises(KeyError):
            with t.phase("verify"):
                raise KeyError("x")
        t.record("verify", 0.5)
    got, want = (t.report("draft") for t in timers)
    assert [(r["phase"], r["calls"]) for r in got] == \
        [(r["phase"], r["calls"]) for r in want] == [("verify", 2),
                                                     ("draft", 2)]
    assert timers[0].totals["draft"] >= 0.01
    assert 0.5 <= timers[0].totals["verify"] < 0.6


def test_neg_inf_and_harvest_topk():
    assert paged_attention.NEG_INF == jax_paged.NEG_INF
    assert fused_base.harvest_topk is engine.harvest_topk
    logits = np.random.default_rng(0).standard_normal((5, 40)).astype(
        np.float32)
    logits[:, 7] = logits[:, 3]               # ties: lower index first
    want = np.asarray(jax_fused_base.harvest_topk(jnp.asarray(logits), 6,
                                                  False))
    got = fused_base.harvest_topk(torch.from_numpy(logits), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
