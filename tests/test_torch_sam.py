"""samd_tpu_torch.sam against samd_tpu.sam: the suffix automaton, its
cursor, the corpus SAM, the draft-tree buffers, serialization across the
two packages, and the port's native (C++) engine against its own Python
automaton and JAX's native engine.  Drafts, match lengths and top-K tables
must be equal exactly."""

import random

import numpy as np
import pytest

from samd_tpu import sam as jsam
from samd_tpu.sam import native as jnative
from samd_tpu_torch import sam as tsam
from samd_tpu_torch.config import SamdConfig
from samd_tpu_torch.drafters import AdaptiveSelector
from samd_tpu_torch.sam import native as tnative
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def random_tokens(rng, n, vocab):
    return [rng.randrange(vocab) for _ in range(n)]


def brute_longest_suffix_match(text, query):
    """Length of the longest suffix of ``query`` occurring in ``text``."""
    for length in range(len(query), 0, -1):
        suffix = query[-length:]
        for start in range(len(text) - length + 1):
            if text[start:start + length] == suffix:
                return length
    return 0


def state_tables(sam):
    """Every table of a Python automaton, for exact comparison."""
    return (sam._link, sam._len, sam._first_end, sam._occ,
            [sorted(t.items()) for t in sam._trans], sam.text)


def probes(rng, vocab, n=40):
    return [random_tokens(rng, rng.randrange(1, 9), vocab) for _ in range(n)]


def drafts_of(sam, probe):
    """What the drafters read after a cursor walk over ``probe``: the
    cursor, a peek, the three sequence-draft flavours and a tree draft."""
    sam.reset_cursor()
    sam.feed(probe, grow=False)
    s = sam.cur_state
    out = [(sam.cur_state, sam.cur_length), sam.peek(probe[-1])]
    for widen, pad in [(False, False), (True, True), (True, False)]:
        out.append(sam.sequence_draft(s, 99, 12, widen=widen, pad=pad))
    out.append(sam.tree_draft(s, 42, 16, 4))
    return out


@pytest.mark.parametrize("vocab,n", [(2, 60), (3, 200), (8, 200), (50, 300)])
def test_automaton_matches_jax(vocab, n):
    rng = random.Random(vocab * 1000 + n)
    text = random_tokens(rng, n, vocab)
    want = jsam.SuffixAutomaton(track_counts=True)
    got = tsam.SuffixAutomaton(track_counts=True)
    want.feed(text, grow=True)
    got.feed(text, grow=True)
    assert state_tables(got) == state_tables(want)
    want.finalize_topk(4)
    got.finalize_topk(4)
    assert got._topk == want._topk
    for probe in probes(rng, vocab):
        assert drafts_of(got, probe) == drafts_of(want, probe)
        got.reset_cursor()
        got.feed(probe, grow=False)
        assert got.cur_length == brute_longest_suffix_match(text, probe)


def test_online_growth_matches_jax():
    """The per-request dynamic SAM: cursor and index grow together."""
    rng = random.Random(7)
    want, got = jsam.SuffixAutomaton(), tsam.SuffixAutomaton()
    for _ in range(30):
        chunk = random_tokens(rng, rng.randrange(1, 6), 5)
        probe = rng.randrange(5)
        assert got.peek(probe) == want.peek(probe)
        want.feed(chunk, grow=True)
        got.feed(chunk, grow=True)
        assert (got.cur_state, got.cur_length) == (want.cur_state,
                                                   want.cur_length)
        s, _ = got.peek(probe)
        assert got.sequence_draft(s, probe, 9) == want.sequence_draft(
            s, probe, 9)
    assert state_tables(got) == state_tables(want)
    got.reset()
    assert got.num_states == 1 and len(got) == 0 and got.peek(1) == (0, 0)


def test_corpus_sam_and_cursors_match_jax():
    rng = random.Random(11)
    corpus = [random_tokens(rng, rng.randrange(20, 80), 6) for _ in range(6)]
    want = jsam.build_corpus_sam(corpus, eos_token=0, topk=4)
    got = tsam.build_corpus_sam(corpus, eos_token=0, topk=4)
    assert state_tables(got) == state_tables(want)
    assert got._topk == want._topk
    # two cursors over one shared automaton move independently
    a, b = tsam.SamCursor(got), tsam.SamCursor(got)
    ja = jsam.SamCursor(want)
    for probe in probes(rng, 6, n=20):
        for t in probe:
            assert a.peek(t) == ja.peek(t)
            a.advance_cursor(t)
            ja.advance_cursor(t)
        assert (b.cur_state, b.cur_length) == (0, 0)
        s = a.cur_state
        assert a.tree_draft(s, 5, 12, 4) == ja.tree_draft(s, 5, 12, 4)
        assert a.sequence_draft(s, 5, 8) == ja.sequence_draft(s, 5, 8)
        a.reset_cursor()
        ja.reset_cursor()
    with pytest.raises(ValueError, match="read-only"):
        a.feed([1], grow=True)


@pytest.mark.parametrize("vocab,n", [(3, 200), (16, 400), (1000, 400)])
def test_native_matches_python_and_jax_native(vocab, n):
    rng = random.Random(vocab + n)
    corpus = [random_tokens(rng, n // 4, vocab) for _ in range(4)]
    py = tsam.build_corpus_sam(corpus, eos_token=0, topk=4)
    cc = tnative.build_native_corpus_sam(corpus, eos_token=0, topk=4)
    jcc = jnative.NativeSuffixAutomaton(track_counts=True)
    jcc.index_corpus(corpus, eos_token=0)
    jcc.finalize_topk(4)
    arrays = cc.to_arrays()
    for k, v in tsam.to_arrays(py).items():
        np.testing.assert_array_equal(arrays[k], v, k)
        np.testing.assert_array_equal(jcc.to_arrays()[k], v, k)
    for probe in probes(rng, vocab, n=30):
        want = drafts_of(py, probe)
        assert drafts_of(cc, probe) == want
        assert drafts_of(jcc, probe) == want
    # the dynamic form: cursor and index grow together
    py2, cc2 = tsam.SuffixAutomaton(), tnative.NativeSuffixAutomaton()
    for t in random_tokens(rng, 60, vocab):
        assert cc2.peek(t) == py2.peek(t)
        py2.feed([t], grow=True)
        cc2.feed([t], grow=True)
        assert (cc2.cur_state, cc2.cur_length) == (py2.cur_state,
                                                   py2.cur_length)


def test_native_from_arrays_round_trip():
    rng = random.Random(3)
    corpus = [random_tokens(rng, 50, 6) for _ in range(5)]
    py = tsam.build_corpus_sam(corpus, eos_token=0, topk=4)
    cc = tnative.NativeSuffixAutomaton.from_arrays(tsam.to_arrays(py))
    cc.finalize_topk(4)
    for probe in probes(rng, 6, n=20):
        assert drafts_of(cc, probe) == drafts_of(py, probe)


@pytest.mark.parametrize("writer", ["port_python", "port_native", "jax"])
def test_serialization_across_packages(tmp_path, writer):
    """A file saved by either package loads in the other with the same
    states, edges, text, top-K and drafts."""
    rng = random.Random(5)
    corpus = [random_tokens(rng, 60, 7) for _ in range(5)]
    ref = jsam.build_corpus_sam(corpus, eos_token=0, topk=4)
    path = tmp_path / "sam.npz"
    if writer == "jax":
        jsam.save_sam(ref, path)
    elif writer == "port_python":
        tsam.save_sam(tsam.build_corpus_sam(corpus, eos_token=0, topk=4),
                      path)
    else:
        tsam.save_sam(tnative.build_native_corpus_sam(corpus, eos_token=0,
                                                      topk=4), path)
    got = tsam.load_sam(path, topk=4)
    back = jsam.load_sam(path, topk=4)
    for loaded in (got, back):
        assert state_tables(loaded) == state_tables(ref)
        assert loaded._topk == ref._topk
        assert loaded._last == jsam.from_arrays(jsam.to_arrays(ref))._last
    for probe in probes(rng, 7, n=20):
        assert drafts_of(got, probe) == drafts_of(ref, probe)
    got.extend(3)                       # a loaded automaton keeps growing
    assert got.num_states >= ref.num_states


def random_parents(rng, n):
    return [-1] + [rng.randrange(i) for i in range(1, n)]


@pytest.mark.parametrize("seed", range(4))
def test_tree_buffers_match_jax(seed):
    rng = random.Random(seed)
    n = rng.randrange(2, 14)
    parents = np.asarray(random_parents(rng, n), np.int32)
    tokens = random_tokens(rng, n, 50)
    for fn in ("ancestor_closure", "node_depths"):
        np.testing.assert_array_equal(getattr(tsam, fn)(parents),
                                      getattr(jsam, fn)(parents))
    for rev in (False, True):
        np.testing.assert_array_equal(
            tsam.leaf_paths(parents, reverse_leaf_order=rev),
            jsam.leaf_paths(parents, reverse_leaf_order=rev))
    kw = dict(max_nodes=16, max_paths=16, max_depth=16)
    want = jsam.build_tree_buffers(tokens, parents, **kw)
    got = tsam.build_tree_buffers(tokens, parents, **kw)
    for name in ("tokens", "attn_mask", "position_ids", "retrieve_indices"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    assert got.num_nodes == want.num_nodes
    chain_w = jsam.chain_buffers(tokens, max_nodes=16, max_depth=16,
                                 max_paths=2)
    chain_g = tsam.chain_buffers(tokens, max_nodes=16, max_depth=16,
                                 max_paths=2)
    np.testing.assert_array_equal(chain_g.attn_mask, chain_w.attn_mask)
    np.testing.assert_array_equal(chain_g.retrieve_indices,
                                  chain_w.retrieve_indices)
    adj = tsam.parents_to_adjacency(parents)
    assert adj == jsam.parents_to_adjacency(parents)
    np.testing.assert_array_equal(tsam.adjacency_to_parents(adj), parents)
    with pytest.raises(ValueError):
        tsam.build_tree_buffers(tokens, parents, max_nodes=n - 1,
                                max_paths=16, max_depth=16)


def test_native_build_failure_raises(monkeypatch):
    """No fall back: a native engine that cannot build raises with the
    compiler's error, and use_native_sam=False takes the Python
    automaton."""
    monkeypatch.setattr(tnative, "CXX", "/nonexistent/g++")
    tnative.load_library.cache_clear()
    try:
        assert not tnative.library_path().exists()
        with pytest.raises(RuntimeError, match="failed to build"):
            tnative.NativeSuffixAutomaton()
        with pytest.raises(RuntimeError, match="failed to build"):
            AdaptiveSelector(SamdConfig(use_native_sam=True))
        sel = AdaptiveSelector(SamdConfig(use_native_sam=False))
        assert isinstance(sel.dyn, tsam.SuffixAutomaton)
    finally:
        monkeypatch.undo()
        tnative.load_library.cache_clear()
    assert isinstance(AdaptiveSelector(SamdConfig()).dyn,
                      tnative.NativeSuffixAutomaton)


def test_native_library_name_follows_source_and_flags(monkeypatch):
    """An edited source or other flags never load a stale library."""
    path = tnative.library_path()
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-g",))
    assert tnative.library_path() != path
    assert path.parent == tnative.BUILD_DIR
