"""samd_tpu_torch.drafters against samd_tpu.drafters: the tree topology,
the Token-Recycle drafter and the adaptive SAM selector over one scripted
sequence of observe, verify and lookup calls, whose packed drafts must be
byte-equal; and the top-K harvest's tie order against ``lax.top_k``."""

import random

import jax
import numpy as np
import pytest
import torch

from samd_tpu.config import SamdConfig as JaxSamdConfig
from samd_tpu.drafters import make_drafter as jax_make_drafter
from samd_tpu.drafters import tree_topology as jtopo
from samd_tpu.drafters.token_recycle import TokenRecycleDrafter as JaxTR
from samd_tpu.sam import SamCursor as JaxCursor
from samd_tpu.sam import build_corpus_sam as jax_corpus_sam
from samd_tpu_torch.config import SamdConfig
from samd_tpu_torch.drafters import TokenRecycleDrafter, make_drafter
from samd_tpu_torch.drafters import tree_topology as ttopo
from samd_tpu_torch.engine import harvest_topk
from samd_tpu_torch.sam import SamCursor, build_corpus_sam
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

V = 40


@pytest.mark.parametrize("n,branching,depth,beta",
                         [(61, 8, 10, 2.0), (24, 4, 6, 1.5), (8, 8, 3, 2.0)])
def test_rank_probability_tree_matches_jax(n, branching, depth, beta):
    kw = dict(branching=branching, max_depth=depth, beta=beta)
    got = ttopo.rank_probability_tree(n, **kw)
    np.testing.assert_array_equal(got, jtopo.rank_probability_tree(n, **kw))
    assert ttopo.child_ranks(got) == jtopo.child_ranks(got)


def test_topology_files_across_packages(tmp_path):
    parents = ttopo.rank_probability_tree(30)
    ttopo.save_topology(parents, tmp_path / "a.json")
    np.testing.assert_array_equal(jtopo.load_topology(tmp_path / "a.json"),
                                  parents)
    jtopo.save_topology(parents, tmp_path / "b.json")
    np.testing.assert_array_equal(ttopo.load_topology(tmp_path / "b.json"),
                                  parents)


def script(seed, n_steps=25, M=16):
    """A scripted request: a prompt with its harvest, then per step a
    start token, the accepted tokens, the verify block and its harvest."""
    rng = np.random.default_rng(seed)
    base = rng.integers(3, V, 12)
    prompt = np.concatenate([base, rng.integers(3, V, 6), base[:7]])
    steps = []
    pos = 0
    for _ in range(n_steps):
        # mostly the base sequence again (so the automata find long
        # matches), sometimes fresh tokens
        if rng.random() < 0.7:
            k = int(rng.integers(1, 5))
            run = [int(base[(pos + j) % len(base)]) for j in range(k + 1)]
            pos += k + 1
        else:
            run = rng.integers(3, V, 4).tolist()
        steps.append(dict(
            start=run[0], accepted=run[1:],
            block=rng.integers(0, V, M).astype(np.int32),
            topk=rng.integers(0, V, (M, 8)).astype(np.int32),
            nodes=int(rng.integers(1, M + 1))))
    return prompt.tolist(), rng.integers(0, V, (len(prompt), 8)).astype(
        np.int32), steps


def run_script(drafter, prompt, prompt_topk, steps, harvest):
    """Drive a drafter; every draft's packed bytes, node count and
    source."""
    drafter.reset()
    drafter.observe_prompt(prompt, prompt_topk if harvest else None)
    out = []
    for st in steps:
        d = drafter.lookup(st["start"])
        out.append((d.packed.tobytes(), d.num_nodes, d.source))
        drafter.observe_accepted([st["start"]] + st["accepted"])
        if harvest:
            drafter.observe_verify(st["block"], st["topk"], st["nodes"])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_token_recycle_matches_jax(seed):
    prompt, ptopk, steps = script(seed)
    got = TokenRecycleDrafter(V, max_nodes=16, topk=8)
    want = JaxTR(V, max_nodes=16, topk=8)
    assert got.wants_harvest and want.wants_harvest
    # the cache lives across requests (reset is a no-op): two requests in
    # the same order on both sides
    for s in (seed, seed + 10):
        prompt, ptopk, steps = script(s)
        assert run_script(got, prompt, ptopk, steps, True) == \
            run_script(want, prompt, ptopk, steps, True)
    np.testing.assert_array_equal(got._cache, want._cache)
    np.testing.assert_array_equal(got._seen, want._seen)
    got.clear()
    assert not got._seen.any()


def selectors(kwargs, corpus, native):
    """The port's and JAX's drafter stacks for one SamdConfig, each static
    SAM behind its own cursor."""
    cfg = SamdConfig(use_native_sam=native, **kwargs)
    jcfg = JaxSamdConfig(use_native_sam=False, **kwargs)
    tsam = jsam = None
    if corpus is not None:
        tsam = SamCursor(build_corpus_sam(corpus, eos_token=0, topk=8))
        jsam = JaxCursor(jax_corpus_sam(corpus, eos_token=0, topk=8))
    return (make_drafter(cfg, V, static_sam=tsam),
            jax_make_drafter(jcfg, V, static_sam=jsam))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("kwargs,with_corpus", [
    (dict(draft_source="sam_only", max_predicts=16, len_bias=0), False),
    (dict(draft_source="sam_only", max_predicts=16, len_bias=1, alpha=2.0),
     True),
    (dict(draft_source="sam_hybrid", max_predicts=16, n_predicts=10,
          len_threshold=3, len_bias=2), True),
])
def test_adaptive_selector_matches_jax(kwargs, with_corpus, native):
    prompt, ptopk, steps = script(5)
    corpus = None
    if with_corpus:
        # the whole stream: the corpus knows fresh tokens before the
        # request's own automaton does, so both sources draft
        rng = np.random.default_rng(9)
        corpus = [sum(([st["start"]] + st["accepted"] for st in steps), []),
                  rng.integers(3, V, 40).tolist()]
    got, want = selectors(kwargs, corpus, native)
    harvest = kwargs["draft_source"] == "sam_hybrid"
    assert got.wants_harvest == want.wants_harvest == harvest
    g = run_script(got, prompt, ptopk, steps, harvest)
    assert g == run_script(want, prompt, ptopk, steps, harvest)
    sources = {s for _, _, s in g}
    if with_corpus:                     # more than one source drafted
        assert len(sources) > 1, sources
    else:
        assert sources == {"sam_dyn"}


def test_make_drafter_refuses_eagle():
    """The EAGLE draft nets share the target's embedding and head: without
    the target they are refused."""
    for method in ("eagle", "eagle2"):
        with pytest.raises(ValueError, match="needs model_cfg and params"):
            make_drafter(SamdConfig(draft_source="sam_hybrid",
                                    tree_method=method), V)
    with pytest.raises(ValueError, match="tree_drafter"):
        from samd_tpu_torch.drafters import AdaptiveSelector
        AdaptiveSelector(SamdConfig(draft_source="sam_hybrid",
                                    use_native_sam=False))


def test_tree_adjacency_config_matches_jax():
    parents = ttopo.rank_probability_tree(12, branching=3)
    adj = ttopo.child_ranks(parents)
    kw = dict(draft_source="sam_hybrid", max_predicts=16, n_predicts=10,
              tree_adjacency=adj)
    got = make_drafter(SamdConfig(use_native_sam=False, **kw), V)
    want = jax_make_drafter(JaxSamdConfig(use_native_sam=False, **kw), V)
    np.testing.assert_array_equal(got.tree_drafter.parents,
                                  want.tree_drafter.parents)
    prompt, ptopk, steps = script(2)
    assert run_script(got, prompt, ptopk, steps, True) == \
        run_script(want, prompt, ptopk, steps, True)


@pytest.mark.parametrize("seed", range(3))
def test_harvest_ties_break_as_lax_top_k(seed):
    """Rows with many tied logits: the harvest's ids equal lax.top_k's,
    which breaks ties toward the lower index."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 4, (6, 50)).astype(np.float32)  # heavy ties
    logits[0] = 0.0                                 # one row all tied
    want = np.asarray(jax.lax.top_k(logits, 8)[1])
    got = harvest_topk(torch.from_numpy(logits), 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # a leading slot axis, as the batched engines call it
    got3 = harvest_topk(torch.from_numpy(np.stack([logits, logits[::-1]])),
                        8).numpy()
    np.testing.assert_array_equal(got3[1], np.asarray(
        jax.lax.top_k(logits[::-1].copy(), 8)[1]))
