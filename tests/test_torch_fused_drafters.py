"""samd_tpu_torch's device drafters against samd_tpu's: ``pld_draft`` and
``PldEngine``; the Token-Recycle topology (``build_tr_topology``), the tree
fill from a harvest table (``make_tr_draft``), the harvest scatter with
duplicate rows (``fused_base.harvest_update``) and
``FusedTokenRecycleEngine``: token streams, decode steps and the harvest
and seen tables after a run, exactly (mirrors ``tests/test_pld.py`` and
``tests/test_token_recycle_fused.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.fused_hybrid import build_tr_topology as jax_topology
from samd_tpu.fused_hybrid import make_tr_draft as jax_tr_draft
from samd_tpu.models import init_params, tiny_config
from samd_tpu.pld import PldConfig as JaxPldConfig
from samd_tpu.pld import PldEngine as JaxPld
from samd_tpu.pld import pld_draft as jax_pld_draft
from samd_tpu.token_recycle_fused import FusedTokenRecycleConfig as JaxTrc
from samd_tpu.token_recycle_fused import FusedTokenRecycleEngine as JaxTr
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_base import harvest_update
from samd_tpu_torch.fused_hybrid import build_tr_topology, make_tr_draft
from samd_tpu_torch.pld import PldConfig, PldEngine, pld_draft
from samd_tpu_torch.token_recycle_fused import (FusedTokenRecycleConfig,
                                                FusedTokenRecycleEngine)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
# one compile per draft shape
jax_pld_draft_jit = jax.jit(jax_pld_draft,
                            static_argnames=("max_ngram", "n_predicts"))


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    return (jcfg, jp, zeros, port_config(jcfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            params_from_jax(jax.tree.map(np.asarray, zeros), "cpu"))


def gen(n):
    return (JaxGen(max_new_tokens=n, max_cache_len=256),
            GenerationConfig(max_new_tokens=n, max_cache_len=256))


def same(got, want):
    assert got.output_ids == want.output_ids
    assert got.decode_tokens == want.decode_tokens
    assert got.decode_steps == want.decode_steps


# ---------------------------------------------------------------------------
# PLD
# ---------------------------------------------------------------------------

PLD_CASES = [  # history, hist_len, start, max_ngram, n_predicts
    ([5, 6, 7, 9, 5, 6, 7, 8, 1, 5, 6, 0, 0, 0, 0, 0], 11, 7, 3, 5),
    ([1, 2, 3, 0, 0, 0], 3, 9, 3, 4),
    ([1, 2, 3, 1, 2, 0, 0, 0], 5, 3, 3, 6),
    ([4, 4, 4, 4, 4, 4, 0, 0], 6, 4, 3, 4),
    ([7, 1, 2, 0], 1, 7, 3, 3)]


@pytest.mark.parametrize("case", PLD_CASES + ["random"])
def test_pld_draft_matches_jax(case):
    """The reference's three draft cases (longest n-gram, no match, a
    continuation clipped to the history) and more, plus random
    repetitive histories: tokens and draft length exactly."""
    if case == "random":
        rng = np.random.default_rng(3)
        cases = [(rng.integers(0, 6, 40).tolist(), int(rng.integers(1, 41)),
                  int(rng.integers(0, 6)), 3, 10) for _ in range(40)]
    else:
        cases = [case]
    for hist, hl, start, g, n in cases:
        want = jax_pld_draft_jit(jnp.asarray(hist, jnp.int32),
                                 jnp.int32(hl), jnp.int32(start),
                                 max_ngram=g, n_predicts=n)
        got = pld_draft(torch.tensor(hist, dtype=torch.int32),
                        torch.tensor(hl, dtype=torch.int32),
                        torch.tensor(start, dtype=torch.int32),
                        max_ngram=g, n_predicts=n)
        assert got[0].tolist() == np.asarray(want[0]).tolist()
        assert int(got[1]) == int(want[1])


@pytest.fixture(scope="module")
def pld_pair(tiny_model):
    """One JAX PldEngine (one compile; the zero-weight test swaps its
    params) and the reference's AR oracle."""
    jcfg, jp, _, tcfg, tp, _ = tiny_model
    return (JaxPld(jcfg, jp, JaxPldConfig(steps_per_call=8), **KW),
            JaxAr(jcfg, jp, **KW))


def test_pld_equals_ar_and_jax(tiny_model, pld_pair):
    jcfg, jp, _, tcfg, tp, _ = tiny_model
    jpld, jar = pld_pair
    jpld.params = jp
    eng = PldEngine(tcfg, tp, PldConfig(), device="cpu", **KW)
    oracle = ArBaseline(tcfg, tp, block_size=PldConfig().block,
                        device="cpu", **KW)
    rng = np.random.default_rng(0)
    jg, tg = gen(40)
    for _ in range(3):
        p = rng.integers(3, 128, size=20).tolist()
        got = eng.generate(p, tg)
        same(got, jpld.generate(p, jg))
        assert got.output_ids == jar.generate(p, jg).output_ids
        assert got.output_ids == oracle.generate(p, tg).output_ids


def test_pld_accelerates_on_repetitive_generation(tiny_model, pld_pair):
    """A zero-weight model generates token 0 forever: PLD accepts whole
    chains once the 0-run is long enough, step for step as JAX's."""
    jcfg, _, zeros, tcfg, _, tzeros = tiny_model
    jpld, _ = pld_pair
    jpld.params = zeros
    eng = PldEngine(tcfg, tzeros, PldConfig(), device="cpu", **KW)
    p = np.random.default_rng(1).integers(3, 128, size=24).tolist()
    jg, tg = gen(40)
    got = eng.generate(p, tg)
    assert got.output_ids[len(p):] == [0] * 40
    same(got, jpld.generate(p, jg))
    assert got.decode_steps <= 12


def test_pld_eos_stops(tiny_model):
    jcfg, jp, _, tcfg, tp, _ = tiny_model
    rng = np.random.default_rng(2)
    p = rng.integers(3, 128, size=16).tolist()
    probe = ArBaseline(tcfg, tp, device="cpu", **KW)
    eos = probe.generate(p, gen(12)[1]).output_ids[len(p) + 5]
    eng = PldEngine(tcfg, tp, PldConfig(), device="cpu",
                    **{**KW, "eos_token_id": eos})
    out = eng.generate(p, gen(40)[1]).output_ids[len(p):]
    assert eos in out and out.index(eos) == len(out) - 1


def test_pld_refuses_sampling(tiny_model):
    _, _, _, tcfg, tp, _ = tiny_model
    eng = PldEngine(tcfg, tp, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="greedy"):
        eng.generate([5, 6, 7], GenerationConfig(greedy=False,
                                                 temperature=0.8))


# ---------------------------------------------------------------------------
# The Token-Recycle pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes,topk", [(61, 8), (23, 8), (25, 4),
                                        (13, 4), (7, 2)])
def test_build_tr_topology_matches_jax(nodes, topk):
    want = jax_topology(nodes, topk)
    got = build_tr_topology(nodes, topk)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    parents, depths = got[0], got[1]
    assert all(parents[i] < i for i in range(1, nodes))
    assert (np.diff(depths) >= 0).all()        # levels are contiguous


@pytest.mark.parametrize("nodes,topk,M", [(61, 8, 64), (23, 8, 24),
                                          (13, 4, 16)])
def test_make_tr_draft_matches_jax(nodes, topk, M):
    """The tree fill on a given harvest: random tables where about half
    the tokens were seen, every slot against JAX's fill of it, -1 under
    unseen parents and past the tree."""
    V, B = 50, 5
    rng = np.random.default_rng(nodes)
    harvest = rng.integers(0, V, (B, V + 1, topk)).astype(np.int32)
    seen = rng.random((B, V + 1)) < 0.6
    seen[:, V] = False
    starts = rng.integers(0, V, B).astype(np.int32)
    parents, depths, _, rank = build_tr_topology(nodes, topk)
    got = make_tr_draft(parents, depths, rank, M, "cpu")(
        torch.from_numpy(harvest), torch.from_numpy(seen),
        torch.from_numpy(starts))
    fill = jax.jit(jax_tr_draft(
        *[jax_topology(nodes, topk)[i] for i in (0, 1, 3)], M))
    for b in range(B):
        want = fill(jnp.asarray(harvest[b]), jnp.asarray(seen[b]),
                    jnp.int32(starts[b]))
        assert got[b].tolist() == np.asarray(want).tolist()
    assert (got[:, nodes:] == -1).all()
    assert (got[:, 1:nodes] >= 0).any() and (got[:, 1:nodes] < 0).any()


@pytest.mark.parametrize("dups", ["none", "some", "all", "sink"])
def test_harvest_update_matches_jax(dups):
    """The scatter against JAX's ``.at[rows].set`` on the CPU (the last
    duplicate wins, which the port's rule makes explicit): rows with
    repeated tokens, rows to the sink V, per slot."""
    V, K, B, T = 20, 4, 3, 16
    rng = np.random.default_rng(len(dups))
    harvest = rng.integers(0, V, (B, V + 1, K)).astype(np.int32)
    seen = rng.random((B, V + 1)) < 0.3
    seen[:, V] = False
    hi = {"none": V, "some": 6, "all": 1, "sink": V + 1}[dups]
    if dups == "none":
        rows = np.stack([rng.permutation(V)[:T] for _ in range(B)])
    else:
        rows = rng.integers(0, hi, (B, T))
    if dups == "all":
        rows[:] = 3
    topk = rng.integers(0, V, (B, T, K)).astype(np.int32)
    h, s = torch.from_numpy(harvest.copy()), torch.from_numpy(seen.copy())
    harvest_update(h, s, torch.from_numpy(rows), torch.from_numpy(topk))
    for b in range(B):
        wh = jnp.asarray(harvest[b]).at[rows[b]].set(topk[b])
        ws = jnp.asarray(seen[b]).at[rows[b]].set(True).at[V].set(False)
        np.testing.assert_array_equal(h[b].numpy(), np.asarray(wh))
        np.testing.assert_array_equal(s[b].numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# FusedTokenRecycleEngine
# ---------------------------------------------------------------------------

TRC = dict(num_nodes=25, topk=4)


@pytest.fixture(scope="module")
def jax_tr(tiny_model):
    jcfg, jp, _, _, _, _ = tiny_model
    return JaxTr(jcfg, jp, JaxTrc(steps_per_call=8, **TRC), **KW)


def test_fused_tr_equals_ar_and_jax(tiny_model, jax_tr):
    """Three requests through one engine each side (the harvest persists
    across them): streams, decode steps and, after the run, the harvest
    and seen tables equal JAX's; outputs equal the AR oracle's."""
    jcfg, jp, _, tcfg, tp, _ = tiny_model
    jax_tr.params = jp
    eng = FusedTokenRecycleEngine(tcfg, tp, FusedTokenRecycleConfig(**TRC),
                                  device="cpu", **KW)
    oracle = ArBaseline(tcfg, tp, block_size=eng.N, device="cpu", **KW)
    rng = np.random.default_rng(0)
    jg, tg = gen(32)
    for _ in range(3):
        p = rng.integers(3, 128, size=20).tolist()
        got = eng.generate(p, tg)
        ref = oracle.generate(p, tg)
        same(got, jax_tr.generate(p, jg))
        assert got.output_ids == ref.output_ids
        assert got.decode_steps <= ref.decode_steps
    np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                  np.asarray(jax_tr.harvest))
    np.testing.assert_array_equal(eng.seens[0].numpy(),
                                  np.asarray(jax_tr.seen))


def test_fused_tr_accelerates_on_deterministic_stream(tiny_model, jax_tr):
    """Zero weights: every argmax is token 0 and every harvest row is the
    same top-K, so every tree level repeats tokens (the duplicate-row
    scatter) and whole paths are accepted; streams, steps and tables equal
    JAX's."""
    jcfg, _, zeros, tcfg, _, tzeros = tiny_model
    jax_tr.params = zeros
    jax_tr.harvest = jnp.zeros_like(jax_tr.harvest)
    jax_tr.seen = jnp.zeros_like(jax_tr.seen)
    eng = FusedTokenRecycleEngine(tcfg, tzeros,
                                  FusedTokenRecycleConfig(**TRC),
                                  device="cpu", **KW)
    p = np.random.default_rng(1).integers(3, 128, size=24).tolist()
    jg, tg = gen(40)
    got = eng.generate(p, tg)
    assert got.output_ids[len(p):] == [0] * 40
    same(got, jax_tr.generate(p, jg))
    assert got.decode_steps < 20
    np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                  np.asarray(jax_tr.harvest))
    np.testing.assert_array_equal(eng.seens[0].numpy(),
                                  np.asarray(jax_tr.seen))


def test_fused_tr_eos(tiny_model):
    _, _, _, tcfg, tp, _ = tiny_model
    rng = np.random.default_rng(2)
    p = rng.integers(3, 128, size=16).tolist()
    probe = ArBaseline(tcfg, tp, device="cpu", **KW)
    eos = probe.generate(p, gen(12)[1]).output_ids[len(p) + 5]
    eng = FusedTokenRecycleEngine(tcfg, tp, FusedTokenRecycleConfig(**TRC),
                                  device="cpu", **{**KW, "eos_token_id": eos})
    out = eng.generate(p, gen(40)[1]).output_ids[len(p):]
    assert eos in out and out.index(eos) == len(out) - 1
