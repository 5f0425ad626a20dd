"""samd_tpu_torch's host-automaton SamdEngine against samd_tpu's, on shared
weights (CPU, f32, tiny config), and its tree accept rules.

Greedy token streams (sam_only, sam_only with a static corpus, hybrid
Token Recycle, EOS truncation) must equal JAX's SamdEngine and the port's
own ArBaseline.  Typical acceptance's accept length and best path equal
JAX's on the same logits; nucleus acceptance takes only a child equal to
its parent's sample; rejection sampling keeps the target distribution
within total variation 0.05 over 4000 trials; point-mass sampled requests
equal greedy ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.config import SamdConfig as JaxSamd
from samd_tpu.drafters import make_drafter as jax_make_drafter
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.engine import SamdEngine as JaxEngine
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops.treeops import unpack_draft as jax_unpack
from samd_tpu.sam import build_corpus_sam as jax_corpus_sam
from samd_tpu.verify import nucleus_accept as jax_nucleus
from samd_tpu.verify import typical_accept as jax_typical
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.engine import ArBaseline, SamdEngine
from samd_tpu_torch.models import ModelConfig
from samd_tpu_torch.ops.request_noise import seed_tensor
from samd_tpu_torch.ops.treeops import pack_draft_host, unpack_draft
from samd_tpu_torch.sam import SamCursor, build_corpus_sam
from samd_tpu_torch.verify import (TreeNoise, _process_logits,
                                   draw_tree_noise, nucleus_accept,
                                   sampling_accept, typical_accept)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32, 64))
GEN = dict(max_new_tokens=48, max_cache_len=256)
SAM_ONLY = dict(draft_source="sam_only", alpha=4.0, len_bias=0)
HYBRID = dict(draft_source="sam_hybrid", max_predicts=24, n_predicts=12,
              len_threshold=5, len_bias=5, tree_method="token_recycle")


def prompt_ids(seed=0, n=20, vocab=128):
    return np.random.default_rng(seed).integers(3, vocab, size=n).tolist()


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = ModelConfig(**{**fields, "dtype": torch.float32})
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.fixture(scope="module")
def port_ar(tiny_model):
    _, _, tcfg, tp = tiny_model
    return ArBaseline(tcfg, tp, device="cpu", **KW)


@pytest.fixture(scope="module")
def jax_streams(tiny_model):
    """Every greedy stream of JAX's engines these tests compare with, run
    once: {(scenario, seed): Outputs}."""
    jcfg, jp, _, _ = tiny_model
    out = {}
    ar = JaxAr(jcfg, jp, **KW)
    for seed in (0, 1, 2, 4, 7):
        out["ar", seed] = ar.generate(prompt_ids(seed), JaxGen(**GEN))
    for M in (8, 24):
        cfg = JaxSamd(max_predicts=M, **SAM_ONLY)
        eng = JaxEngine(jcfg, jp, cfg, jax_make_drafter(cfg, 128), **KW)
        for seed in range(3):
            out[f"sam_only_{M}", seed] = eng.generate(prompt_ids(seed),
                                                      JaxGen(**GEN))
    cfg = JaxSamd(max_predicts=16, **SAM_ONLY)
    sam = jax_corpus_sam([out["ar", 7].output_ids], eos_token=0, topk=8)
    eng = JaxEngine(jcfg, jp, cfg, jax_make_drafter(cfg, 128,
                                                    static_sam=sam), **KW)
    out["static", 7] = eng.generate(prompt_ids(7), JaxGen(**GEN))
    cfg = JaxSamd(**HYBRID)
    eng = JaxEngine(jcfg, jp, cfg, jax_make_drafter(cfg, 128), **KW)
    for seed in (1, 4):         # the Token-Recycle cache spans requests
        out["hybrid", seed] = eng.generate(prompt_ids(seed), JaxGen(**GEN))
    return out


def port_engine(tiny_model, samd_cfg, static_sam=None, **kw):
    _, _, tcfg, tp = tiny_model
    return SamdEngine(tcfg, tp, samd_cfg,
                      make_drafter(samd_cfg, 128, static_sam=static_sam),
                      device="cpu", **{**KW, **kw})


def test_ar_baseline_runs(port_ar, jax_streams):
    out = port_ar.generate(prompt_ids(), GenerationConfig(**GEN))
    assert out.decode_tokens == 48 and out.decode_steps == 48
    assert all(a == 1 for a in out.accept_length_per_step)
    assert out.output_ids == jax_streams["ar", 0].output_ids


@pytest.mark.parametrize("max_predicts", [8, 24])
def test_sam_only_greedy_equality(tiny_model, port_ar, jax_streams,
                                  max_predicts):
    engine = port_engine(tiny_model,
                         SamdConfig(max_predicts=max_predicts, **SAM_ONLY))
    for seed in range(3):
        want = jax_streams[f"sam_only_{max_predicts}", seed]
        ref = port_ar.generate(prompt_ids(seed), GenerationConfig(**GEN))
        out = engine.generate(prompt_ids(seed), GenerationConfig(**GEN))
        assert out.output_ids == want.output_ids == ref.output_ids, seed
        assert out.accept_length_per_step == want.accept_length_per_step
        assert sum(out.accept_length_per_step) == out.decode_tokens
        assert out.decode_steps <= ref.decode_steps
    assert set(engine.stats.source_counts) == {"sam_dyn"}


def test_sam_only_with_static_corpus(tiny_model, port_ar, jax_streams):
    """A corpus holding the model's own output: long static drafts."""
    ref = port_ar.generate(prompt_ids(7), GenerationConfig(**GEN))
    static = build_corpus_sam([ref.output_ids], eos_token=0, topk=8)
    engine = port_engine(tiny_model, SamdConfig(max_predicts=16, **SAM_ONLY),
                         static_sam=SamCursor(static))
    out = engine.generate(prompt_ids(7), GenerationConfig(**GEN))
    want = jax_streams["static", 7]
    assert out.output_ids == want.output_ids == ref.output_ids
    assert out.accept_length_per_step == want.accept_length_per_step
    assert out.decode_steps < ref.decode_steps / 2
    assert engine.stats.source_counts.get("sam_static", 0) > 0
    assert engine.stats.mean_accept() > 2


def test_hybrid_token_recycle_equality(tiny_model, port_ar, jax_streams):
    engine = port_engine(tiny_model, SamdConfig(**HYBRID))
    assert engine.wants_harvest
    for seed in (1, 4):         # the same request order as JAX's
        out = engine.generate(prompt_ids(seed), GenerationConfig(**GEN))
        want = jax_streams["hybrid", seed]
        ref = port_ar.generate(prompt_ids(seed), GenerationConfig(**GEN))
        assert out.output_ids == want.output_ids == ref.output_ids, seed
        assert out.accept_length_per_step == want.accept_length_per_step
    assert "token_recycle" in engine.stats.source_counts


def test_native_and_python_automata_agree(tiny_model):
    outs = []
    for native in (True, False):
        engine = port_engine(tiny_model, SamdConfig(
            max_predicts=8, use_native_sam=native, **SAM_ONLY))
        outs.append([engine.generate(prompt_ids(s), GenerationConfig(
            max_new_tokens=24, max_cache_len=256)) for s in range(2)])
    assert outs[0] == outs[1]


def test_eos_truncation(tiny_model, port_ar):
    p = prompt_ids(2)
    ref = port_ar.generate(p, GenerationConfig(max_new_tokens=10,
                                               max_cache_len=256))
    eos = ref.output_ids[len(p) + 4]
    engine = port_engine(tiny_model, SamdConfig(max_predicts=8, **SAM_ONLY),
                         eos_token_id=eos)
    gen_part = engine.generate(p, GenerationConfig(**GEN)).output_ids[len(p):]
    assert eos in gen_part
    assert gen_part.index(eos) == len(gen_part) - 1  # stops right after EOS


def test_hidden_state_drafters_refused(tiny_model):
    """SamdEngine serves hidden-state drafters (tests/test_torch_eagle.py);
    the batched host engine and interleaving refuse them, as the
    reference's batched engine has no hidden states."""
    from samd_tpu_torch.batching import BatchedSamdEngine
    from samd_tpu_torch.interleave import InterleavedSamdEngine

    class Hidden:
        wants_hidden = True
    _, _, tcfg, tp = tiny_model
    for ctor in (BatchedSamdEngine, InterleavedSamdEngine):
        with pytest.raises(NotImplementedError, match="SamdEngine"):
            ctor(tcfg, tp, SamdConfig(), Hidden, device="cpu")


# ----------------------------------------------------------------------
# tree accept rules
# ----------------------------------------------------------------------

def random_tree(rng, M, logits, follow=0.7):
    """A random draft tree of M nodes whose children often carry one of
    their parent's two likeliest tokens, packed with both packages'
    layout."""
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, M)]
    tokens = [int(rng.integers(0, logits.shape[1]))]
    for i in range(1, M):
        top2 = np.argsort(-logits[parents[i]])[:2]
        tokens.append(int(top2[rng.integers(0, 2)]) if rng.random() < follow
                      else int(rng.integers(0, logits.shape[1])))
    return pack_draft_host(tokens, parents, M)


def both_unpacked(packed, D):
    return (unpack_draft(torch.from_numpy(packed), D),
            jax_unpack(jnp.asarray(packed), D))


def zero_noise(M, R, D, V, G=1):
    return TreeNoise(torch.zeros((D, R)),
                     torch.zeros((G, V)))


@pytest.mark.parametrize("seed", range(6))
def test_typical_accept_matches_jax(seed):
    """Typical's accept mask, run and likelihood tie-break are
    deterministic: accept length, best row, path and tokens equal
    JAX's."""
    rng = np.random.default_rng(seed)
    M, V = 12, 16
    logits = (rng.standard_normal((M, V)) * 3).astype(np.float32)
    packed = random_tree(rng, M, logits)
    (tt, _, _, tp), (jt, _, _, jpaths) = both_unpacked(packed, M)
    for temp in (1.0, 0.7):
        want = jax_typical(jnp.asarray(logits), jt, jpaths,
                           jax.random.PRNGKey(seed), temperature=temp)
        got = typical_accept(torch.from_numpy(logits), tt, tp,
                             zero_noise(M, M, M, V), temperature=temp)
        for name in ("accept_len", "best_path", "path_nodes",
                     "accepted_tokens"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          name)


def peaked(rows, peaks, V=16, scale=8.0):
    x = np.zeros((rows, V), np.float32)
    for r, p in enumerate(peaks):
        x[r, p] = scale
    return x


@pytest.mark.parametrize("case", [
    # (peaks, draft, retrieve, accept_len, best row): confident match,
    # low-probability reject, longest-then-likeliest row, padded rows
    ([3, 5], [7, 3], [[0, 1]], 2, 0),
    ([3, 5], [7, 9], [[0, 1]], 1, 0),
    ([3, 5, 5, 0], [7, 9, 3, 5], [[0, 1, -1], [0, 2, 3]], 3, 1),
    ([3, 5, 2], [7, 3, 3], [[0, 1], [2, 2]], 2, 0),
])
def test_typical_peaked_cases_match_jax(case):
    peaks, draft, retrieve, alen, best = case
    logits = peaked(len(peaks), peaks)
    want = jax_typical(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                       jnp.asarray(retrieve, jnp.int32),
                       jax.random.PRNGKey(0), temperature=1.0)
    got = typical_accept(torch.from_numpy(logits), torch.tensor(draft),
                         torch.tensor(retrieve),
                         zero_noise(len(peaks), 2, 2, 16), temperature=1.0)
    assert int(got.accept_len) == int(want.accept_len) == alen
    assert int(got.best_path) == int(want.best_path) == best
    # the bonus comes from the last accepted node's peaked distribution
    assert int(got.next_token) == int(want.next_token)


@pytest.mark.parametrize("seed", range(6))
def test_nucleus_accepts_only_parent_sample(seed):
    """Every accepted child equals its parent's sample (Gumbel rows
    0..M-1 of the noise), and the run is the longest such run over the
    root's rows."""
    rng = np.random.default_rng(seed)
    M, V, top_p = 10, 16, 0.8
    logits = (rng.standard_normal((M, V)) * 2).astype(np.float32)
    gumbel = torch.from_numpy(-np.log(-np.log(
        rng.uniform(1e-6, 1, (M + 1, V))))).float()
    warped = _process_logits(torch.from_numpy(logits), 1.0, top_p, 0)
    sampled = torch.argmax(warped + gumbel[:M], dim=-1).numpy()
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, M)]
    tokens = [3] + [int(sampled[p]) if rng.random() < 0.7
                    else int(rng.integers(0, V)) for p in parents[1:]]
    tok, _, _, paths = unpack_draft(torch.from_numpy(
        pack_draft_host(tokens, parents, M)), M)
    res = nucleus_accept(torch.from_numpy(logits), tok, paths,
                         TreeNoise(torch.zeros((M, M)), gumbel),
                         temperature=1.0, top_p=top_p)
    best = 0
    for row in paths.numpy():
        if row[0] != 0:
            continue
        run = 0
        for d in range(1, M):
            if row[d] < 0 or tokens[row[d]] != sampled[row[d - 1]]:
                break
            run += 1
        best = max(best, run)
    alen = int(res.accept_len)
    assert alen == best + 1
    nodes = res.path_nodes.numpy()
    for d in range(1, alen):
        assert tokens[nodes[d]] == sampled[nodes[d - 1]]
    # the bonus is the last accepted node's sample from the nucleus
    assert torch.isfinite(warped[nodes[alen - 1], int(res.next_token)])


def test_nucleus_peaked_cases_match_jax():
    logits = peaked(3, [3, 5, 6])
    retrieve = [[0, 1], [0, 2]]
    for draft, alen in (([7, 3, 9], 2), ([7, 9, 11], 1)):
        want = jax_nucleus(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                           jnp.asarray(retrieve, jnp.int32),
                           jax.random.PRNGKey(0), temperature=1.0, top_p=0.5)
        got = nucleus_accept(torch.from_numpy(logits), torch.tensor(draft),
                             torch.tensor(retrieve),
                             zero_noise(3, 2, 2, 16, G=4), temperature=1.0,
                             top_p=0.5)
        assert int(got.accept_len) == int(want.accept_len) == alen
        assert int(got.best_path) == int(want.best_path)


N_TRIALS, TV_TOL = 4000, 0.05


def emitted_distribution(logits, draft, retrieve, V, **kw):
    """Frequencies of the token emitted at position 1 (accepted draft or
    bonus) over N_TRIALS independent draws, all in one batched call."""
    R, D = np.asarray(retrieve).shape
    n = N_TRIALS
    noise = draw_tree_noise(seed_tensor([0] * n, "cpu"),
                            torch.arange(n, dtype=torch.int32), None,
                            ("_", 0, 0, "rejection"), len(draft), R, D, V)
    res = sampling_accept(
        torch.from_numpy(logits).expand(n, -1, -1),
        torch.tensor(draft).expand(n, -1),
        torch.tensor(retrieve).expand(n, -1, -1), noise, **kw)
    tok = torch.where(res.accept_len >= 2, res.accepted_tokens[:, 1],
                      res.next_token)
    return np.bincount(tok.numpy(), minlength=V) / n


@pytest.mark.parametrize("case", ["likely", "unlikely", "tree", "warped"])
def test_sampling_accept_keeps_target_distribution(case):
    V = 8
    rng = np.random.default_rng({"likely": 0, "unlikely": 0, "tree": 1,
                                 "warped": 2}[case])
    logits = (rng.standard_normal((3, V)) * 2).astype(np.float32)
    kw = dict(temperature=1.0, top_p=0.0, top_k=0)
    if case == "warped":
        kw = dict(temperature=0.7, top_p=0.0, top_k=5)
    target = torch.softmax(_process_logits(torch.from_numpy(logits[0]),
                                           kw["temperature"], kw["top_p"],
                                           kw["top_k"]), -1).numpy()
    if case == "tree":       # two children of the root, different tokens
        draft, retrieve = [5, int(target.argmax()), 2], [[0, 1], [0, 2]]
    else:
        tok = int(target.argmax()) if case == "likely" else \
            int(target.argmin())
        draft, retrieve = [5, tok, 1], [[0, 1, 2]]
    freq = emitted_distribution(logits, draft, retrieve, V, **kw)
    assert 0.5 * np.abs(freq - target).sum() < TV_TOL


def invalid_node_tree(rng, M, V):
    """Random parents (node 0 the root) and draft tokens where about a
    third of the nodes carry -1, as the fused tree drafters mark a node
    under a never-harvested token, and so do all their descendants; node 1
    is a -1 child of the root.  The real children mostly carry token 0 or
    V - 1, where the logits put their mass."""
    parents = [-1, 0] + [int(rng.integers(0, i)) for i in range(2, M)]
    tokens = [5, -1]
    for i in range(2, M):
        if tokens[parents[i]] < 0 or rng.random() < 0.3:
            tokens.append(-1)
        elif rng.random() < 0.7:
            tokens.append(int(rng.choice([0, V - 1])))
        else:
            tokens.append(int(rng.integers(0, V)))
    return np.asarray(parents, np.int32), np.asarray(tokens, np.int32)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("mode", ["rejection", "typical", "nucleus"])
def test_tree_rules_never_accept_invalid_nodes(mode, seed):
    """A -1 draft node is no candidate for any tree rule: over many noise
    draws no accepted path holds one, and every result (accept length,
    path, tokens, bonus and the logits it was drawn from, the rejection
    rule's residual) equals the result on the same tree with those nodes
    removed from its paths.  The logits put most mass on token 0 and on
    the last token, the tokens whose probability the reference reads for
    a -1 node."""
    from samd_tpu_torch.fused_hybrid import constant_buffers

    M, V, n = 12, 16, 400
    rng = np.random.default_rng(seed)
    parents, tokens = invalid_node_tree(rng, M, V)
    logits = (rng.standard_normal((M, V)) * 0.5).astype(np.float32)
    logits[:, [0, V - 1]] += 3.0
    paths = constant_buffers(parents, M)[2]                    # [M, M]
    removed = torch.where(
        torch.from_numpy(tokens)[paths.clamp(min=0).long()] < 0, -1, paths)
    noise = draw_tree_noise(seed_tensor([seed] * n, "cpu"),
                            torch.arange(n, dtype=torch.int32), None,
                            ("_", 0, 0, mode), M, M, M, V)
    rule = {"rejection": lambda *a: sampling_accept(
                *a, temperature=1.0, top_p=0.0, top_k=0),
            "typical": lambda *a: typical_accept(*a, temperature=1.0),
            "nucleus": lambda *a: nucleus_accept(*a, temperature=1.0,
                                                 top_p=0.9)}[mode]
    lg = torch.from_numpy(logits).expand(n, -1, -1)
    draft = torch.from_numpy(tokens).expand(n, -1)
    got = rule(lg, draft, paths.expand(n, -1, -1), noise)
    want = rule(lg, draft, removed.expand(n, -1, -1), noise)
    alen = got.accept_len.long()
    on_path = torch.arange(M)[None, :] < alen[:, None]
    taken = torch.gather(draft.long(), 1, got.path_nodes.long())
    assert (taken[on_path] >= 0).all()
    assert (alen >= 2).any()
    np.testing.assert_array_equal(got.accept_len, want.accept_len)
    for name in ("path_nodes", "accepted_tokens"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a[on_path], b[on_path]), name
    np.testing.assert_array_equal(got.next_token, want.next_token)
    assert torch.equal(got.next_logits, want.next_logits)


# ----------------------------------------------------------------------
# sampled requests through the engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,knobs", [
    ("rejection", dict(top_k=50)), ("typical", {}),
    ("nucleus", dict(top_p=0.9))])
def test_sampled_requests_deterministic_per_seed(tiny_model, mode, knobs):
    engine = port_engine(tiny_model, SamdConfig(max_predicts=8, **SAM_ONLY))

    def gen(seed):
        return GenerationConfig(max_new_tokens=24, max_cache_len=256,
                                greedy=False, temperature=0.8, seed=seed,
                                accept_mode=mode, **knobs)
    p = prompt_ids(5)
    a, b = engine.generate(p, gen(123)), engine.generate(p, gen(123))
    assert a.output_ids == b.output_ids
    assert a.decode_tokens == 24
    assert all(0 <= t < 128 for t in a.output_ids)
    assert engine.generate(p, gen(7)).output_ids != a.output_ids


@pytest.mark.parametrize("samd,knobs", [
    ("static", dict(top_k=1)),                                # rejection
    ("static", dict(accept_mode="nucleus", top_p=1e-6)),
    ("hybrid", dict(top_k=1)),
])
def test_point_mass_sampling_equals_greedy(tiny_model, port_ar, samd, knobs):
    """Every draw forced (top_k 1, or a nucleus of the top token, at
    temperature 1e-5): a sampled request's stream is the greedy one, also
    where the drafts are trees that accept many tokens."""
    p = prompt_ids(7)
    ref = port_ar.generate(p, GenerationConfig(**GEN))
    if samd == "static":
        static = build_corpus_sam([ref.output_ids], eos_token=0, topk=8)
        engine = port_engine(tiny_model,
                             SamdConfig(max_predicts=16, **SAM_ONLY),
                             static_sam=SamCursor(static))
    else:
        engine = port_engine(tiny_model, SamdConfig(**HYBRID))
    out = engine.generate(p, GenerationConfig(
        **GEN, greedy=False, temperature=1e-5, seed=3, **knobs))
    assert out.output_ids == ref.output_ids
    assert max(out.accept_length_per_step) > 1
