"""samd_tpu_torch's chain sampling against samd_tpu's: the logit warps and
the top-p threshold equal JAX's; the chain rejection rule keeps the target
distribution (as ``tests/test_sampling_distribution.py`` holds JAX's); the
typical rule's accept length equals JAX's; the nucleus rule accepts only
the parent's sample (``tests/test_posterior_accept.py``); and the three
fused engines sample (``tests/test_batched_sampling.py``,
``tests/test_fused_sam.py``): deterministic per seed, different across
seeds, independent of the slot, the batch and the segment length, with the
greedy slots of a mixed batch equal to JAX's, and conflicting signatures
raising.  The port's counter-based stream (``ops.request_noise``) is not
JAX's threefry, so sampled streams are held by these properties, not
against JAX's tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import BatchedFusedSamEngine as JaxBatched
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import chain_posterior_accept as jax_posterior
from samd_tpu.models import init_params, tiny_config
from samd_tpu.verify import _process_logits as jax_process
from samd_tpu.verify import _top_p_threshold as jax_top_p
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, ChainNoise,
                                      FusedSamConfig, FusedSamEngine,
                                      PagedBatchedFusedSamEngine,
                                      chain_posterior_accept,
                                      chain_sampling_accept,
                                      draw_chain_noise, make_chain_accept_fn)
from samd_tpu_torch.ops.request_noise import seed_tensor
from samd_tpu_torch.verify import _process_logits, _top_p_threshold
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

V = 8
N_TRIALS = 4000
TV_TOL = 0.05
FSC = dict(n_predicts=11, steps_per_call=4, corpus_capacity=256)
KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
NEW = 14


def sig_of(**kw):
    return GenerationConfig(greedy=False, **kw).sampling_signature


# ---------------------------------------------------------------------------
# the warps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_p,top_k", [
    (1.0, 0.9, 0), (0.7, 0.5, 0), (1.0, 0.0, 5), (0.8, 0.95, 20),
    (1.3, 0.3, 3), (0.5, 1.0, 0), (1.0, 0.999, 0)])
def test_warps_match_jax(temperature, top_p, top_k):
    """Fixed seeded logits (continuous draws, no near-ties): the -inf
    positions and the top-p thresholds are equal, the kept values within
    1e-6 relative."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    logits = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    want = np.asarray(jax_process(jnp.asarray(logits), temperature, top_p,
                                  top_k))
    got = _process_logits(torch.from_numpy(logits), temperature, top_p,
                          top_k).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).any() == (top_k > 0 or top_p < 1.0)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    if 0.0 < top_p < 1.0:
        warped = logits / temperature
        np.testing.assert_array_equal(
            _top_p_threshold(torch.from_numpy(warped), top_p).numpy(),
            np.asarray(jax_top_p(jnp.asarray(warped), top_p)))


def test_top_p_keeps_argmax_and_ties():
    """The argmax alone past top_p keeps only it (and its ties); a tie at
    the cut is kept whole."""
    logits = torch.tensor([[5.0, 5.0, 0.0, -1.0], [9.0, 0.0, 0.0, 0.0]])
    out = _process_logits(logits, 1.0, 0.3, 0)
    want = jax_process(jnp.asarray(logits.numpy()), 1.0, 0.3, 0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert torch.isfinite(out[0]).tolist() == [True, True, False, False]
    assert torch.isfinite(out[1]).tolist() == [True, False, False, False]


# ---------------------------------------------------------------------------
# the chain rules
# ---------------------------------------------------------------------------

def noise_for(n, M, G, seed=0):
    """ChainNoise for n independent trials: draws 0..n-1 of one seed's
    stream."""
    return draw_chain_noise(seed_tensor([seed] * n, "cpu"),
                            torch.arange(n, dtype=torch.int32), None,
                            ("_", 0, 0, "nucleus" if G > 1 else "rejection"),
                            M, V)


def total_variation(tokens, probs):
    freq = np.bincount(np.asarray(tokens), minlength=V) / len(tokens)
    return 0.5 * np.abs(freq - probs).sum()


def emitted(accept, logits, draft, dlen, noise):
    """The token each trial emits at position 1: the accepted draft token
    or the bonus."""
    n = noise.uniform.shape[0]
    alen, bonus = accept(torch.from_numpy(logits).expand(n, -1, -1),
                         torch.tensor(draft).expand(n, -1),
                         torch.full((n,), dlen), noise)
    assert alen.shape == (n,) and bonus.shape == (n,)
    return torch.where(alen >= 2, draft[1], bonus).numpy()


@pytest.mark.parametrize("draft_tok", [0, 3])  # likely and unlikely
def test_chain_rejection_preserves_distribution(draft_tok):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, V)).astype(np.float32) * 2
    target = np.asarray(jax.nn.softmax(jnp.asarray(logits[0])))
    accept = make_chain_accept_fn(sig_of(temperature=1.0))
    toks = emitted(accept, logits, [5, draft_tok], 2,
                   noise_for(N_TRIALS, 2, 1))
    assert total_variation(toks, target) < TV_TOL


def test_chain_rejection_three_long_preserves_distribution():
    """A three-token chain (``chain_sampling_accept`` directly, as
    ``test_fused_chain_sampler_preserves_distribution`` holds JAX's)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, V)).astype(np.float32) * 2
    target = np.asarray(jax.nn.softmax(jnp.asarray(logits[0])))
    toks = emitted(chain_sampling_accept, logits, [5, 2, 6], 3,
                   noise_for(N_TRIALS, 3, 1, seed=1))
    assert total_variation(toks, target) < TV_TOL


def test_chain_rejection_temperature_warping():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, V)).astype(np.float32) * 2
    temp = 0.5
    warped = np.asarray(jax_process(jnp.asarray(logits[0]), temp, 0.0, 0))
    target = np.asarray(jax.nn.softmax(jnp.asarray(warped)))
    accept = make_chain_accept_fn(sig_of(temperature=temp))
    toks = emitted(accept, logits, [5, 1], 2, noise_for(N_TRIALS, 2, 1, 2))
    assert total_variation(toks, target) < TV_TOL


def test_chain_rejection_top_k_restricts_support():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, V)).astype(np.float32) * 2
    k = 3
    top_ids = set(np.argsort(logits[0])[-k:].tolist())
    accept = make_chain_accept_fn(sig_of(temperature=1.0, top_k=k))
    toks = emitted(accept, logits, [5, 0], 2, noise_for(N_TRIALS, 2, 1, 3))
    assert set(np.unique(toks).tolist()) <= top_ids
    warped = np.asarray(jax_process(jnp.asarray(logits[0]), 1.0, 0.0, k))
    target = np.asarray(jax.nn.softmax(jnp.asarray(warped)))
    assert total_variation(toks, target) < TV_TOL


def test_chain_rejection_all_accepted_and_rejected():
    """A draft the model is sure of is accepted whole (bonus from the last
    position); a draft it rules out stops at once (bonus never the rejected
    token)."""
    M = 4
    logits = np.full((M, V), -30.0, np.float32)
    for i, t in enumerate([1, 2, 3, 4]):
        logits[i, t] = 30.0
    noise = noise_for(64, M, 1, seed=5)
    alen, bonus = chain_sampling_accept(
        torch.from_numpy(logits).expand(64, -1, -1),
        torch.tensor([0, 1, 2, 3]).expand(64, -1), torch.full((64,), M),
        noise)
    assert (alen == M).all() and (bonus == 4).all()
    alen, bonus = chain_sampling_accept(
        torch.from_numpy(logits).expand(64, -1, -1),
        torch.tensor([0, 7, 2, 3]).expand(64, -1), torch.full((64,), M),
        noise)
    assert (alen == 1).all() and (bonus != 7).all()


def test_typical_accept_length_matches_jax():
    """The typical rule is deterministic in its accept length: equal to
    JAX's ``chain_posterior_accept`` on the same logits and drafts."""
    rng = np.random.default_rng(6)
    M, n = 6, 24
    logits = (rng.standard_normal((n, M, V)) * 2).astype(np.float32)
    peak = rng.integers(0, V, (n, M))
    for b in range(n):           # peaked rows, so runs of accepts exist
        for i in range(M):
            if rng.random() < 0.7:
                logits[b, i, peak[b, i]] += 6.0
    drafts = np.concatenate([rng.integers(0, V, (n, 1)), peak[:, :-1]], 1)
    drafts[::3, 2] = (drafts[::3, 2] + 1) % V
    dlens = rng.integers(1, M + 1, n)
    for temp, thr, alpha in ((0.8, 0.3, 0.09), (1.0, 0.1, 0.3)):
        want = [int(jax_posterior(
            jnp.asarray(logits[b]), jnp.asarray(drafts[b], jnp.int32),
            jnp.int32(dlens[b]), jax.random.PRNGKey(b), temperature=temp,
            mode="typical", posterior_threshold=thr,
            posterior_alpha=alpha)[0]) for b in range(n)]
        alen, bonus = chain_posterior_accept(
            torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(dlens), noise_for(n, M, 1, seed=7),
            temperature=temp, mode="typical", posterior_threshold=thr,
            posterior_alpha=alpha)
        assert alen.tolist() == want
        assert 1 < max(want) and min(want) == 1
        assert ((bonus >= 0) & (bonus < V)).all()


def test_nucleus_accepts_only_parent_sample():
    """Position 0 is peaked enough that its top-0.5 nucleus is one token:
    a draft of that token is accepted, any other rejected; every bonus lies
    in the last accepted position's nucleus."""
    logits = np.zeros((3, V), np.float32)
    for r, p in enumerate([3, 5, 6]):
        logits[r, p] = 8.0
    n, M = 256, 3
    noise = noise_for(n, M, M + 1, seed=8)
    accept = make_chain_accept_fn(sig_of(temperature=1.0, top_p=0.5,
                                         accept_mode="nucleus"))
    lg = torch.from_numpy(logits).expand(n, -1, -1)
    alen, _ = accept(lg, torch.tensor([7, 3, 9]).expand(n, -1),
                     torch.full((n,), 3), noise)
    assert (alen == 2).all()
    alen, bonus = accept(lg, torch.tensor([7, 9, 11 % V]).expand(n, -1),
                         torch.full((n,), 3), noise)
    assert (alen == 1).all() and (bonus == 3).all()
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, V)) * 3).astype(np.float32)
    alen, bonus = accept(torch.from_numpy(logits).expand(n, -1, -1),
                         torch.tensor([7, 0]).expand(n, -1),
                         torch.full((n,), 2), noise_for(n, 2, 3, seed=9))
    warped = np.asarray(jax_process(jnp.asarray(logits), 1.0, 0.5, 0))
    for a, t in zip(alen.tolist(), bonus.tolist()):
        assert np.isfinite(warped[a - 1, t])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(3, 128, size=int(n)).tolist()
            for n in (20, 14, 17, 22)]


def sampled(seed=11, **kw):
    kw.setdefault("temperature", 0.8)
    return GenerationConfig(max_new_tokens=NEW, max_cache_len=256,
                            greedy=False, seed=seed, **kw)


GREEDY = GenerationConfig(max_new_tokens=NEW, max_cache_len=256)


def make(kind, tcfg, tp, fsc=None, **kw):
    fc = FusedSamConfig(**{**FSC, **(fsc or {})})
    if kind == "single":
        return FusedSamEngine(tcfg, tp, fc, device="cpu", **KW, **kw)
    kw.setdefault("batch_size", 3)
    if kind == "paged":
        return PagedBatchedFusedSamEngine(tcfg, tp, fc, device="cpu",
                                          n_pages=48, page_size=16,
                                          **{**KW, **kw})
    return BatchedFusedSamEngine(tcfg, tp, fc, device="cpu", **{**KW, **kw})


def serve(eng, reqs):
    """Outputs of (prompt, gen) requests, in order."""
    if isinstance(eng, FusedSamEngine):
        return [eng.generate(p, g) for p, g in reqs]
    ids = [eng.add_request(p, g) for p, g in reqs]
    out = eng.run()
    return [out[i] for i in ids]


@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
def test_sampling_deterministic_per_seed(tiny_model, prompts, kind):
    """Same seed, same tokens; another seed differs somewhere; in the
    vocabulary and within budget; for the batched engines, the same stream
    from another slot beside other requests and with another segment
    length; and the same stream as the single-stream engine's (its noise
    comes from the same generator in the same order)."""
    _, _, tcfg, tp = tiny_model
    p = prompts[0]
    a, b = (serve(make(kind, tcfg, tp), [(p, sampled())])[0]
            for _ in range(2))
    assert a.output_ids == b.output_ids
    assert a.decode_tokens == NEW
    assert all(0 <= t < 128 for t in a.output_ids)
    c = serve(make(kind, tcfg, tp), [(p, sampled(seed=99))])[0]
    assert c.output_ids != a.output_ids
    if kind == "single":
        return
    mixed = serve(make(kind, tcfg, tp, {"steps_per_call": 3}),
                  [(prompts[1], sampled(seed=5)), (prompts[2], GREEDY),
                   (p, sampled())])
    assert mixed[2].output_ids == a.output_ids
    single = serve(make("single", tcfg, tp), [(p, sampled())])[0]
    assert single.output_ids == a.output_ids


@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
@pytest.mark.parametrize("mode,knobs", [
    ("rejection", dict(top_k=20)), ("typical", {}),
    ("nucleus", dict(top_p=0.9))])
def test_accept_modes_run(tiny_model, prompts, kind, mode, knobs):
    _, _, tcfg, tp = tiny_model
    gen = sampled(seed=3, accept_mode=mode, **knobs)
    outs = [serve(make(kind, tcfg, tp), [(prompts[0], gen)])[0]
            for _ in range(2)]
    assert outs[0].output_ids == outs[1].output_ids
    assert outs[0].decode_tokens == NEW
    assert all(0 <= t < 128 for t in outs[0].output_ids)


@pytest.fixture(scope="module")
def jax_mixed(tiny_model, prompts):
    """JAX's batched engine on a mixed batch: greedy slots 0 and 2."""
    jcfg, jp, _, _ = tiny_model
    eng = JaxBatched(jcfg, jp, JaxFsc(**FSC), batch_size=4, **KW)
    g = JaxGen(max_new_tokens=NEW, max_cache_len=256)
    s = JaxGen(max_new_tokens=NEW, max_cache_len=256, greedy=False,
               temperature=0.9, seed=3)
    ids = [eng.add_request(p, gen)
           for p, gen in zip(prompts, (g, s, g, s))]
    out = eng.run()
    return [out[ids[0]].output_ids, out[ids[2]].output_ids]


@pytest.mark.parametrize("kind", ["batched", "paged"])
def test_mixed_batch_greedy_slots_match_jax(tiny_model, prompts, jax_mixed,
                                            kind):
    """Greedy slots beside sampled ones equal JAX's greedy slots token for
    token; the sampled ones are well formed."""
    _, _, tcfg, tp = tiny_model
    s = sampled(seed=3, temperature=0.9)
    out = serve(make(kind, tcfg, tp, batch_size=4),
                list(zip(prompts, (GREEDY, s, GREEDY, s))))
    assert [out[0].output_ids, out[2].output_ids] == jax_mixed
    for i in (1, 3):
        assert out[i].decode_tokens == NEW
        assert all(0 <= t < 128 for t in out[i].output_ids)


@pytest.fixture(scope="module")
def greedy_refs(tiny_model, prompts):
    """Every prompt's greedy output from JAX's batched engine, and from the
    port's draft-length-1 oracle (``alpha=0``); the two must agree."""
    jcfg, jp, tcfg, tp = tiny_model
    eng = JaxBatched(jcfg, jp, JaxFsc(**FSC), batch_size=4, **KW)
    ids = [eng.add_request(p, JaxGen(max_new_tokens=NEW, max_cache_len=256))
           for p in prompts]
    out = eng.run()
    want = [out[i].output_ids for i in ids]
    oracle = serve(make("batched", tcfg, tp, {"alpha": 0.0}, batch_size=4),
                   [(p, GREEDY) for p in prompts])
    assert [o.output_ids for o in oracle] == want
    return want


# every draw forced: top_k = 1 (or a nucleus of the top token alone) in the
# chain, and a temperature so low that the first token, drawn from
# last_logits / temperature without top-p/top-k as in the reference, is
# the argmax
POINT_MASS = {"rejection": dict(temperature=1e-5, top_k=1),
              "nucleus": dict(temperature=1e-5, top_p=1e-6)}


@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
@pytest.mark.parametrize("mode", ["rejection", "nucleus"])
def test_point_mass_sampling_equals_greedy(tiny_model, prompts, greedy_refs,
                                           kind, mode):
    """A sampled request whose every draw is forced has an independent
    answer: JAX's greedy output and the alpha = 0 oracle's, token for
    token.  The corpus holds the outputs of prompts 0 and 1, so their
    chains accept many tokens a step (a bonus from the wrong position
    shows); in the batched engines three such slots (each its own prompt
    and seed, so a draw from the wrong logits row, slot or step shows) run
    beside a greedy one, with segments of 3 steps."""
    _, _, tcfg, tp = tiny_model
    corpus = greedy_refs[0] + [0] + greedy_refs[1] + [0]
    gens = [sampled(seed=40 + i, accept_mode=mode, **POINT_MASS[mode])
            for i in range(4)]
    gens[2] = GREEDY
    if kind == "single":
        reqs = [(p, g) for p, g in zip(prompts, gens) if g is not GREEDY]
        out = serve(make(kind, tcfg, tp, corpus=corpus), reqs)
        assert [o.output_ids for o in out] == [greedy_refs[i]
                                              for i in (0, 1, 3)]
    else:
        out = serve(make(kind, tcfg, tp, {"steps_per_call": 3},
                         corpus=corpus, batch_size=4),
                    list(zip(prompts, gens)))
        assert [o.output_ids for o in out] == greedy_refs
    assert all(o.decode_steps < NEW // 2 for o in out[:2])


@pytest.mark.parametrize("kind", ["batched", "paged"])
def test_conflicting_signatures_raise(tiny_model, prompts, kind):
    _, _, tcfg, tp = tiny_model
    eng = make(kind, tcfg, tp)
    eng.add_request(prompts[0], sampled(temperature=0.8))
    eng.add_request(prompts[1], sampled(temperature=0.5))
    with pytest.raises(ValueError, match="signature"):
        eng.run()
    if kind == "paged":
        assert len(eng.pool._free) == eng.pool.n_pages


def test_noise_only_for_live_sampled_slots():
    """A slot outside the draw mask gets zeros; a slot's draw is the same
    whatever the other slots hold."""
    sig = sig_of(temperature=0.8, accept_mode="nucleus", top_p=0.9)
    a = draw_chain_noise(seed_tensor([9, 4, 4], "cpu"),
                         torch.tensor([5, 2, 2], dtype=torch.int32),
                         torch.tensor([False, True, False]), sig, 5, V)
    b = draw_chain_noise(seed_tensor([4], "cpu"),
                         torch.tensor([2], dtype=torch.int32), None, sig, 5,
                         V)
    assert isinstance(a, ChainNoise)
    assert a.uniform.shape == (3, 5) and a.gumbel.shape == (3, 6, V)
    assert torch.equal(a.uniform[1], b.uniform[0])
    assert torch.equal(a.gumbel[1], b.gumbel[0])
    assert not a.uniform[0].any() and not a.uniform[2].any()
