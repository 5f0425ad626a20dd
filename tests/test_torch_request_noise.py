"""The per-request device stream (``ops.request_noise``) and the engines
that draw from it.

The plain Philox4x32-10 against Random123's known-answer vectors;
``request_uniforms_plain`` against a numpy uint64 reference; the uniforms'
range and moments; the draw mask.  Then, on tiny models in f32, one
sampled request's tokens stay the same whatever else happens: in any slot,
beside greedy and other sampled requests, at ``steps_per_call`` 1, 3 and
16, on the graph route and the per-step route, on the batched, paged,
hybrid and SAM[EAGLE-2] engines, as the single-stream engine of the same
family gives them, and on a paged pool so small that the slot stops at
its page limit and resumes.  The greedy slots of such a mixed batch equal
JAX's batched engine's.  The stream is not JAX's threefry, so sampled
tokens are held by these properties, not against JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.drafters.eagle.net import EagleNetConfig as JaxNetCfg
from samd_tpu.drafters.eagle.net import init_eagle_params as jax_init_net
from samd_tpu.fused_sam import BatchedFusedSamEngine as JaxBatched
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.models import init_params, tiny_config
from samd_tpu_torch.bridge import eagle_params_from_jax, params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.device_loop import LAUNCH_COUNTERS
from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEagleEngine,
                                         BatchedFusedHybridEngine,
                                         FusedHybridConfig,
                                         FusedHybridEagleConfig,
                                         FusedHybridEagleEngine,
                                         FusedHybridEngine,
                                         PagedBatchedFusedHybridEagleEngine,
                                         PagedBatchedFusedHybridEngine)
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.ops.request_noise import (philox4x32_10,
                                              request_uniforms,
                                              request_uniforms_plain,
                                              seed_tensor, seed_word)
from samd_tpu_torch.verify import draw_first_token, draw_tree_noise
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

# Random123's known-answer vectors for Philox4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((M32,) * 4, (M32, M32),
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    def words(xs):
        return tuple(torch.tensor([x], dtype=torch.int64) for x in xs)

    got = philox4x32_10(words(ctr), words(key))
    assert tuple(int(w) for w in got) == want


def np_philox(ctr, key):
    """Philox4x32-10 in numpy uint64 (the products exact below 2^64)."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = (np.asarray(x, np.uint64) for x in key)
    m = np.uint64(M32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m
            k1 = (k1 + np.uint64(0xBB67AE85)) & m
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m]
    return c


def np_uniforms(seeds, draws, n):
    """The stream's definition, element by element, in numpy."""
    s = np.asarray([x % (1 << 64) for x in seeds], np.uint64)[:, None]
    j = np.arange(n, dtype=np.uint64)[None, :]
    d = np.asarray(draws, np.uint64)[:, None] & np.uint64(M32)
    zero = np.zeros_like(d)
    w = np_philox((j >> np.uint64(2), d, zero, zero),
                  (s & np.uint64(M32), s >> np.uint64(32)))
    words = np.stack(np.broadcast_arrays(*w), axis=-1)      # [B, n, 4]
    pick = np.take_along_axis(words, (j & np.uint64(3)).astype(np.int64)[
        ..., None].repeat(len(seeds), 0), axis=-1)[..., 0]
    return ((pick >> np.uint64(8)).astype(np.float64)
            * 2.0 ** -24).astype(np.float32)


@pytest.mark.parametrize("case", range(4))
def test_plain_matches_numpy_reference(case):
    rng = np.random.default_rng(case)
    B = int(rng.integers(1, 6))
    n = int(rng.integers(1, 70))
    seeds = [int(x) for x in rng.integers(0, 1 << 63, size=B)]
    seeds[0] = -seeds[0] - 1                      # a negative seed, mod 2^64
    if B > 1:
        seeds[1] += 1 << 64                       # beyond 2^64
    draws = rng.integers(0, 1 << 31, size=B).astype(np.int32)
    got = request_uniforms_plain(seed_tensor(seeds, "cpu"),
                                 torch.from_numpy(draws), n)
    np.testing.assert_array_equal(got.numpy(), np_uniforms(seeds, draws, n))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(request_uniforms(seed_tensor(seeds, "cpu"),
                                        torch.from_numpy(draws), n), got)


def test_uniform_range_and_moments():
    seeds = seed_tensor(range(8), "cpu")
    u = request_uniforms(seeds, torch.arange(8, dtype=torch.int32), 20000)
    assert u.dtype == torch.float32 and u.shape == (8, 20000)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    x = u.double()
    assert abs(float(x.mean()) - 0.5) < 0.005
    assert abs(float(x.var()) - 1 / 12) < 0.002
    # neighbouring elements, draws and seeds are uncorrelated
    for a, b in ((x[:, 1:], x[:, :-1]), (x[1:], x[:-1])):
        r = float(((a - 0.5) * (b - 0.5)).mean()) * 12
        assert abs(r) < 0.01


def test_mask_draw_index_and_seed_word():
    seeds = seed_tensor([3, 3, 4], "cpu")
    draws = torch.tensor([0, 1, 0], dtype=torch.int32)
    u = request_uniforms(seeds, draws, 9, torch.tensor([True, True, False]))
    assert not u[2].any()
    assert not torch.equal(u[0], u[1])            # another draw index
    alone = request_uniforms(seed_tensor([3], "cpu"),
                             torch.tensor([1], dtype=torch.int32), 9)
    assert torch.equal(u[1], alone[0])            # whatever the other rows
    # a longer draw extends a shorter one of the same index
    assert torch.equal(request_uniforms(seeds, draws, 5),
                       request_uniforms(seeds, draws, 9)[:, :5])
    assert seed_word(-1) == -1 and seed_word(1 << 64) == 0
    assert seed_word((1 << 63) + 2) == -(1 << 63) + 2
    with pytest.raises(ValueError):
        request_uniforms(seeds.int(), draws, 4)
    with pytest.raises(ValueError):
        request_uniforms(seeds, draws.long(), 4)
    with pytest.raises(ValueError):
        request_uniforms(seeds, draws, 0)


def test_first_token_and_tree_noise_read_the_stream():
    """The first token is draw 0 (V uniforms as Gumbel noise); a tree step
    reads D * R uniforms and then G * V Gumbel rows of its draw."""
    V, M = 16, 4
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, V)).astype(np.float32))
    seeds = seed_tensor([7, 8], "cpu")
    zeros = torch.zeros(2, dtype=torch.int32)
    u0 = request_uniforms(seeds, zeros, V)
    g = -torch.log(-torch.log(torch.clamp(u0, min=torch.finfo(
        torch.float32).tiny)))
    want = torch.argmax(logits / 0.7 + g, dim=-1).to(torch.int32)
    assert torch.equal(draw_first_token(seeds, logits, 0.7), want)
    draws = torch.tensor([3, 5], dtype=torch.int32)
    noise = draw_tree_noise(seeds, draws, torch.tensor([True, False]),
                            ("_", 0, 0, "nucleus"), M, M, M, V)
    u = request_uniforms(seeds, draws, M * M + (M + 1) * V)
    assert torch.equal(noise.uniform[0], u[0, :M * M].reshape(M, M))
    assert noise.gumbel.shape == (2, M + 1, V)
    assert not noise.uniform[1].any()


# ---------------------------------------------------------------------------
# the engines: one sampled request, one stream
# ---------------------------------------------------------------------------

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
NEW = 20
FSC = dict(n_predicts=11, corpus_capacity=256)
HY = dict(max_ngram=4, ext=12, n_predicts=8, len_threshold=2, len_bias=0,
          tree_nodes=13, topk=4, max_block=16, corpus_capacity=1024)
EAGLE = dict(max_ngram=4, ext=12, n_predicts=8, len_threshold=2, len_bias=0,
             eagle_depth=2, eagle_topk=3, eagle_total=7, max_block=16,
             corpus_capacity=1024)
PAGES = dict(n_pages=48, page_size=16)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    jnet = jax_init_net(JaxNetCfg.from_target(jcfg), jax.random.PRNGKey(7))
    return (jcfg, jp, port_config(jcfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            eagle_params_from_jax(jax.tree.map(np.asarray, jnet), "cpu"))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(17)
    ps = [rng.integers(3, 128, size=int(n)).tolist()
          for n in (20, 14, 17, 22)]
    return ps, sum([p + [0] for p in ps], [])


def sampled(seed, mode="rejection", **kw):
    knobs = {"rejection": dict(top_k=20), "typical": {},
             "nucleus": dict(top_p=0.9)}[mode]
    return GenerationConfig(max_new_tokens=NEW, max_cache_len=256,
                            greedy=False, temperature=0.8, seed=seed,
                            accept_mode=mode, **{**knobs, **kw})


GREEDY = GenerationConfig(max_new_tokens=NEW, max_cache_len=256)
FAMILIES = ("chain", "hybrid", "eagle")


def single(model, family, corpus):
    """A fresh single-stream engine of ``family``."""
    _, _, tcfg, tp, net = model
    if family == "chain":
        return FusedSamEngine(tcfg, tp, FusedSamConfig(**FSC), corpus=corpus,
                              device="cpu", **KW)
    if family == "hybrid":
        return FusedHybridEngine(tcfg, tp, FusedHybridConfig(**HY),
                                 corpus=corpus, device="cpu", **KW)
    return FusedHybridEagleEngine(tcfg, tp, FusedHybridEagleConfig(**EAGLE),
                                  net_params=net, corpus=corpus,
                                  device="cpu", **KW)


def batched(model, family, paged, corpus, spc, batch_size=4, pages=PAGES):
    _, _, tcfg, tp, net = model
    kw = dict(corpus=corpus, batch_size=batch_size, device="cpu", **KW)
    if paged:
        kw.update(pages)
    if family == "chain":
        ctor = PagedBatchedFusedSamEngine if paged else BatchedFusedSamEngine
        return ctor(tcfg, tp, FusedSamConfig(steps_per_call=spc, **FSC),
                    **kw)
    if family == "hybrid":
        ctor = PagedBatchedFusedHybridEngine if paged \
            else BatchedFusedHybridEngine
        return ctor(tcfg, tp, FusedHybridConfig(steps_per_call=spc, **HY),
                    **kw)
    ctor = PagedBatchedFusedHybridEagleEngine if paged \
        else BatchedFusedHybridEagleEngine
    return ctor(tcfg, tp, FusedHybridEagleConfig(steps_per_call=spc,
                                                 **EAGLE),
                net_params=net, **kw)


def serve(eng, reqs):
    ids = [eng.add_request(p, g) for p, g in reqs]
    out = eng.run()
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def alone(model, prompts):
    """The target request (prompt 0, seed 11) served alone by each
    family's single-stream engine, under rejection and nucleus."""
    ps, corpus = prompts
    return {(f, mode): single(model, f, corpus).generate(
        ps[0], sampled(11, mode)).output_ids
        for f in FAMILIES for mode in ("rejection", "nucleus")}


@pytest.mark.parametrize("spc", [1, 3, 16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_request_same_in_any_slot(model, prompts, alone, family,
                                          paged, spc):
    """The target request in the last slot, beside a greedy request and two
    other sampled ones, gives the single-stream engine's tokens; the
    per-step route gives the same batch."""
    ps, corpus = prompts
    mode = "nucleus" if spc == 3 else "rejection"
    reqs = [(ps[1], sampled(5, mode)), (ps[2], GREEDY),
            (ps[3], sampled(23, mode)), (ps[0], sampled(11, mode))]
    eng = batched(model, family, paged, corpus, spc)
    got = serve(eng, reqs)
    assert got[3].output_ids == alone[(family, mode)]
    assert got[3].decode_tokens == NEW
    eager = batched(model, family, paged, corpus, spc)
    eager.segmented = False
    assert serve(eager, reqs) == got
    # the target again in slot 0 of a batch of two, beside a greedy one
    two = serve(batched(model, family, paged, corpus, spc, batch_size=2),
                [reqs[3], reqs[1 if spc == 16 else 2]])
    assert two[0].output_ids == alone[(family, mode)]


@pytest.fixture(scope="module")
def jax_greedy(model, prompts):
    """JAX's batched chain engine on prompts 1-3, greedy."""
    jcfg, jp, _, _, _ = model
    ps, corpus = prompts
    out = []
    for spc in (1, 3, 16):
        eng = JaxBatched(jcfg, jp, JaxFsc(steps_per_call=spc, **FSC),
                         corpus=corpus, batch_size=4, **KW)
        ids = [eng.add_request(p, JaxGen(max_new_tokens=NEW,
                                         max_cache_len=256))
               for p in ps[1:]]
        res = eng.run()
        out.append([res[i].output_ids for i in ids])
    assert out[0] == out[1] == out[2]
    return out[0]


@pytest.mark.parametrize("spc", [1, 3, 16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_segments_greedy_slots_match_jax(model, prompts, jax_greedy,
                                               paged, spc):
    """Greedy slots in segments that sample, on the graph route: token for
    token JAX's greedy outputs."""
    ps, corpus = prompts
    reqs = [(ps[0], sampled(11)), (ps[1], GREEDY), (ps[2], GREEDY),
            (ps[3], GREEDY)]
    got = serve(batched(model, "chain", paged, corpus, spc), reqs)
    assert [o.output_ids for o in got[1:]] == jax_greedy


@pytest.mark.parametrize("family", FAMILIES)
def test_paged_slot_resumed_keeps_its_stream(model, prompts, alone, family):
    """A pool of 9 pages of 16 for three requests that need 4 or 5 each:
    slots stop at their page limit and resume once pages free; the target
    request's tokens are still the single-stream engine's."""
    ps, corpus = prompts
    eng = batched(model, family, True, corpus, 4, batch_size=3,
                  pages=dict(n_pages=9, page_size=16))
    retried = []
    should_retry = eng._should_retry_slot

    def counted(slot, hist_len, budget):
        out = should_retry(slot, hist_len, budget)
        retried.append(out)
        return out

    eng._should_retry_slot = counted
    reqs = [(ps[3], sampled(23)), (ps[1], sampled(5)), (ps[0], sampled(11))]
    got = serve(eng, reqs)
    assert any(retried)
    assert got[2].output_ids == alone[(family, "rejection")]
    assert len(eng.pool._free) == eng.pool.n_pages


@pytest.mark.parametrize("family", FAMILIES)
def test_single_stream_noise_launch_count(model, prompts, family):
    """On the CPU the wrapper runs its plain version and counts nothing;
    the counter is one of the device loop's launch counters."""
    assert (request_uniforms, "launches") in LAUNCH_COUNTERS
    before = request_uniforms.launches
    ps, corpus = prompts
    out = single(model, family, corpus).generate(ps[2], sampled(3))
    assert out.decode_tokens == NEW
    assert request_uniforms.launches == before
