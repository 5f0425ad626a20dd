"""samd_tpu_torch's batched host engines and request interleaving against
samd_tpu's (mirrors ``tests/test_batching.py`` and
``tests/test_interleave.py``; CPU, f32, tiny config): batched runs equal
single runs, a static corpus shared through per-request cursors works,
admission can be staggered, the paged engine equals the dense one and
returns every page, interleaved runs equal sequential ones, and each
equals JAX's streams."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.batching import BatchedSamdEngine as JaxBatched
from samd_tpu.batching import PagedBatchedSamdEngine as JaxPaged
from samd_tpu.cache import QuantizedKV as JaxQKV
from samd_tpu.cache import compact_accepted_batched as jax_compact
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.config import SamdConfig as JaxSamd
from samd_tpu.drafters import make_drafter as jax_make_drafter
from samd_tpu.models import init_params, tiny_config
from samd_tpu.sam import SamCursor as JaxCursor
from samd_tpu.sam import build_corpus_sam as jax_corpus_sam
from samd_tpu_torch.batching import BatchedSamdEngine, PagedBatchedSamdEngine
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import QuantizedKV, compact_accepted_batched
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.engine import SamdEngine
from samd_tpu_torch.interleave import InterleavedSamdEngine
from samd_tpu_torch.models import ModelConfig
from samd_tpu_torch.sam import SamCursor, build_corpus_sam
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

KW = dict(max_cache_len=128, eos_token_id=-1, prefill_buckets=(32,))
SAM_ONLY = dict(draft_source="sam_only", max_predicts=8, len_bias=0)
HYBRID = dict(draft_source="sam_hybrid", max_predicts=8, n_predicts=8)


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 128, size=int(rng.integers(10, 24))).tolist()
            for _ in range(n)]


def gen(n=24, **kw):
    return GenerationConfig(max_new_tokens=n, max_cache_len=128, **kw)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = ModelConfig(**{**fields, "dtype": torch.float32})
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def factory(kwargs, static=None):
    cfg = SamdConfig(**kwargs)
    return lambda: make_drafter(cfg, 128, static_sam=None if static is None
                                else SamCursor(static))


def port_batched(tiny_model, kwargs, static=None, paged=False, B=2):
    _, _, tcfg, tp = tiny_model
    if paged:
        return PagedBatchedSamdEngine(
            tcfg, tp, SamdConfig(**kwargs), factory(kwargs, static),
            batch_size=B, n_pages=16, page_size=16, device="cpu", **KW)
    return BatchedSamdEngine(tcfg, tp, SamdConfig(**kwargs),
                             factory(kwargs, static), batch_size=B,
                             device="cpu", **KW)


def port_single(tiny_model, kwargs, static=None, **kw):
    _, _, tcfg, tp = tiny_model
    return SamdEngine(tcfg, tp, SamdConfig(**kwargs),
                      factory(kwargs, static)(), device="cpu",
                      **{**KW, **kw})


def serve(engine, ps, gens):
    rids = [engine.add_request(p, g) for p, g in zip(ps, gens)]
    out = engine.run()
    assert set(out) == set(rids)
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_streams(tiny_model):
    """JAX's batched streams for the scenarios below, run once."""
    jcfg, jp, _, _ = tiny_model
    streams = {}
    for name, kwargs in (("sam_only", SAM_ONLY), ("hybrid", HYBRID)):
        cfg = JaxSamd(**kwargs)
        eng = JaxBatched(jcfg, jp, cfg, lambda: jax_make_drafter(cfg, 128),
                         batch_size=2, **KW)
        streams[name] = serve(eng, prompts(5, seed=1), [JaxGen(
            max_new_tokens=24, max_cache_len=128)] * 5)
    cfg = JaxSamd(**SAM_ONLY)
    sam = jax_corpus_sam([o.output_ids for o in streams["sam_only"][:2]],
                         eos_token=0, topk=8)
    eng = JaxPaged(jcfg, jp, cfg, lambda: jax_make_drafter(
        cfg, 128, static_sam=JaxCursor(sam)), batch_size=3, n_pages=16,
        page_size=16, **KW)
    streams["corpus_paged"] = serve(eng, prompts(4, seed=2), [JaxGen(
        max_new_tokens=16, max_cache_len=128)] * 4)
    return streams


@pytest.mark.parametrize("name,kwargs", [("sam_only", SAM_ONLY),
                                         ("hybrid", HYBRID)])
def test_batched_matches_single_and_jax(tiny_model, jax_streams, name,
                                        kwargs):
    ps = prompts(5, seed=1)
    got = serve(port_batched(tiny_model, kwargs), ps, [gen()] * 5)
    single = [port_single(tiny_model, kwargs).generate(p, gen()) for p in ps]
    for g, s, w in zip(got, single, jax_streams[name]):
        assert g.output_ids == s.output_ids == w.output_ids
        assert g.decode_tokens == s.decode_tokens
        assert g.accept_length_per_step == s.accept_length_per_step \
            == w.accept_length_per_step


@pytest.mark.parametrize("paged", [False, True])
def test_shared_corpus_cursors(tiny_model, jax_streams, paged):
    ps = prompts(4, seed=2)
    corpus = [o.output_ids for o in serve(
        port_batched(tiny_model, SAM_ONLY), prompts(5, seed=1),
        [gen()] * 5)[:2]]
    sam = build_corpus_sam(corpus, eos_token=0, topk=8)
    eng = port_batched(tiny_model, SAM_ONLY, static=sam, paged=paged, B=3)
    got = serve(eng, ps, [gen(16)] * 4)
    single = port_single(tiny_model, SAM_ONLY, static=sam)
    for g, p, w in zip(got, ps, jax_streams["corpus_paged"]):
        assert g.output_ids == single.generate(p, gen(16)).output_ids \
            == w.output_ids
    assert eng.stats.source_counts.get("sam_static", 0) > 0


def test_staggered_admission(tiny_model):
    """More requests than slots: slots are reused as requests finish."""
    ps = prompts(4, seed=3)
    gens = [gen(8) if i % 2 else gen(24) for i in range(4)]
    got = serve(port_batched(tiny_model, SAM_ONLY), ps, gens)
    single = port_single(tiny_model, SAM_ONLY)
    for g, p, gn in zip(got, ps, gens):
        assert g.decode_tokens == gn.max_new_tokens
        assert g.output_ids == single.generate(p, gn).output_ids


@pytest.mark.parametrize("kwargs", [SAM_ONLY, HYBRID])
def test_paged_matches_dense(tiny_model, kwargs):
    ps = prompts(5, seed=9)
    dense = serve(port_batched(tiny_model, kwargs), ps, [gen(20)] * 5)
    eng = port_batched(tiny_model, kwargs, paged=True)
    got = serve(eng, ps, [gen(20)] * 5)
    for g, d in zip(got, dense):
        assert g.output_ids == d.output_ids
        assert g.decode_tokens == d.decode_tokens
    assert len(eng.pool._free) == 16           # every page came back
    assert 0 < eng.peak_pages <= 16
    assert eng.live_kv_tokens() == 0


def test_paged_refuses_int8_pool(tiny_model):
    _, _, tcfg, tp = tiny_model
    with pytest.raises(ValueError, match="int8"):
        PagedBatchedSamdEngine(dataclasses.replace(tcfg, kv_quant=True), tp,
                               SamdConfig(**SAM_ONLY), factory(SAM_ONLY),
                               n_pages=16, page_size=16, device="cpu", **KW)


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_batched_equals_single(tiny_model, paged):
    """A sampled request's stream depends only on its seed: three of them
    in two slots, beside a greedy one, equal their single-stream runs;
    two signatures at once raise."""
    ps = prompts(4, seed=3)
    gens = [gen(12, greedy=False, temperature=0.8, seed=s,
                accept_mode="typical") for s in (1, 2, 3)] + [gen(12)]
    got = serve(port_batched(tiny_model, SAM_ONLY, paged=paged), ps, gens)
    single = port_single(tiny_model, SAM_ONLY)
    for g, p, gn in zip(got, ps, gens):
        assert g.output_ids == single.generate(p, gn).output_ids
    eng = port_batched(tiny_model, SAM_ONLY, paged=paged)
    eng.add_request(ps[0], gens[0])
    eng.add_request(ps[1], gen(12, greedy=False, temperature=0.5, seed=1))
    with pytest.raises(ValueError, match="signature"):
        eng.run()
    assert not any(s.active for s in eng.slots)
    if paged:
        assert len(eng.pool._free) == 16


def test_rejects_what_it_cannot_serve(tiny_model):
    eng = port_batched(tiny_model, SAM_ONLY)
    for ids, match in (([], "non-empty"), ([3, 500], "outside"),
                       (list(range(3, 40)), "bucket")):
        with pytest.raises(ValueError, match=match):
            eng.add_request(ids, gen())
    assert not eng.queue


def test_progress_stream_chunks(tiny_model):
    eng = port_batched(tiny_model, SAM_ONLY)
    ps = prompts(3, seed=4)
    chunks = {0: [], 2: []}
    for rid in chunks:
        eng.progress_listeners[rid] = chunks[rid].extend
    done = []
    eng.finish_listener = done.append
    got = serve(eng, ps, [gen(10)] * 3)
    for rid, chunk in chunks.items():
        assert ps[rid] + chunk == got[rid].output_ids
    assert sorted(done) == [0, 1, 2]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("quantized", [False, True])
def test_compact_accepted_batched_matches_jax(seed, quantized):
    rng = np.random.default_rng(300 + seed)
    L, B, KH, S, D, M = 2, 3, 2, 32, 4, 8
    offs = rng.integers(0, S - M + 1, B).astype(np.int32)
    idx = rng.integers(0, M, (B, M)).astype(np.int32)
    kv = rng.standard_normal((L, B, KH, S, D)).astype(np.float32)
    scale = rng.standard_normal((L, B, KH, S)).astype(np.float32)
    if quantized:
        q = rng.integers(-127, 128, (L, B, KH, S, D)).astype(np.int8)
        want = jax_compact(JaxQKV(jnp.asarray(q), jnp.asarray(scale)),
                           jnp.asarray(offs), jnp.asarray(idx), M)
        got = QuantizedKV(torch.from_numpy(q.copy()),
                          torch.from_numpy(scale.copy()))
        out = compact_accepted_batched(got, torch.from_numpy(offs),
                                       torch.from_numpy(idx), M)
        np.testing.assert_array_equal(out.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(out.scale.numpy(),
                                      np.asarray(want.scale))
    else:
        want = jax_compact(jnp.asarray(kv), jnp.asarray(offs),
                           jnp.asarray(idx), M)
        got = torch.from_numpy(kv.copy())
        assert compact_accepted_batched(got, torch.from_numpy(offs),
                                        torch.from_numpy(idx), M) is got
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# interleaving
# ----------------------------------------------------------------------

def port_interleaved(tiny_model, kwargs, lanes, static=None, **kw):
    _, _, tcfg, tp = tiny_model
    return InterleavedSamdEngine(tcfg, tp, SamdConfig(**kwargs),
                                 factory(kwargs, static), lanes=lanes,
                                 device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("kwargs,lanes", [(SAM_ONLY, 2), (HYBRID, 3)])
def test_interleaved_matches_sequential(tiny_model, jax_streams, kwargs,
                                        lanes):
    ps = prompts(5, seed=1)
    inter = port_interleaved(tiny_model, kwargs, lanes)
    got = serve(inter, ps, [gen()] * 5)
    for g, p, w in zip(got, ps, jax_streams[
            "sam_only" if kwargs is SAM_ONLY else "hybrid"]):
        want = port_single(tiny_model, kwargs).generate(p, gen())
        assert g.output_ids == want.output_ids == w.output_ids
        if kwargs is SAM_ONLY:      # (a lane's Token-Recycle cache spans
            assert g == want        # its requests, so its steps differ)
    assert sum(inter.stats.source_counts.values()) == \
        sum(g.decode_steps for g in got)


def test_interleaved_shared_corpus_and_sampling(tiny_model):
    ps = prompts(4, seed=2)
    sam = build_corpus_sam([prompts(1, seed=9)[0] * 3], eos_token=0, topk=4)
    gens = [gen(16), gen(12, greedy=False, temperature=0.8, seed=1),
            gen(12, greedy=False, temperature=0.8, seed=2), gen(16)]
    got = serve(port_interleaved(tiny_model, SAM_ONLY, 3, static=sam), ps,
                gens)
    single = port_single(tiny_model, SAM_ONLY, static=sam)
    for g, p, gn in zip(got, ps, gens):
        assert g.output_ids == single.generate(p, gn).output_ids


def test_interleaved_single_lane_and_eos(tiny_model):
    """lanes=1 is sequential; EOS mid-stream frees the lane."""
    ps = prompts(3, seed=4)
    eos = ps[0][-1]
    got = serve(port_interleaved(tiny_model, SAM_ONLY, 1, eos_token_id=eos),
                ps, [gen(20)] * 3)
    single = port_single(tiny_model, SAM_ONLY, eos_token_id=eos)
    for g, p in zip(got, ps):
        assert g.output_ids == single.generate(p, gen(20)).output_ids
    with pytest.raises(ValueError, match="lanes"):
        port_interleaved(tiny_model, SAM_ONLY, 0)
