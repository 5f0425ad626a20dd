"""samd_tpu_torch's device loop (``device_loop``): segments of steps with
one control read each, against samd_tpu's ``lax.while_loop`` engines.

On the CPU a segment runs its steps eagerly.  Here: the segment rule
(``segment_length``) never runs a step past a stop that the host could
foresee; a step after a stop is a no-op in every covered engine; the
segmented engines equal JAX's token for token and step for step, with
JAX's ``steps_per_call`` at 3 and 256; and the holder's launch
arithmetic, with a stub step and a stand-in graph.  The card's graph
replays are held against eager steps in ``test_torch_device_loop_cuda.py``
(no JAX there)."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import BatchedFusedSamEngine as JaxBatched
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.fused_sam import PagedBatchedFusedSamEngine as JaxPaged
from samd_tpu.models import init_params, tiny_config
from samd_tpu.pld import PldConfig as JaxPldConfig
from samd_tpu.pld import PldEngine as JaxPld
from samd_tpu.token_recycle_fused import FusedTokenRecycleConfig as JaxTrc
from samd_tpu.token_recycle_fused import FusedTokenRecycleEngine as JaxTr
from samd_tpu_torch import device_loop
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.device_loop import (LAUNCH_COUNTERS, StepGraphs,
                                        segment_length)
from samd_tpu_torch.eagle_fused import FusedEagle2Engine
from samd_tpu_torch.fused_base import finalize_generation
from samd_tpu_torch.fused_hybrid import FusedHybridConfig, FusedHybridEngine
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.pld import PldConfig, PldEngine
from samd_tpu_torch.token_recycle_fused import (FusedTokenRecycleConfig,
                                                FusedTokenRecycleEngine)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

V = 128
KW = dict(max_cache_len=256, prefill_buckets=(32,))
TRC = dict(num_nodes=25, topk=4)
PAGE = 32


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=V)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def prompt(seed, n=20):
    return np.random.default_rng(seed).integers(3, V, size=n).tolist()


# ---------------------------------------------------------------------------
# The segment rule
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(hl=st.integers(0, 300), left=st.integers(1, 300),
       block=st.integers(1, 64), room=st.integers(0, 400),
       spc=st.integers(1, 300), tree=st.booleans(),
       prompt_rest=st.integers(0, 200), refill=st.booleans(),
       data=st.data())
def test_segment_rule_has_no_foreseeable_overrun(hl, left, block, room, spc,
                                                 tree, prompt_rest, refill,
                                                 data):
    """A request that ends by its budget or by the cache limit is live in
    every step of every segment the rule gives it, whatever each step
    commits (1 to A tokens; a prompt step commits the next block of the
    prompt and spends no budget)."""
    A = data.draw(st.integers(1, block)) if tree else block
    limit = hl + block + room
    pr = prompt_rest

    def live():
        return left > 0 and hl + block <= limit

    while live():
        k = segment_length([hl], [left], [limit], block, A, spc, refill,
                           [pr])
        assert 1 <= k <= spc
        for _ in range(k):
            assert live(), "a step past a foreseeable stop"
            if pr > 0:
                c = min(pr, block)
                pr -= c
            else:
                c = data.draw(st.integers(1, A))
                left -= c
            hl += c


def test_segment_rule_min_with_refill_max_without():
    # three live slots certain for 1, 4 and 2 steps (M 4, chains)
    hls, lefts, lims = [0, 0, 0], [3, 16, 8], [100, 100, 100]
    assert segment_length(hls, lefts, lims, 4, 4, 256, refill=True) == 1
    assert segment_length(hls, lefts, lims, 4, 4, 256) == 4
    assert segment_length(hls, lefts, lims, 4, 4, 3) == 3
    # the cache decides: hl 90 of 100 leaves room for 2 steps of 4
    assert segment_length([90], [100], [100], 4, 4, 256) == 2
    # inline prefill: 10 prompt tokens are 3 steps, then 2 of budget
    assert segment_length([0], [8], [100], 4, 4, 256,
                          prompt_rest=[10]) == 5


@settings(max_examples=8, deadline=None)
@given(n=st.integers(2, 32), new=st.integers(1, 120),
       npred=st.sampled_from([3, 7, 15]), S=st.sampled_from([64, 96, 128]),
       spc=st.integers(1, 40), seed=st.integers(0, 99))
def test_engine_runs_no_overrun_and_equals_per_step(tiny_model, n, new,
                                                    npred, S, spc, seed):
    """``FusedSamEngine`` over prompt, budget, M, W and ``steps_per_call``:
    a request that ends by budget or by the cache limit runs no step past
    its stop, and its tokens and steps equal the per-step route's."""
    _, _, tcfg, tp = tiny_model
    kw = dict(max_cache_len=S, prefill_buckets=(32,), eos_token_id=-1,
              device="cpu")
    fc = FusedSamConfig(n_predicts=npred, steps_per_call=spc)
    eng = FusedSamEngine(tcfg, tp, fc, **kw)
    ref = FusedSamEngine(tcfg, tp, fc, **kw)
    ref.segmented = False
    p = prompt(seed, n)
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    got, want = eng.generate(p, gen), ref.generate(p, gen)
    assert got == want
    st_ = eng.loop_stats
    assert st_.noop_steps == 0
    assert st_.steps == got.decode_steps
    assert ref.loop_stats.segments == want.decode_steps
    if got.decode_steps > fc.block and spc > 1:
        assert st_.segments < got.decode_steps


# ---------------------------------------------------------------------------
# A step after a stop is a no-op
# ---------------------------------------------------------------------------

def single_engine(kind, tcfg, tp, eos, S=256):
    kw = dict(max_cache_len=S, prefill_buckets=(32,), eos_token_id=eos,
              device="cpu")
    if kind == "fused_sam":
        return FusedSamEngine(tcfg, tp, FusedSamConfig(n_predicts=7), **kw)
    if kind == "pld":
        return PldEngine(tcfg, tp, PldConfig(), **kw)
    if kind == "hybrid":
        return FusedHybridEngine(tcfg, tp, FusedHybridConfig(
            tree_nodes=23, topk=4, n_predicts=20, max_block=24), **kw)
    if kind == "eagle":
        return FusedEagle2Engine(tcfg, tp, depth=4, topk=4, total_tokens=23,
                                 **kw)
    return FusedTokenRecycleEngine(tcfg, tp, FusedTokenRecycleConfig(**TRC),
                                   **kw)


def eos_of(engine_out, p, at=5):
    return engine_out.output_ids[len(p) + at]


@pytest.mark.parametrize("kind", ["fused_sam", "pld", "token_recycle",
                                  "hybrid", "eagle"])
@pytest.mark.parametrize("stop", ["eos", "budget", "cache"])
def test_single_stream_steps_after_stop_are_noops(tiny_model, kind, stop):
    """After a request stops (an EOS, its budget, the cache's end), k more
    steps change neither ``history[:hl]``, ``hl``, the budget, the start
    token nor the output (nor a Token-Recycle harvest table, nor the
    EAGLE net's last hidden state), and stay inside the cache."""
    _, _, tcfg, tp = tiny_model
    p = prompt(3, 24)
    S, new = (64, 200) if stop == "cache" else (256, 40)
    gen = GenerationConfig(max_new_tokens=new, max_cache_len=S)
    eos = -1
    if stop == "eos":
        eos = eos_of(single_engine(kind, tcfg, tp, -1).generate(p, gen), p)
    eng = single_engine(kind, tcfg, tp, eos, S)
    out = eng.generate(p, gen)
    if stop == "eos":
        assert out.output_ids[-1] == eos and bool(eng._done)
    W = eng.kv_k.shape[3]
    hl = int(eng._hist_len)
    if stop == "cache":
        assert hl > eng._last_start(W)
    snap = [t.clone() for t in (eng._history[:hl], eng._hist_len,
                                eng._budget, eng._start, eng._done)]
    tables = [(getattr(eng, n), getattr(eng, n).clone())
              for n in ("harvests", "seens", "last_hiddens")
              if hasattr(eng, n)]
    eng.graphs.run((W, None), eng._loop_step(W, None, None), 3)
    after = (eng._history[:hl], eng._hist_len, eng._budget, eng._start,
             eng._done)
    for a, b in zip(snap, after):
        assert torch.equal(a, b)
    for now, before in tables:
        assert torch.equal(now, before)
    assert int(eng._live_steps) == out.decode_steps
    assert finalize_generation(eng._history, hl, len(p), eos,
                               new) == out.output_ids


@pytest.mark.parametrize("kind", ["batched", "paged"])
def test_batched_steps_after_stop_are_noops(tiny_model, kind):
    """After ``run`` every slot has stopped (one by an EOS); more steps of
    the segment's step change no slot's committed history, length, budget
    or start token."""
    _, _, tcfg, tp = tiny_model
    ps = [prompt(s, 12 + 3 * s) for s in range(3)]
    first = FusedSamEngine(tcfg, tp, FusedSamConfig(n_predicts=7),
                           eos_token_id=-1, device="cpu", **KW).generate(
        ps[0], GenerationConfig(max_new_tokens=24, max_cache_len=256))
    eos = eos_of(first, ps[0])
    fc = FusedSamConfig(n_predicts=7, steps_per_call=64)
    kw = dict(batch_size=2, eos_token_id=eos, device="cpu", **KW)
    eng = BatchedFusedSamEngine(tcfg, tp, fc, **kw) if kind == "batched" \
        else PagedBatchedFusedSamEngine(tcfg, tp, fc, n_pages=32,
                                        page_size=PAGE, **kw)
    ids = [eng.add_request(p, GenerationConfig(max_new_tokens=24,
                                               max_cache_len=256))
           for p in ps]
    out = eng.run()
    assert out[ids[0]].output_ids[-1] == eos
    assert sum(s.noop_steps for s in eng.loop_stats.values()) > 0
    hl = eng._seg[0].clone()
    snap = [eng._seg[:3].clone(), eng._lives.clone()] + [
        eng.histories[b, :int(hl[b])].clone() for b in range(eng.B)]
    assert not bool(eng._lives.any())
    step = eng._segment_step(eng._paged_aux())
    for _ in range(3):
        step()
    after = [eng._seg[:3], eng._lives] + [
        eng.histories[b, :int(hl[b])] for b in range(eng.B)]
    for a, b in zip(snap, after):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The segmented engines against JAX's while-loop engines
# ---------------------------------------------------------------------------

def jax_single(kind, jcfg, jp, spc, eos):
    kw = dict(eos_token_id=eos, **KW)
    if kind == "fused_sam":
        return JaxFused(jcfg, jp, JaxFsc(n_predicts=7, steps_per_call=spc,
                                         len_bias=0), **kw)
    if kind == "pld":
        return JaxPld(jcfg, jp, JaxPldConfig(steps_per_call=spc), **kw)
    return JaxTr(jcfg, jp, JaxTrc(steps_per_call=spc, **TRC), **kw)


def port_single(kind, tcfg, tp, spc, eos):
    kw = dict(eos_token_id=eos, device="cpu", **KW)
    if kind == "fused_sam":
        return FusedSamEngine(tcfg, tp, FusedSamConfig(
            n_predicts=7, steps_per_call=spc, len_bias=0), **kw)
    if kind == "pld":
        return PldEngine(tcfg, tp, PldConfig(steps_per_call=spc), **kw)
    return FusedTokenRecycleEngine(tcfg, tp, FusedTokenRecycleConfig(
        steps_per_call=spc, **TRC), **kw)


def serve_batch(eng, ps, new, gen_cls):
    ids = [eng.add_request(p, gen_cls(max_new_tokens=new, max_cache_len=256))
           for p in ps]
    out = eng.run()
    return [out[i] for i in ids]


def same(got, want):
    assert got.output_ids == want.output_ids
    assert got.decode_tokens == want.decode_tokens
    assert got.decode_steps == want.decode_steps


@pytest.mark.parametrize("spc", [3, 256])
@pytest.mark.parametrize("kind", ["fused_sam", "pld", "token_recycle",
                                  "batched", "paged"])
def test_segmented_engines_match_jax(tiny_model, kind, spc):
    """Token streams and decode steps equal the reference's, whose loop
    runs ``steps_per_call`` steps per call; one request ends at an EOS
    inside a segment, so the port's segment overruns it with no-op steps
    that no decode step counts."""
    jcfg, jp, tcfg, tp = tiny_model
    ps = [prompt(s, 14 + 2 * s) for s in range(3)]
    new = 24
    if kind in ("fused_sam", "pld", "token_recycle"):
        eos = eos_of(port_single(kind, tcfg, tp, spc, -1).generate(
            ps[0], GenerationConfig(max_new_tokens=new, max_cache_len=256)),
            ps[0], 4 if kind == "token_recycle" else 9)
        want_eng = jax_single(kind, jcfg, jp, spc, eos)
        eng = port_single(kind, tcfg, tp, spc, eos)
        noops = 0
        for p in ps:
            got = eng.generate(p, GenerationConfig(max_new_tokens=new,
                                                   max_cache_len=256))
            same(got, want_eng.generate(p, JaxGen(max_new_tokens=new,
                                                  max_cache_len=256)))
            st_ = eng.loop_stats
            assert st_.steps - st_.noop_steps == got.decode_steps
            noops += st_.noop_steps
        assert noops > 0        # the EOS fell inside a segment
        if kind == "token_recycle":
            np.testing.assert_array_equal(eng.harvests[0].numpy(),
                                          np.asarray(want_eng.harvest))
        return
    first = port_single("fused_sam", tcfg, tp, spc, -1).generate(
        ps[0], GenerationConfig(max_new_tokens=new, max_cache_len=256))
    eos = eos_of(first, ps[0], 9)
    kw = dict(batch_size=2, eos_token_id=eos, **KW)
    fsc = dict(n_predicts=7, steps_per_call=spc, corpus_capacity=256)
    if kind == "batched":
        want = serve_batch(JaxBatched(jcfg, jp, JaxFsc(**fsc), **kw), ps,
                           new, JaxGen)
        eng = BatchedFusedSamEngine(tcfg, tp, FusedSamConfig(**fsc),
                                    device="cpu", **kw)
    else:
        pk = dict(n_pages=32, page_size=PAGE)
        want = serve_batch(JaxPaged(jcfg, jp, JaxFsc(**fsc), interpret=True,
                                    **kw, **pk), ps, new, JaxGen)
        eng = PagedBatchedFusedSamEngine(tcfg, tp, FusedSamConfig(**fsc),
                                         device="cpu", **kw, **pk)
    got = serve_batch(eng, ps, new, GenerationConfig)
    for g, w in zip(got, want):
        same(g, w)
    assert got[0].output_ids[-1] == eos


# ---------------------------------------------------------------------------
# The holder's launch arithmetic
# ---------------------------------------------------------------------------

class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` that records replays."""

    def __init__(self):
        self.replayed = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replayed += 1


class _Capture:
    def __init__(self, graph, pool=None, stream=None,
                 capture_error_mode="global"):
        self.graph = graph

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_holder_launch_arithmetic(monkeypatch):
    """A stub step that "launches" 2, 0, 3, 1, 0 kernels of the five
    counters: a new key runs it eagerly once, captures it (its launches
    taken back) and replays the rest; every call of k steps adds k times
    the step's launches, and a CPU holder runs the stub k times."""
    graphs = []

    def new_graph():
        graphs.append(_Graph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: "s")
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    per = (2, 0, 3, 1, 0)
    for (fn, name) in LAUNCH_COUNTERS:
        monkeypatch.setattr(fn, name, 0)
    calls = SimpleNamespace(n=0)

    def stub():
        calls.n += 1
        for (fn, name), d in zip(LAUNCH_COUNTERS, per):
            setattr(fn, name, getattr(fn, name) + d)

    def counts():
        return [getattr(fn, name) for fn, name in LAUNCH_COUNTERS]

    h = StepGraphs(torch.device("cuda"))
    assert h.run("a", stub, 1) == 0           # warm-up only, no capture
    assert calls.n == 1 and not graphs and "a" not in h
    assert h.run("a", stub, 5) == 4           # warm-up again, capture, 4
    assert calls.n == 3 and graphs[0].replayed == 4
    assert counts() == [6 * d for d in per]
    assert h.launches_per_step("a") == list(per)
    gen = object()
    assert h.run("b", stub, 3, generator=gen) == 2
    assert graphs[1].generators == [gen] and graphs[1].replayed == 2
    assert h.run("a", stub, 7) == 7           # captured: replays only
    assert calls.n == 5 and graphs[0].replayed == 11
    assert counts() == [16 * d for d in per]
    assert (h.replays, h.captures) == (13, 2)
    with pytest.raises(ValueError):
        h.run("a", stub, 0)

    cpu = StepGraphs(torch.device("cpu"))
    assert cpu.run("a", stub, 4) == 0
    assert calls.n == 9 and counts() == [20 * d for d in per]
    assert device_loop.LoopStats().noop_steps == 0
