"""The device loop on the card: a step replayed from its CUDA graph
against the same step run eagerly, bit for bit (logits, history, KV and
the control scalars), and every engine's graph route against its
per-step route (tokens, decode steps, kernel launches, drafter state), at
a small size.

Needs a card: every test here carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor samd_tpu, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_loop_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from samd_tpu_torch import fused_sam
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.device_loop import LAUNCH_COUNTERS
from samd_tpu_torch.eagle_fused import FusedEagle2Engine
from samd_tpu_torch.engine import _bucket
from samd_tpu_torch.fused_base import init_history
from samd_tpu_torch.fused_hybrid import (
    BatchedFusedHybridEagleEngine, BatchedFusedHybridEngine,
    FusedHybridConfig, FusedHybridEagleConfig, FusedHybridEagleEngine,
    FusedHybridEngine, PagedBatchedFusedHybridEngine)
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.models import ModelConfig, init_params
from samd_tpu_torch.ops.quant import (init_quantized_llama_params,
                                      int4_from_int8_params)
from samd_tpu_torch.pld import PldConfig, PldEngine
from samd_tpu_torch.token_recycle_fused import (FusedTokenRecycleConfig,
                                                FusedTokenRecycleEngine)

V = 512
KW = dict(max_cache_len=512, prefill_buckets=(64,), eos_token_id=-1)
# the server's hybrid block: M 24, a 23-node tree, chains of 20
HYBRID = dict(tree_nodes=23, n_predicts=20, max_block=24,
              steps_per_call=16, corpus_capacity=4096)
EAGLE = dict(eagle_depth=4, eagle_topk=4, eagle_total=23, n_predicts=20,
             max_block=24, steps_per_call=16, corpus_capacity=4096)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_model(int4: bool):
    """Two layers of 128 wide, heads of 64, bf16; int4 weights with an int8
    KV cache (the 7B path's kernels) or bf16 weights (the 1b path's)."""
    cfg = ModelConfig(vocab_size=V, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=2, num_kv_heads=2, head_dim=64,
                      max_position_embeddings=1024, dtype=torch.bfloat16,
                      kv_quant=int4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if int4:
        return cfg, int4_from_int8_params(init_quantized_llama_params(
            cfg, gen, scale=0.02, dtype=torch.int8, device="cuda"))
    return cfg, init_params(cfg, gen, scale=0.02, device="cuda")


def prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, V, size=int(rng.integers(20, 60))).tolist()
            for _ in range(n)]


def counts():
    return [getattr(fn, name) for fn, name in LAUNCH_COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
def test_replay_equals_eager_step(cuda_device, int4, monkeypatch):
    """From one state, k eager steps and k steps through the graph (the
    warm-up, the capture, k - 1 replays; then k replays) leave the same
    last logits, history, KV cache and control scalars, bit for bit."""
    cfg, params = small_model(int4)
    eng = FusedSamEngine(cfg, params, FusedSamConfig(n_predicts=15),
                         device="cuda", **KW)
    M = eng.cfg.block
    logits_buf = torch.zeros((1, M, V), dtype=torch.float32, device="cuda")
    real_forward = fused_sam.forward

    def keep_logits(*args, **kw):
        logits, hidden = real_forward(*args, **kw)
        logits_buf.copy_(logits)
        return logits, hidden

    p = prompts(1)[0]
    W, P, new, k = eng.S, _bucket(len(p), eng.prefill_buckets), 200, 6
    start, _ = eng._prefill(p, P, W)
    monkeypatch.setattr(fused_sam, "forward", keep_logits)
    eng._history.copy_(init_history(p, eng.S, "cpu"))
    eng._hist_len.fill_(len(p))
    eng._start.copy_(start)
    eng._budget.fill_(new)
    eng._done.fill_(False)

    def state():
        return [t.clone() for t in (logits_buf, eng._history, eng._hist_len,
                                    eng._start, eng._budget, eng._done)] \
            + [c.clone() for c in _kv_tensors(eng)]

    def restore(snap):
        live = [logits_buf, eng._history, eng._hist_len, eng._start,
                eng._budget, eng._done] + _kv_tensors(eng)
        for dst, src in zip(live, snap):
            dst.copy_(src)

    snap = state()
    step = eng._loop_step(W, None, None)
    for _ in range(k):
        step()
    eager = state()
    for route in ("capture", "replay"):
        restore(snap)
        eng.graphs.run((W, None), step, k)
        torch.cuda.synchronize()
        for a, b in zip(eager, state()):
            assert torch.equal(a, b), route
    assert eng.graphs.replays == 2 * k - 1
    assert int(eager[2]) > len(p)


def _kv_tensors(eng):
    out = []
    for kv in (eng.kv_k, eng.kv_v):
        out += [kv.q, kv.scale] if hasattr(kv, "q") else [kv]
    return out


def single_engines(kind, cfg, params, corpus):
    """(graph route, per-step route) engines of one kind."""
    def make():
        if kind == "fused_sam":
            return FusedSamEngine(cfg, params, FusedSamConfig(n_predicts=15),
                                  corpus=corpus, device="cuda", **KW)
        if kind == "pld":
            return PldEngine(cfg, params, PldConfig(), device="cuda", **KW)
        if kind == "hybrid":
            return FusedHybridEngine(cfg, params,
                                     FusedHybridConfig(**HYBRID),
                                     corpus=corpus, device="cuda", **KW)
        if kind == "eagle":
            return FusedEagle2Engine(cfg, params, depth=4, topk=4,
                                     total_tokens=23, device="cuda", **KW)
        if kind == "eagle_hybrid":
            return FusedHybridEagleEngine(cfg, params,
                                          FusedHybridEagleConfig(**EAGLE),
                                          corpus=corpus, device="cuda", **KW)
        return FusedTokenRecycleEngine(cfg, params,
                                       FusedTokenRecycleConfig(num_nodes=25,
                                                               topk=4),
                                       device="cuda", **KW)

    graph, eager = make(), make()
    eager.segmented = False
    return graph, eager


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kind", ["fused_sam", "pld", "token_recycle",
                                  "hybrid", "eagle", "eagle_hybrid"])
def test_single_stream_graph_route_equals_per_step(cuda_device, kind, int4):
    """Each request's tokens, decode steps and kernel launches on the graph
    route equal the per-step route's; the graph route replays, and reads
    the host fewer times than it steps."""
    cfg, params = small_model(int4)
    ps = prompts(3, seed=1)
    gen = GenerationConfig(max_new_tokens=96, max_cache_len=512)
    corpus = [t for p in ps for t in p * 2]
    graph, eager = single_engines(kind, cfg, params, corpus)
    for p in ps:
        c0 = counts()
        want = eager.generate(p, gen)
        c1 = counts()
        got = graph.generate(p, gen)
        c2 = counts()
        assert got == want
        assert [b - a for a, b in zip(c0, c1)] == \
            [b - a for a, b in zip(c1, c2)]
        st = graph.loop_stats
        assert st.replays > 0 and st.noop_steps == 0
        assert st.segments < got.decode_steps
        for name in ("harvests", "seens", "last_hiddens", "ekv_k"):
            if hasattr(graph, name):
                assert torch.equal(getattr(graph, name),
                                   getattr(eager, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rejection", "typical", "nucleus",
                                  "point_mass"])
def test_sampled_graph_route_draws_the_eager_noise(cuda_device, mode):
    """A sampled request on the graph route (its generator registered with
    the graph) draws the eager loop's noise: the same seed gives the
    per-step route's tokens, twice over."""
    cfg, params = small_model(False)
    p = prompts(1, seed=2)[0]
    kw = dict(temperature=1e-5, top_k=1) if mode == "point_mass" else \
        dict(temperature=0.8, top_p=0.9 if mode == "nucleus" else 0.0,
             accept_mode=mode)
    gen = GenerationConfig(max_new_tokens=64, max_cache_len=512, greedy=False,
                           seed=5, **kw)
    graph, eager = single_engines("fused_sam", cfg, params, p * 3)
    want = eager.generate(p, gen)
    assert graph.generate(p, gen) == want
    assert graph.generate(p, gen) == want
    assert graph.loop_stats.replays > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["batched", "paged", "hybrid_batched",
                                  "hybrid_paged", "eagle_batched"])
@pytest.mark.parametrize("inline", [False, True])
def test_batched_graph_route_equals_per_step(cuda_device, kind, inline):
    """Five greedy requests through three slots (refills, then the tail):
    tokens, decode steps and the steps' kernel launches equal the per-step
    route's; the graph route replays and reads each request fewer times
    than it steps."""
    if kind == "eagle_batched" and inline:
        pytest.skip("the SAM[EAGLE-2] engines prefill in one shot")
    paged = kind.endswith("paged")
    cfg, params = small_model(paged)
    if paged:               # int4 weights over int8 pages, as phase 6
        cfg = dataclasses.replace(cfg, kv_quant=False)
    ps = prompts(5, seed=3)
    fc = FusedSamConfig(n_predicts=15, steps_per_call=16)
    kw = dict(batch_size=3, inline_prefill=inline, device="cuda", **KW)
    pages = dict(n_pages=32, page_size=64, quantized_kv=True)
    corpus = [t for p in ps[:2] for t in p * 2]

    def make():
        if kind == "batched":
            return BatchedFusedSamEngine(cfg, params, fc, **kw)
        if kind == "paged":
            return PagedBatchedFusedSamEngine(cfg, params, fc, **pages,
                                              **kw)
        if kind == "hybrid_batched":
            return BatchedFusedHybridEngine(cfg, params,
                                            FusedHybridConfig(**HYBRID),
                                            corpus=corpus, **kw)
        if kind == "hybrid_paged":
            return PagedBatchedFusedHybridEngine(
                cfg, params, FusedHybridConfig(**HYBRID), corpus=corpus,
                **pages, **kw)
        return BatchedFusedHybridEagleEngine(
            cfg, params, FusedHybridEagleConfig(**EAGLE), corpus=corpus,
            **{k: v for k, v in kw.items() if k != "inline_prefill"})

    def serve(eng):
        ids = [eng.add_request(p, GenerationConfig(
            max_new_tokens=40 + 8 * i, max_cache_len=512))
            for i, p in enumerate(ps)]
        out = eng.run()
        return [out[i] for i in ids], [eng.loop_stats[i] for i in ids]

    graph, eager = make(), make()
    eager.segmented = False
    c0 = counts()
    want, _ = serve(eager)
    c1 = counts()
    got, stats = serve(graph)
    c2 = counts()
    assert got == want
    # with no EOS, a slot frees only at a segment's end on either route, so
    # both run the same steps and admit at the same ones
    assert graph.steps_run == eager.steps_run
    assert [b - a for a, b in zip(c1, c2)] == [b - a for a, b in zip(c0, c1)]
    assert graph.graphs.replays > 0
    # the harvest tables but their sink rows: a stopped slot steps with the
    # batch and writes its sink row from pages its request may have freed
    # at another step on the other route
    for name in ("harvests", "seens", "last_hiddens"):
        if hasattr(graph, name):
            assert torch.equal(getattr(graph, name)[:, :-1],
                               getattr(eager, name)[:, :-1]), name
    for o, st in zip(got, stats):
        assert st.steps - st.noop_steps >= o.decode_steps
        if o.decode_steps > 1:
            assert st.segments < o.decode_steps
