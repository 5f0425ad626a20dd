"""samd_tpu_torch's serving front end (``samd_tpu_torch/server.py``) on the
CPU, mirroring ``tests/test_server.py``: concurrent submissions equal the
single-stream engine's outputs and JAX's on shared weights; a late
submission joins the running batch; ``/generate``, ``/health``, SSE
streaming and the 400 replies over real HTTP on port 0 (malformed bodies
never reach the engine, and the next request is served); sampled requests
are deterministic per seed, point-mass ones equal the greedy output, and a
conflicting signature is rejected; a failed batch reaches every waiter;
``build_server_engine`` builds the ported engines (the host-automaton
``--engine batched`` and a static corpus SAM from ``--sam`` among them,
served over HTTP equal to the engine called directly) and names the
ROADMAP item of the others."""

import argparse
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.models import init_params, tiny_config
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.fused_sam import (BatchedFusedSamEngine, FusedSamConfig,
                                      FusedSamEngine,
                                      PagedBatchedFusedSamEngine)
from samd_tpu_torch.server import (Scheduler, _gen_from_json,
                                   build_server_engine, serve)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config
from torch_mixtral_dir import write_mixtral

FSC = dict(n_predicts=15, steps_per_call=6, corpus_capacity=256)
KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
GEN = GenerationConfig(max_new_tokens=16, max_cache_len=256)


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def expected(tiny_model):
    """Five prompts and the port's single-stream outputs, which equal
    JAX's single-stream engine's on the same weights."""
    jcfg, jp, tcfg, tp = tiny_model
    prompts = [np.random.default_rng(11).integers(
        3, 128, size=int(n)).tolist() for n in (12, 17, 9, 22, 14)]
    single = FusedSamEngine(tcfg, tp, FusedSamConfig(**FSC), device="cpu",
                            **KW)
    outs = [single.generate(p, GEN).output_ids for p in prompts]
    jax_single = JaxFused(jcfg, jp, JaxFsc(**FSC), **KW)
    assert outs == [jax_single.generate(p, JaxGen(
        max_new_tokens=16, max_cache_len=256)).output_ids for p in prompts]
    return prompts, outs


def engine(tiny_model, paged=False):
    _, _, tcfg, tp = tiny_model
    if paged:
        return PagedBatchedFusedSamEngine(
            tcfg, tp, FusedSamConfig(**FSC), batch_size=2, n_pages=40,
            page_size=16, device="cpu", **KW)
    return BatchedFusedSamEngine(tcfg, tp, FusedSamConfig(**FSC),
                                 batch_size=2, device="cpu", **KW)


def post(url, body, timeout=120):
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_concurrent_submissions_match_single(tiny_model, expected,
                                                       paged):
    prompts, exp = expected
    sched = Scheduler(engine(tiny_model, paged))
    try:
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = sched.generate(prompts[i], GEN, timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, out in enumerate(outs):
            assert out is not None and not isinstance(out, Exception)
            assert out.output_ids == exp[i], f"prompt {i}"
        stats = sched.stats()
        assert stats["submitted"] == len(prompts) and stats["queued"] == 0
    finally:
        sched.close()


def test_scheduler_late_submission_joins_running_batch(tiny_model, expected):
    prompts, exp = expected
    sched = Scheduler(engine(tiny_model))
    try:
        first = sched.submit(prompts[0], GEN)
        second = sched.submit(prompts[1], GEN)     # while the batch runs
        assert sched.result(first, timeout=120).output_ids == exp[0]
        assert sched.result(second, timeout=120).output_ids == exp[1]
    finally:
        sched.close()


def test_http_generate_health_and_errors(tiny_model, expected):
    prompts, exp = expected
    server, sched = serve(engine(tiny_model), port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        out = post(url, {"input_ids": prompts[0], "max_new_tokens": 16,
                         "max_cache_len": 256})
        assert out["output_ids"] == exp[0]
        assert out["new_tokens"] == len(exp[0]) - len(prompts[0])
        assert out["decode_steps"] >= 1
        with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["submitted"] >= 1
        for bad in ({}, {"input_ids": []}, {"input_ids": [1, "x"]},
                    {"input_ids": [5, 6], "temperature": 0.5,
                     "accept_mode": "nucleus"}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                post(url, bad, timeout=30)
            assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/generate", data=b"{not json"), timeout=30)
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/nowhere", timeout=30)
        assert exc.value.code == 404
        with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.shutdown()
        sched.close()


def test_sampled_requests_over_http(tiny_model, expected):
    """Sampled requests under one signature beside a greedy one: the same
    seed gives the same tokens, another seed others, the greedy reply
    stays the single-stream output; a request of another signature sent
    while they run gets 400."""
    prompts, exp = expected
    server, sched = serve(engine(tiny_model), port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    body = {"input_ids": prompts[1], "max_new_tokens": 16,
            "max_cache_len": 256, "temperature": 0.8, "seed": 4}
    try:
        replies = {}

        def client(name, b):
            replies[name] = post(url, b)

        threads = [threading.Thread(target=client, args=a) for a in (
            ("a", body), ("b", body), ("c", {**body, "seed": 5}),
            ("g", {"input_ids": prompts[0], "max_new_tokens": 16,
                   "max_cache_len": 256}))]
        for t in threads:
            t.start()
        sched.submit(prompts[2], GenerationConfig(
            max_new_tokens=64, max_cache_len=256, greedy=False,
            temperature=0.8, seed=1))
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(url, {**body, "temperature": 0.5}, timeout=30)
        assert exc.value.code == 400
        assert "signature" in json.loads(exc.value.read())["error"]
        for t in threads:
            t.join(timeout=120)
        assert replies["a"]["output_ids"] == replies["b"]["output_ids"]
        assert replies["c"]["output_ids"] != replies["a"]["output_ids"]
        assert replies["g"]["output_ids"] == exp[0]
        assert all(0 <= t < 128 for t in replies["a"]["output_ids"])
    finally:
        server.shutdown()
        sched.close()


def test_point_mass_sampled_requests_over_http(tiny_model, expected):
    """Sampled requests whose every draw is forced (top_k = 1, and a
    temperature so low that the first token, drawn without top-k as in
    the reference, is the argmax) have an independent answer: the greedy
    output, here the single-stream engine's, which equals JAX's."""
    prompts, exp = expected
    server, sched = serve(engine(tiny_model, paged=True), port=0,
                          block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        replies = [None] * 4

        def client(i):
            body = {"input_ids": prompts[i], "max_new_tokens": 16,
                    "max_cache_len": 256}
            if i != 2:
                body.update(temperature=1e-5, top_k=1, seed=30 + i)
            replies[i] = post(url, body)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [r["output_ids"] for r in replies] == exp[:4]
    finally:
        server.shutdown()
        sched.close()


def bad_bodies(prompt):
    """Bodies that must get 400 before they reach the driver thread."""
    ok = {"input_ids": prompt, "max_new_tokens": 16, "max_cache_len": 256}
    return [
        {**ok, "input_ids": prompt + [128]},      # past the vocabulary
        {**ok, "input_ids": [-1] + prompt},
        {**ok, "input_ids": [True, 5]},
        {**ok, "input_ids": list(range(3, 36))},  # past the bucket of 32
        {**ok, "max_new_tokens": "16"},
        {**ok, "max_new_tokens": 0},
        {**ok, "temperature": "hot"},
        {**ok, "temperature": 0.8, "top_k": 129},  # past the vocabulary
        {**ok, "temperature": 0.8, "top_p": 2.0},
        {**ok, "temperature": 0.8, "accept_mode": "greedy"},
        {**ok, "seed": -1},
        {**ok, "timeout_s": "soon"},
        {**ok, "stream": True, "input_ids": prompt + [1000]},
    ]


@pytest.mark.parametrize("paged", [False, True])
def test_http_rejects_what_the_engine_cannot_serve(tiny_model, expected,
                                                   paged):
    """Each malformed body gets 400 and never reaches the engine; the
    next valid request still returns the single-stream output."""
    prompts, exp = expected
    server, sched = serve(engine(tiny_model, paged), port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for bad in bad_bodies(prompts[0]):
            with pytest.raises(urllib.error.HTTPError) as exc:
                post(url, bad, timeout=30)
            assert exc.value.code == 400, bad
            assert json.loads(exc.value.read())["error"]
            assert post(url, {"input_ids": prompts[0], "max_new_tokens": 16,
                              "max_cache_len": 256})["output_ids"] == exp[0]
        stats = sched.stats()
        assert stats["submitted"] == len(bad_bodies(prompts[0]))
        assert stats["queued"] == 0
    finally:
        server.shutdown()
        sched.close()


def test_rejected_request_leaves_no_state(tiny_model, expected):
    """A rejected sampled request claims no signature and leaves no
    listener; a pool too small for a prompt's bucket is refused up front
    instead of stalling the driver."""
    prompts, exp = expected
    sched = Scheduler(engine(tiny_model))
    try:
        g1 = GenerationConfig(max_new_tokens=8, max_cache_len=256,
                              greedy=False, temperature=0.8, seed=1)
        with pytest.raises(ValueError, match="outside"):
            sched.submit([5, 128], g1)
        with pytest.raises(ValueError, match="outside"):
            sched.submit_stream([5, 128], g1)
        assert not sched.engine.progress_listeners
        g2 = GenerationConfig(max_new_tokens=8, max_cache_len=256,
                              greedy=False, temperature=0.5, seed=2)
        out = sched.generate([5, 6, 7, 8], g2, timeout=120)
        assert not isinstance(out, Exception) and out.decode_tokens == 8
        assert sched.generate(prompts[1], GEN,
                              timeout=120).output_ids == exp[1]
    finally:
        sched.close()
    _, _, tcfg, tp = tiny_model
    small = PagedBatchedFusedSamEngine(
        tcfg, tp, FusedSamConfig(**FSC), batch_size=2, n_pages=1,
        page_size=16, device="cpu", **KW)
    with pytest.raises(ValueError, match="pages"):
        small.add_request(prompts[0], GEN)
    assert not small.queue


def test_sampling_signature_conflict_rejected(tiny_model):
    sched = Scheduler(engine(tiny_model))
    try:
        g1 = GenerationConfig(max_new_tokens=8, max_cache_len=256,
                              greedy=False, temperature=0.8, seed=1)
        g2 = GenerationConfig(max_new_tokens=8, max_cache_len=256,
                              greedy=False, temperature=0.5, seed=2)
        rid = sched.submit([5, 6, 7, 8], g1)
        with pytest.raises(ValueError, match="sampling signature"):
            sched.submit([5, 6, 7, 8], g2)
        with pytest.raises(ValueError, match="sampling signature"):
            sched.submit_stream([5, 6, 7, 8], g2)
        out = sched.result(rid, timeout=120)
        assert not isinstance(out, Exception)
    finally:
        sched.close()


def test_failed_batch_reaches_every_waiter(tiny_model, expected):
    """An engine failure is not swallowed: each waiting request gets the
    exception (500 over HTTP), and the scheduler serves again after it."""
    prompts, exp = expected
    eng = engine(tiny_model)
    real = eng._segment
    calls = []

    def broken(*a, **k):
        if not calls:
            calls.append(1)
            raise RuntimeError("device lost")
        return real(*a, **k)

    eng._segment = broken
    server, sched = serve(eng, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(url, {"input_ids": prompts[0], "max_new_tokens": 16,
                       "max_cache_len": 256})
        assert exc.value.code == 500
        assert "device lost" in json.loads(exc.value.read())["error"]
        assert post(url, {"input_ids": prompts[0], "max_new_tokens": 16,
                          "max_cache_len": 256})["output_ids"] == exp[0]
    finally:
        server.shutdown()
        sched.close()


def test_sse_streaming_matches_blocking(tiny_model, expected):
    """POST /generate {"stream": true}: the chunks concatenate to the
    blocking reply's generated tokens, then a done event with the
    summary."""
    prompts, exp = expected
    server, sched = serve(engine(tiny_model, paged=True), port=0,
                          block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = json.dumps({"input_ids": prompts[0], "stream": True,
                           "max_new_tokens": 16,
                           "max_cache_len": 256}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/generate", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=120) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            events = [json.loads(raw.decode().strip()[len("data: "):])
                      for raw in r if raw.decode().startswith("data: ")]
        assert events and events[-1].get("done") is True
        streamed = [t for e in events[:-1] for t in e["tokens"]]
        assert events[-1]["output_ids"] == exp[0]
        assert streamed == exp[0][len(prompts[0]):]
        assert events[-1]["new_tokens"] == len(streamed)
    finally:
        server.shutdown()
        sched.close()


def test_scheduler_submit_stream_chunks(tiny_model, expected):
    prompts, exp = expected
    sched = Scheduler(engine(tiny_model))
    try:
        rid, events = sched.submit_stream(prompts[2], GEN)
        other = sched.submit(prompts[3], GEN)
        chunks = []
        while True:
            kind, payload = events.get(timeout=120)
            if kind == "done":
                out = payload
                break
            assert kind == "tokens"
            chunks.append(payload)
        assert out.output_ids == exp[2]
        assert [t for c in chunks for t in c] == exp[2][len(prompts[2]):]
        assert sched.result(other, timeout=120).output_ids == exp[3]
        assert rid not in sched.engine.progress_listeners
    finally:
        sched.close()


def test_gen_from_json():
    g = _gen_from_json({"max_new_tokens": 7, "seed": 3})
    assert g.greedy and g.max_new_tokens == 7
    s = _gen_from_json({"temperature": 0.7, "top_k": 5,
                        "accept_mode": "typical"})
    assert not s.greedy and s.sampling_signature == (
        0.7, 0.0, 5, "typical", 0.3, 0.09)


def args_for(**kw):
    base = dict(model=None, random_model=True, tiny=True,
                engine="fused_sam_batched", batch_size=2, quantize=None,
                max_cache_len=256, sam=None, cpu=True)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("name,quant", [
    ("fused_sam_batched", None), ("paged_fused_sam", None),
    ("fused_sam_batched", "int8"), ("fused_sam_batched", "fp8"),
    ("paged_fused_sam", "int4"), ("fused_hybrid_batched", None),
    ("paged_fused_hybrid", "int4"), ("eagle2_hybrid_batched", "int8")])
def test_build_server_engine_ported(name, quant):
    from samd_tpu_torch.fused_hybrid import (BatchedFusedHybridEagleEngine,
                                             BatchedFusedHybridEngine,
                                             PagedBatchedFusedHybridEngine)

    eng = build_server_engine(args_for(engine=name, quantize=quant))
    want = {"fused_sam_batched": BatchedFusedSamEngine,
            "paged_fused_sam": PagedBatchedFusedSamEngine,
            "fused_hybrid_batched": BatchedFusedHybridEngine,
            "paged_fused_hybrid": PagedBatchedFusedHybridEngine,
            "eagle2_hybrid_batched": BatchedFusedHybridEagleEngine}[name]
    assert type(eng) is want and eng.device.type == "cpu"
    rid = eng.add_request([5, 6, 7, 8], GenerationConfig(
        max_new_tokens=4, max_cache_len=256))
    assert eng.run()[rid].decode_tokens == 4


@pytest.mark.parametrize("kw,experts", [
    (dict(random_model=False, model="mixtral"), 4)])
def test_build_server_engine_not_ported(kw, experts, tmp_path):
    """``--model`` loads a local HF directory; a Mixtral one, which the
    port refused before its MoE MLP was ported, now builds and serves."""
    d = write_mixtral(tmp_path / kw["model"])
    eng = build_server_engine(args_for(**{**kw, "model": d}))
    assert eng.model_cfg.num_experts == experts
    assert eng.params["layers"]["w_gate"].shape[:2] == (2, experts)
    rid = eng.add_request([5, 6, 7, 8], GenerationConfig(
        max_new_tokens=4, max_cache_len=256))
    assert eng.run()[rid].decode_tokens == 4


SAM_PROMPTS = [[5, 6, 7, 8, 9], list(range(20, 34)), [9, 10, 11],
               list(range(100, 120))]


@pytest.fixture(scope="module")
def sam_file(tmp_path_factory):
    """The host-automaton server engine's greedy outputs for SAM_PROMPTS
    without a corpus, and a static corpus SAM of those outputs saved in
    the shared format."""
    from samd_tpu_torch.sam import build_corpus_sam, save_sam

    eng = build_server_engine(args_for(engine="batched"))
    gen = GenerationConfig(max_new_tokens=12, max_cache_len=256)
    rids = [eng.add_request(p, gen) for p in SAM_PROMPTS]
    res = eng.run()
    outs = [res[r].output_ids for r in rids]
    path = tmp_path_factory.mktemp("sam") / "corpus.npz"
    save_sam(build_corpus_sam(outs, eos_token=0, topk=8), path)
    return path, outs


def test_batched_host_engine_with_sam_over_http(sam_file):
    """``--engine batched --sam FILE``: the host-automaton engine with the
    static SAM behind one cursor per request drafts from the corpus and
    still gives the greedy outputs; four greedy requests over HTTP each
    equal the same engine called directly."""
    from samd_tpu_torch.batching import BatchedSamdEngine

    path, greedy = sam_file
    args = args_for(engine="batched", sam=str(path))
    direct = build_server_engine(args)
    assert type(direct) is BatchedSamdEngine
    assert direct.device.type == "cpu"
    gen = GenerationConfig(max_new_tokens=12, max_cache_len=256)
    rids = [direct.add_request(p, gen) for p in SAM_PROMPTS]
    res = direct.run()
    want = [res[r].output_ids for r in rids]
    assert want == greedy
    assert direct.stats.source_counts.get("sam_static", 0) > 0
    server, sched = serve(build_server_engine(args), port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        outs = [None] * len(SAM_PROMPTS)

        def client(i):
            outs[i] = post(url, {"input_ids": SAM_PROMPTS[i],
                                 "max_new_tokens": 12})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(SAM_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [o["output_ids"] for o in outs] == want
    finally:
        server.shutdown()
        sched.close()


def test_sam_file_is_the_fused_corpus(sam_file):
    from samd_tpu_torch.sam import load_sam

    path, _ = sam_file
    text = load_sam(path).text
    eng = build_server_engine(args_for(engine="fused_sam_batched",
                                       sam=str(path)))
    assert int(eng.corpus_len) == len(text)
    assert eng.corpus[:len(text)].tolist() == text


@pytest.mark.parametrize("name", ["fused_hybrid_batched",
                                  "paged_fused_hybrid",
                                  "eagle2_hybrid_batched"])
def test_hybrid_engines_over_http(name):
    """``--engine fused_hybrid_batched`` / ``paged_fused_hybrid`` /
    ``eagle2_hybrid_batched`` on the CPU (``--tiny --cpu``): greedy replies
    over HTTP from concurrent clients each equal the same engine called
    directly (the harvest tables persist across requests, so each side
    starts from a fresh engine and sends the prompts in one batch)."""
    args = args_for(engine=name, batch_size=4)
    direct = build_server_engine(args)
    gen = GenerationConfig(max_new_tokens=12, max_cache_len=256)
    rids = [direct.add_request(p, gen) for p in SAM_PROMPTS]
    res = direct.run()
    want = [res[r].output_ids for r in rids]
    server, sched = serve(build_server_engine(args), port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        outs = [None] * len(SAM_PROMPTS)

        def client(i):
            outs[i] = post(url, {"input_ids": SAM_PROMPTS[i],
                                 "max_new_tokens": 12})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(SAM_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [o["output_ids"] for o in outs] == want
    finally:
        server.shutdown()
        sched.close()
