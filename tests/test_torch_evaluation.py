"""samd_tpu_torch.evaluation against samd_tpu.evaluation: the runner's
answer files (the same schema, read by ``speed`` and ``equal`` of either
package), the same answers as JAX's runner on bridged weights, multi-turn
context, reorg, the text codecs on one tokenizer, a local HF checkpoint
through the whole pipeline, the Spec-Bench demo at the JAX test's size,
and the profiler.  Mirrors ``tests/test_evaluation.py``,
``tests/test_real_checkpoint_pipeline.py`` and
``tests/test_specbench_demo.py``."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.evaluation import codecs as jax_codecs
from samd_tpu.evaluation import equal as jax_equal
from samd_tpu.evaluation import run_eval as jax_run_eval
from samd_tpu.evaluation import speed as jax_speed
from samd_tpu.evaluation import synthetic as jax_synthetic
from samd_tpu.models import init_params, tiny_config
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.engine import ArBaseline, SamdEngine
from samd_tpu_torch.evaluation import (codecs, compare, load_questions,
                                       make_questions, mean_accepted_tokens,
                                       reorg_answer_file, run_eval, speed,
                                       speedup, tokens_per_second,
                                       write_questions)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

KW = dict(max_cache_len=512, eos_token_id=-1, prefill_buckets=(256, 512),
          device="cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    cfg = port_config(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    gen = GenerationConfig(max_new_tokens=24, max_cache_len=512)
    questions = make_questions(cfg.vocab_size, per_task=1, seed=1,
                               tasks=["summarization", "qa", "mt_bench"])
    return jcfg, jp, cfg, params, gen, questions, tmp_path_factory.mktemp(
        "eval")


def test_questions_equal_jax_and_roundtrip(setup, tmp_path):
    *_, questions, _ = setup
    want = jax_synthetic.make_questions(128, per_task=1, seed=1,
                                        tasks=["summarization", "qa",
                                               "mt_bench"])
    assert [(q.question_id, q.category, q.turns) for q in questions] == \
        [(q.question_id, q.category, q.turns) for q in want]
    corpus = np.arange(3, 400) % 128
    assert [q.turns for q in make_questions(128, corpus=corpus, seed=4)] \
        == [q.turns for q in jax_synthetic.make_questions(
            128, corpus=corpus, seed=4)]
    path = tmp_path / "q.jsonl"
    write_questions(questions, str(path))
    loaded = load_questions(str(path))
    assert [q.question_id for q in loaded] == [q.question_id
                                               for q in questions]
    assert loaded[0].turns == questions[0].turns
    # the reference's writer and the port's write the same file
    jax_synthetic.write_questions(want, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "j.jsonl").read_text() == path.read_text()


def test_run_eval_and_analysis(setup):
    _, _, cfg, params, gen, questions, tmp = setup
    base_path = str(tmp / "baseline.jsonl")
    stats_b = run_eval(ArBaseline(cfg, params, **KW), questions, base_path,
                       gen_config=gen, warmup=1)
    assert stats_b["total_tokens"] > 0
    samd_cfg = SamdConfig(draft_source="sam_only", max_predicts=8, len_bias=0)
    engine = SamdEngine(cfg, params, samd_cfg,
                        make_drafter(samd_cfg, cfg.vocab_size), **KW)
    ans_path = str(tmp / "samd.jsonl")
    stats_s = run_eval(engine, questions, ans_path, gen_config=gen, warmup=1)
    assert stats_s["mean_accepted_tokens"] >= 1.0

    tps = tokens_per_second(ans_path)
    assert "overall" in tps and "summarization" in tps
    assert all(v > 0 for v in speedup(ans_path, base_path).values())
    assert mean_accepted_tokens(ans_path) == pytest.approx(
        stats_s["mean_accepted_tokens"])
    equal, mismatches = compare(ans_path, base_path)
    assert equal, f"mismatched questions: {mismatches}"
    with open(ans_path) as f:
        row = json.loads(f.readline())
    assert set(row) == {"question_id", "category", "model_id", "choices",
                        "tstamp"}
    assert set(row["choices"][0]) == {"turns", "idxs", "new_tokens",
                                      "wall_time", "accept_lengths"}


def test_answer_files_cross_packages(setup):
    """JAX's runner over JAX's oracle and the port's over the port's, on
    the same weights: the same rows (timings aside), and each package's
    speed and equal read the other's file."""
    jcfg, jp, cfg, params, gen, questions, tmp = setup
    jq = jax_synthetic.make_questions(128, per_task=1, seed=1,
                                      tasks=["summarization", "qa",
                                             "mt_bench"])
    jax_path, port_path = str(tmp / "jax.jsonl"), str(tmp / "port.jsonl")
    jax_run_eval(JaxAr(jcfg, jp, max_cache_len=512, eos_token_id=-1,
                       prefill_buckets=(256, 512), block_size=8),
                 jq, jax_path, gen_config=JaxGen(max_new_tokens=24,
                                                 max_cache_len=512),
                 warmup=0)
    run_eval(ArBaseline(cfg, params, block_size=8, **KW), questions,
             port_path, gen_config=gen, warmup=0)
    rows = [[json.loads(ln) for ln in open(p)] for p in (jax_path, port_path)]
    for a, b in zip(*rows):
        assert set(a) == set(b)
        ca, cb = a["choices"][0], b["choices"][0]
        for key in ("turns", "idxs", "new_tokens", "accept_lengths"):
            assert ca[key] == cb[key], key
    assert jax_equal.compare(port_path, jax_path) == (True, [])
    assert compare(jax_path, port_path) == (True, [])
    for p in (jax_path, port_path):
        assert set(jax_speed.tokens_per_second(p)) == \
            set(speed.tokens_per_second(p))
        assert jax_speed.mean_accepted_tokens(p) == \
            mean_accepted_tokens(p) == 1.0
    assert set(speedup(jax_path, port_path)) == \
        set(jax_speed.speedup(port_path, jax_path))


def test_multi_turn_context_carries(setup):
    _, _, cfg, params, gen, _, tmp = setup
    questions = make_questions(cfg.vocab_size, per_task=1, seed=3,
                               tasks=["mt_bench"])
    assert len(questions[0].turns) == 2
    path = str(tmp / "mt.jsonl")
    run_eval(ArBaseline(cfg, params, **KW), questions, path,
             gen_config=gen, warmup=0)
    with open(path) as f:
        row = json.loads(f.readline())
    assert len(row["choices"][0]["turns"]) == 2


def test_failed_question_recorded(setup):
    """A question the engine cannot serve records ERROR; the run goes
    on."""
    from samd_tpu_torch.evaluation import Question

    _, _, cfg, params, gen, _, tmp = setup
    qs = [Question(0, "qa", [[5] * 600]), Question(1, "qa", [[5, 6, 7]])]
    path = str(tmp / "err.jsonl")
    stats = run_eval(ArBaseline(cfg, params, **KW), qs, path,
                     gen_config=gen, warmup=0)
    rows = [json.loads(ln) for ln in open(path)]
    assert stats["errors"] == 1 and rows[0]["choices"][0]["turns"] == \
        ["ERROR"] and rows[1]["choices"][0]["new_tokens"] == [24]


def test_reorg_answer_file(tmp_path):
    path = tmp_path / "a.jsonl"
    rows = [{"question_id": 2, "v": "old"}, {"question_id": 1, "v": "x"},
            {"question_id": 2, "v": "new"}]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    reorg_answer_file(str(path))
    got = [json.loads(ln) for ln in open(path)]
    assert [g["question_id"] for g in got] == [1, 2]
    assert got[1]["v"] == "new"


# ---------------------------------------------------------------------------
# codecs and a local checkpoint through the pipeline
# ---------------------------------------------------------------------------

VOCAB = 256


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny on-disk HF Llama checkpoint and a word-level tokenizer, as
    ``tests/test_real_checkpoint_pipeline.py`` builds them."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaForCausalLM

    d = tmp_path_factory.mktemp("hf_ckpt")
    torch.manual_seed(7)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-6,
        tie_word_embeddings=False)).save_pretrained(str(d))
    words = {f"w{i}": i for i in range(VOCAB - 8)}
    vocab = {"<unk>": VOCAB - 8, "<s>": VOCAB - 7, "</s>": VOCAB - 6,
             "USER:": VOCAB - 5, "ASSISTANT:": VOCAB - 4, "A": VOCAB - 3,
             "user": VOCAB - 2, "assistant": VOCAB - 1, **words}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(d / "tokenizer.json"))
    return str(d)


@pytest.fixture(scope="module")
def tokenizer(hf_dir):
    from transformers import PreTrainedTokenizerFast

    tk = PreTrainedTokenizerFast(
        tokenizer_file=hf_dir + "/tokenizer.json",
        unk_token="<unk>", bos_token="<s>", eos_token="</s>")
    tk.chat_template = (
        "{% for m in messages %}<s> {{ m['role'] }} {{ m['content'] }} "
        "{% endfor %}{% if add_generation_prompt %}<s> assistant{% endif %}")
    return tk


@pytest.mark.parametrize("name", ["TokenizerCodec", "VicunaCodec",
                                  "ChatTemplateCodec"])
def test_codecs_equal_jax(tokenizer, name):
    port = getattr(codecs, name)(tokenizer)
    ref = getattr(jax_codecs, name)(tokenizer)
    turns, answers = ["w1 w2 w3", "w4 w5"], ["w9 w8"]
    assert port.encode("w7 w6") == ref.encode("w7 w6")
    assert port.encode_conversation(turns, answers) == \
        ref.encode_conversation(turns, answers)
    ids = port.encode("w10 w11 w12")
    assert port.decode(ids) == ref.decode(ids)


def test_checkpoint_pipeline(hf_dir, tokenizer, tmp_path):
    """loader → host engine and its block oracle → run_eval with the
    Vicuna codec → speed and equal; greedy output equal across it all,
    and a question past the largest prefill bucket recorded as ERROR."""
    from samd_tpu_torch.evaluation import Question
    from samd_tpu_torch.models.loader import load_llama

    cfg, params = load_llama(hf_dir, dtype=torch.float32, device="cpu")
    M = 16
    kw = dict(max_cache_len=512, eos_token_id=-1, prefill_buckets=(128, 256),
              device="cpu")
    samd_cfg = SamdConfig(draft_source="sam_only", max_predicts=M)
    engine = SamdEngine(cfg, params, samd_cfg,
                        make_drafter(samd_cfg, cfg.vocab_size), **kw)
    oracle = ArBaseline(cfg, params, block_size=M, **kw)
    codec = codecs.VicunaCodec(tokenizer)
    rng = np.random.default_rng(0)
    qs = [Question(qid, "qa", [" ".join(f"w{i}" for i in
                                        rng.integers(0, VOCAB - 6, size=24))
                               for _ in range(2)]) for qid in range(2)]
    qs.append(Question(2, "qa", [" ".join("w1" for _ in range(2000))]))
    gen = GenerationConfig(max_new_tokens=16, max_cache_len=512)
    a, b = str(tmp_path / "samd.jsonl"), str(tmp_path / "oracle.jsonl")
    sa = run_eval(engine, qs, a, gen_config=gen, codec=codec, warmup=1)
    run_eval(oracle, qs, b, gen_config=gen, codec=codec, warmup=0)
    assert sa["errors"] == 1
    assert compare(a, b) == (True, [])
    assert jax_equal.compare(a, b) == (True, [])
    assert speedup(a, b)["overall"] > 0
    row = json.loads(open(a).readline())
    assert all(isinstance(t, str) for t in row["choices"][0]["turns"])


# ---------------------------------------------------------------------------
# the Spec-Bench demo and the profiler
# ---------------------------------------------------------------------------

def test_specbench_pipeline_end_to_end(tmp_path):
    from samd_tpu_torch.evaluation.specbench_demo import run

    out = run(steps=25, vocab=32, per_task=1, new_tokens=16, seed=0,
              out_dir=str(tmp_path), device="cpu")
    for name in ("question", "baseline", "sam_only", "fused_sam"):
        assert os.path.exists(tmp_path / f"{name}.jsonl")
    row = json.loads((tmp_path / "sam_only.jsonl").read_text()
                     .splitlines()[0])
    assert set(row) >= {"question_id", "category", "model_id", "choices"}
    assert out["n_questions"] == 6
    for name in ("sam_only", "fused_sam"):
        r = out["engines"][name]
        assert r["errors"] == 0
        assert r["outputs_equal_vs_block_oracle"], r["mismatch_qids"]
        assert set(r["speedup"]) >= {"rag", "qa", "overall"}
        assert r["mean_accept"] > 0
    assert out["engines"]["sam_only"]["mean_accept"] > 1.5


def test_phase_timer_and_trace(setup, tmp_path):
    from samd_tpu_torch.profiling import PhaseTimer, torch_trace

    _, _, cfg, params, gen, questions, _ = setup
    samd_cfg = SamdConfig(draft_source="sam_only", max_predicts=8)
    engine = SamdEngine(cfg, params, samd_cfg,
                        make_drafter(samd_cfg, cfg.vocab_size), **KW)
    engine.profiler = PhaseTimer()
    with torch_trace(str(tmp_path / "trace")) as prof:
        out = engine.generate(questions[1].turns[0], gen)
    rows = {r["phase"]: r for r in engine.profiler.report(
        normalize_by="device_step")}
    assert set(rows) == {"draft_lookup", "device_step", "host_update"}
    assert all(r["calls"] == out.decode_steps for r in rows.values())
    assert rows["device_step"]["frac"] == 1.0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    t = PhaseTimer()
    assert t.lap("x", time.perf_counter()) >= 0
    t.record("x", 0.5)
    assert t.counts["x"] == 2 and t.totals["x"] >= 0.5
    t.reset()
    assert t.report() == []
