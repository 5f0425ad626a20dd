"""samd_tpu_torch's corpus tooling against samd_tpu's: retrieval parity
(``evaluation.parity``: the exact automaton against the windowed scan and
the n-gram index, each report equal to JAX's on the same corpus and
trajectory), the corpus pipeline (``tools.gen_corpus`` → ``tools.build_sam``,
whose ``.npz`` equals the reference tool's byte for byte on the same rows)
and the multi-process evaluation fan-out (``evaluation.launch`` with
``--cpu``: two workers' merged answers sorted, deduplicated and equal to
the engine called in process).  Mirrors ``tests/test_parity.py``,
``test_gen_corpus.py`` and ``test_launch.py``."""

import argparse
import builtins
import json
import subprocess
import sys

import numpy as np
import pytest

from samd_tpu.evaluation.parity import parity_report as jax_parity
from samd_tpu.ops.ngram_index import build_ngram_index as jax_index
from samd_tpu.parallel.multihost import shard_requests as jax_shard
from samd_tpu.tools.build_sam import build as jax_build_sam
from samd_tpu.tools.gen_corpus import template_prompt as jax_template
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.evaluation import launch
from samd_tpu_torch.evaluation.parity import parity_report
from samd_tpu_torch.ops.ngram_index import build_ngram_index
from samd_tpu_torch.tools import build_sam, gen_corpus
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def make_workload(seed=0, corpus_size=4000, steps=150, vocab=64):
    """``tests/test_parity.py``'s workload: repeated documents and a
    trajectory of corpus slices and noise."""
    rng = np.random.default_rng(seed)
    chunks = []
    while sum(len(c) for c in chunks) < corpus_size:
        doc = rng.integers(0, vocab, size=100).tolist()
        chunks.append(doc * int(rng.integers(1, 4)))
    corpus = [t for c in chunks for t in c][:corpus_size]
    traj = []
    while len(traj) < steps:
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(corpus) - 60))
            traj += corpus[s:s + 30]
        else:
            traj += rng.integers(0, vocab, size=15).tolist()
    return corpus, traj[:steps]


def both_reports(corpus, traj, **index_kw):
    """The port's report and JAX's on the same inputs (with an index of
    ``index_kw`` on both sides when given); they must be equal."""
    t_idx = j_idx = None
    if index_kw:
        t_idx = build_ngram_index(corpus, device="cpu", **index_kw)
        j_idx = jax_index(corpus, **index_kw)
    got = parity_report(corpus, traj, index=t_idx, device="cpu")
    assert got == jax_parity(corpus, traj, index=j_idx)
    return got


def test_windowed_matches_exact_automaton():
    rep = both_reports(*make_workload())
    assert rep["match_agreement"] == 1.0
    assert rep["match_and_end_agreement"] == 1.0
    assert rep["mean_draft_len_delta"] == 0.0


def test_indexed_matches_exact_automaton():
    rep = both_reports(*make_workload(seed=1), bucket_cap=32)
    assert rep["match_agreement"] == 1.0
    assert rep["match_and_end_agreement"] == 1.0


def test_indexed_small_bucket_degrades_gracefully():
    """Tiny buckets on a repetitive corpus: shorter matches, never longer
    or false ones."""
    rep = both_reports(*make_workload(seed=2, vocab=8), bucket_cap=1)
    assert rep["mean_match_delta_capped"] >= 0.0
    assert rep["match_agreement"] >= 0.5


def test_dense_grams_restore_adversarial_agreement():
    """Every gram size up to max_ngram serves each short match from its own
    bucket: agreement near 1 even at bucket_cap 8."""
    corpus, traj = make_workload(seed=2, vocab=8)
    rep_s = both_reports(corpus, traj, bucket_cap=8, grams=(8, 4, 2, 1))
    rep_d = both_reports(corpus, traj, bucket_cap=8,
                         grams=(32, 16, 8, 7, 6, 5, 4, 3, 2, 1))
    assert rep_d["match_agreement"] >= 0.95
    assert rep_d["match_agreement"] >= rep_s["match_agreement"]
    assert rep_d["mean_draft_len_delta"] <= 0.05


def test_dual_probe_tables():
    """keep_latest tables: exact-or-shorter, at least as good as the
    earliest-only probe."""
    corpus, traj = make_workload(seed=3, vocab=8)
    rep_b = both_reports(corpus, traj, bucket_cap=4, grams=(8, 4, 2, 1))
    rep_d = both_reports(corpus, traj, bucket_cap=4, grams=(8, 4, 2, 1),
                         keep_latest=4)
    assert rep_d["match_agreement"] >= rep_b["match_agreement"]
    assert rep_d["mean_match_delta_capped"] >= 0.0


# ----------------------------------------------------------------------
# The corpus pipeline
# ----------------------------------------------------------------------

def npz_bytes(path):
    with np.load(path) as d:
        return {k: (d[k].dtype.str, d[k].shape, d[k].tobytes()) for k in d}


def test_tokens_pipeline_end_to_end(tmp_path, monkeypatch):
    """gen_corpus on token rows appends this model's responses (equal to
    the same engine called in process); build_sam of its output writes the
    reference tool's arrays byte for byte, and the reference loads it."""
    from samd_tpu.sam.serialize import load_sam as jax_load_sam
    from samd_tpu_torch.fused_sam import BatchedFusedSamEngine, FusedSamConfig

    instr, corpus = tmp_path / "instr.jsonl", tmp_path / "corpus.jsonl"
    rows = [list(range(3, 40)), list(range(50, 90))]
    instr.write_text("".join(json.dumps({"tokens": r}) + "\n" for r in rows))
    argv = ["--input", str(instr), "--output", str(corpus), "--synthetic",
            "--cpu", "--max-new-tokens", "12", "--max-cache-len", "256",
            "--temperature", "0"]
    assert gen_corpus.main(argv) == 0
    out = [json.loads(ln) for ln in corpus.read_text().splitlines()]
    assert len(out) == 2 and all("tokens" in r for r in out)
    cfg, params, _ = gen_corpus.build_model(
        argparse.Namespace(model_dir=None, tokenizer=None), "cpu")
    eng = BatchedFusedSamEngine(cfg, params, FusedSamConfig(), batch_size=4,
                                max_cache_len=256, eos_token_id=2,
                                device="cpu")
    gen = GenerationConfig(max_new_tokens=12, max_cache_len=256)
    rids = [eng.add_request(r, gen) for r in rows]
    res = eng.run()
    assert [r["tokens"] for r in out] == [res[i].output_ids for i in rids]
    assert len(out[0]["tokens"]) > 37

    mine, ref = tmp_path / "sam.npz", tmp_path / "ref.npz"
    stats = build_sam.main(["--input", str(corpus), "--output", str(mine),
                            "--eos-token", "0", "--add-vocab", "16"])
    jax_build_sam(argparse.Namespace(
        input=str(corpus), output=str(ref), tokenizer=None, eos_token=0,
        add_vocab=16, topk=8, verbose=False))
    assert npz_bytes(mine) == npz_bytes(ref)
    assert stats["states"] == jax_load_sam(str(mine)).num_states > 100


def test_build_sam_text_rows(tmp_path, monkeypatch):
    """Text rows need --tokenizer; without transformers the error says
    so plainly."""
    rows = tmp_path / "text.jsonl"
    rows.write_text(json.dumps({"prompt": "a", "response": "b"}) + "\n")
    args = ["--input", str(rows), "--output", str(tmp_path / "s.npz")]
    with pytest.raises(SystemExit, match="--tokenizer required"):
        build_sam.main(args)
    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.startswith("transformers"):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(SystemExit, match="need the transformers package"):
        build_sam.main(args + ["--tokenizer", str(tmp_path)])


def test_prompt_templates():
    rows = [{"instruction": "Add 2 and 2.", "input": "numbers: 2, 2"},
            {"instruction": "Hi."}, {"prompt": "raw"}]
    for row in rows:
        for template in ("vicuna", "alpaca", "none"):
            assert gen_corpus.template_prompt(row, template) == \
                jax_template(row, template)
    v = gen_corpus.template_prompt(rows[0], "vicuna")
    assert v.endswith("ASSISTANT:") and "Add 2 and 2." in v
    assert "### Input:" in gen_corpus.template_prompt(rows[0], "alpaca")
    assert "### Input:" not in gen_corpus.template_prompt(rows[1], "alpaca")


# ----------------------------------------------------------------------
# The evaluation fan-out
# ----------------------------------------------------------------------

def write_questions(path, n=6, vocab=256):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for qid in range(n):
            turns = [rng.integers(3, vocab, size=24).tolist()]
            f.write(json.dumps({"question_id": qid, "category": "qa",
                                "turns": turns}) + "\n")


def run_launch(*args):
    res = subprocess.run(
        [sys.executable, "-m", "samd_tpu_torch.evaluation.launch", *args],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_shard_requests_matches_jax():
    items = list(range(11))
    for n in (1, 2, 3):
        shards = [launch.shard_requests(items, i, n) for i in range(n)]
        assert shards == [jax_shard(items, process_id=i, num_processes=n)
                          for i in range(n)]
        assert sorted(sum(shards, [])) == items
    with pytest.raises(ValueError):
        launch.shard_requests(items, 2, 2)


def test_two_process_launch_merges_sorted(tmp_path):
    """Two workers' merged answers: every question once, sorted, each
    equal to the engine called in this process."""
    qfile, out = str(tmp_path / "q.jsonl"), str(tmp_path / "a.jsonl")
    write_questions(qfile)
    flags = ["--engine", "sam_only", "--cpu", "--max-new-tokens", "8",
             "--max-cache-len", "256", "--warmup", "0"]
    summary = run_launch("--question-file", qfile, "--out", out,
                         "--num-workers", "2", *flags)
    assert summary["workers"] == 2
    rows = [json.loads(ln) for ln in open(out) if ln.strip()]
    assert [r["question_id"] for r in rows] == list(range(6))
    engine = launch.build_engine(launch.parse_args(
        ["--question-file", qfile, "--out", out, *flags]))
    gen = GenerationConfig(max_new_tokens=8, max_cache_len=256)
    for r, line in zip(rows, open(qfile)):
        prompt = json.loads(line)["turns"][0]
        want = engine.generate(prompt, gen).output_ids[len(prompt):]
        assert r["choices"][0]["turns"][0] == want
        assert r["choices"][0]["new_tokens"][0] == 8


def test_retention_check_report(tmp_path):
    """--retention-check: each worker's throughput against one process
    over every question."""
    qfile, out = str(tmp_path / "q.jsonl"), str(tmp_path / "a.jsonl")
    write_questions(qfile, n=4)
    report = run_launch("--question-file", qfile, "--out", out,
                        "--num-workers", "2", "--engine", "sam_only",
                        "--cpu", "--max-new-tokens", "8", "--max-cache-len",
                        "256", "--warmup", "0", "--retention-check")
    assert report["single_process_tokens_per_s"] > 0
    assert len(report["per_worker_tokens_per_s"]) == 2
    assert all(r > 0 for r in report["per_worker_retention"])
    assert len([ln for ln in open(out) if ln.strip()]) == 4


def test_single_process_launch(tmp_path, capsys):
    qfile, out = str(tmp_path / "q.jsonl"), str(tmp_path / "a.jsonl")
    write_questions(qfile, n=2)
    stats = launch.main(["--question-file", qfile, "--out", out,
                         "--engine", "ar", "--cpu", "--max-new-tokens", "4",
                         "--max-cache-len", "256", "--warmup", "0"])
    assert stats["total_tokens"] == 8
    assert json.loads(capsys.readouterr().out.strip()) == stats
    assert len([ln for ln in open(out) if ln.strip()]) == 2
