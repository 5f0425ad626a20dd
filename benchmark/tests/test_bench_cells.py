"""BENCHMARK.json against the shape it must keep, the files each name finds,
traffic that repeats from its seed, and a configuration, a mix and a
metric added as files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness.registry import Registry
from benchmark.harness.traffic import Traffic, strata, zipf_quota

from conftest import ROOT, make_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_and_entry_keys(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in bench["end_to_end"])


def test_every_cell_reports_and_finds_its_files(bench):
    reg = Registry()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        names = [m["name"] for m in reg.end_to_end(w["name"])]
        assert "setup_s" in names and len(names) >= 2
        layer = reg.per_layer(w["name"])
        assert layer
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                     [w["name"]])
            assert callable(reg.module("metrics", m["name"]).read)
        cfg = reg.config(w["config"])
        reg.traffic(w["traffic"])
        cell = reg.cell(w["name"])
        assert cell["limits"]["logit_gap"] > 0
        reg.module("weights", cfg["weights"]["route"])
        reg.module("engines", cfg["serving"]["engine"])
        reg.module("reference", cfg["reference"])


def test_config_files_hold_the_ports_presets(bench):
    from benchmark.harness.main import model_config

    reg = Registry()
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        model_config(cfg)         # raises unless it is the port's preset


def test_traffic_repeats_from_its_seed():
    reg = Registry()
    mix = reg.traffic("chat")

    def first(seed, n=70):
        it = Traffic(mix, seed, 152064, "chat").requests()
        return [next(it) for _ in range(n)]

    a, b, c = first(2 ** 31 + 5), first(2 ** 31 + 5), first(7)
    assert [(r.ids, r.max_new) for r in a] == [(r.ids, r.max_new) for r in b]
    assert [r.ids for r in a] != [r.ids for r in c]
    # another seed: other ids, the same sizes in the same order
    assert [(len(r.ids), r.max_new) for r in a] == \
        [(len(r.ids), r.max_new) for r in c]
    K = mix["strata"]
    for reqs in (a, c):       # every block of K holds the same sizes
        for j in range(0, 2 * K, K):
            block = reqs[j:j + K]
            assert sorted(len(r.ids) for r in block) == \
                sorted(strata(mix["prompt_len"], K))
            assert sorted(r.max_new for r in block) == \
                sorted(strata(mix["new_tokens"], K))


def test_documents_repeat_from_the_seed():
    mix = Registry().traffic("rag")
    a = Traffic(mix, 11, 1000, "rag")
    b = Traffic(mix, 11, 1000, "rag")
    assert a.documents == b.documents
    assert sorted(map(len, a.documents)) == \
        sorted(strata(mix["documents"]["len"], mix["documents"]["count"]))
    assert a.questions == b.questions
    it = a.requests()
    reqs = [next(it) for _ in range(64)]
    assert all(r.ids == a.documents[r.doc] + a.questions[r.doc][r.question]
               for r in reqs)
    assert a.stored_prompts() == [d + q[0] for d, q in
                                  zip(a.documents, a.questions)]
    K = mix["strata"]
    quota = zipf_quota(len(a.documents), K, mix["documents"]["pick"]["zipf"])
    asks = zipf_quota(mix["questions"]["count"], K,
                      mix["questions"]["pick"]["zipf"])
    for j in range(0, 2 * K, K):      # every block asks each rank its share
        assert sorted(r.doc for r in reqs[j:j + K]) == quota
        assert sorted(r.question for r in reqs[j:j + K]) == asks
    c = Traffic(mix, 12, 1000, "rag")     # another seed: the same sizes
    assert list(map(len, c.documents)) == list(map(len, a.documents))
    it_c = c.requests()
    assert [(r.doc, r.question, r.max_new) for r in reqs] == \
        [(r.doc, r.question, r.max_new) for r in
         (next(it_c) for _ in range(64))]
    assert [list(map(len, q)) for q in c.questions] == \
        [list(map(len, q)) for q in a.questions]
    # budgets reach past the stored answer, so drafts run out
    stored = mix["corpus"]["continuation"]
    assert all(mix["new_tokens"]["min"] <= r.max_new
               <= mix["new_tokens"]["max"] for r in reqs)
    assert any(r.max_new > stored for r in reqs)
    assert any(r.question != 0 for r in reqs)
    assert {len(r.ids) for r in reqs} <= set(a.prompt_lengths())


def test_added_files_are_found_by_name(tmp_path):
    """A new configuration, mix, metric and cell, as files and
    BENCHMARK.json entries only."""
    root = make_tree(str(tmp_path))
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(b, "configs", "tiny_qwen2.json"),
                os.path.join(b, "configs", "another_model.json"))
    with open(os.path.join(b, "traffic", "burst.json"), "w") as fh:
        json.dump({"clients": 3, "strata": 4,
                   "prompt_len": {"dist": "uniform", "min": 4, "max": 8},
                   "new_tokens": {"dist": "uniform", "min": 4, "max": 8},
                   "corpus": {"kind": "random", "tokens": 16}}, fh)
    with open(os.path.join(b, "metrics", "segments_seen.py"), "w") as fh:
        fh.write("def read(view):\n    return float(len(view.segments))\n")
    shutil.copy(os.path.join(b, "cells", "tiny_qwen2.chat.json"),
                os.path.join(b, "cells", "another_model.burst.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "another_model.burst",
                               "config": "another_model",
                               "traffic": "burst", "chips": 1, "why": "t"})
    bench["per_layer"].append({
        "name": "segments_seen", "unit": "segments", "better": "higher",
        "source": "program_counter", "layer": "request loop",
        "moves": "output_tokens_per_s",
        "workloads": ["another_model.burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    reg = Registry(root=root, pkg_dir=b)
    w = reg.workload("another_model.burst")
    assert reg.config(w["config"])["hidden_size"] == 64
    assert reg.traffic(w["traffic"])["clients"] == 3
    names = [m["name"] for m in reg.per_layer("another_model.burst")]
    assert "segments_seen" in names and "accept_len" in names
    assert "segments_seen" not in [m["name"] for m in
                                   reg.per_layer("tiny_qwen2.chat")]

    class View:
        segments = [1, 2]
    assert reg.module("metrics", "segments_seen").read(View()) == 2.0
