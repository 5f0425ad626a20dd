"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``).

``tiny_tree`` is a temporary copy of ``benchmark/`` with tiny Qwen2 and
Mixtral configurations, a tiny chat and document mix and their cells,
named in a ``BENCHMARK.json`` of its own: the harness runs them on the CPU
through the same files and code as a run on the card."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips without one")


# init_scale 0.15 at hidden 64 spreads the logits as 0.02 does at the
# published widths, so the program's and the control's gaps read alike
TINY_QWEN2 = {
    "name": "tiny_qwen2", "source": "test", "model_type": "qwen2",
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "max_position_embeddings": 512,
    "tie_word_embeddings": False, "reduced": [],
    "weights": {"route": "bf16_whole_to_int4", "init_scale": 0.15},
    "reference": "llama_family",
    "serving": {"engine": "paged_fused_sam", "batch_size": 4,
                "steps_per_call": 16, "n_predicts": 15, "max_cache_len": 112,
                "page_size": 16, "n_pages": 28, "quantized_kv": True,
                "prefill_buckets": [32, 64], "corpus_capacity": 512}}
# the card's paged kernel reads pages of a multiple of 64 rows
TINY_QWEN2_CUDA = dict(TINY_QWEN2, name="tiny_qwen2_cuda", serving=dict(
    TINY_QWEN2["serving"], page_size=64, max_cache_len=128, n_pages=8))
TINY_MOE = dict(TINY_QWEN2, name="tiny_moe", model_type="mixtral",
                num_local_experts=4, num_experts_per_tok=2,
                weights={"route": "bf16_whole_to_int4", "init_scale": 0.02})
TINY_CHAT = {
    "clients": 6, "strata": 8,
    "prompt_len": {"dist": "lognormal", "median": 20, "sigma": 0.8,
                   "min": 4, "max": 64},
    "new_tokens": {"dist": "lognormal", "median": 12, "sigma": 0.7,
                   "min": 4, "max": 24},
    "corpus": {"kind": "random", "tokens": 256}}
TINY_RAG = {
    "clients": 6, "strata": 8,
    "documents": {"count": 4, "len": {"dist": "loguniform", "min": 8,
                                      "max": 40}, "pick": {"zipf": 1.0}},
    "questions": {"count": 1, "len": {"dist": "uniform", "min": 4,
                                      "max": 4}, "pick": {"zipf": 1.0}},
    "new_tokens": {"dist": "uniform", "min": 4, "max": 24},
    "corpus": {"kind": "served_documents", "continuation": 24,
               "separator": 0}}
TINY_CELL = {"sample_tokens": 60, "sample_requests": 4, "min_tokens": 4,
             "limits": {"logit_gap": 0.1, "mean_gap": 0.003},
             "trace_start": 0.3, "trace_seconds": 1.0}
TINY_WORKLOADS = {"tiny_qwen2.chat": ("tiny_qwen2", "tiny_chat"),
                  "tiny_moe.chat": ("tiny_moe", "tiny_chat"),
                  "tiny_qwen2.rag": ("tiny_qwen2", "tiny_rag"),
                  "tiny_qwen2_cuda.chat": ("tiny_qwen2_cuda", "tiny_chat")}


def _dump(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_tree(dst: str) -> str:
    """A copy of the benchmark with the tiny cells; returns its root."""
    shutil.copytree(PKG, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    b = os.path.join(dst, "benchmark")
    _dump(os.path.join(b, "configs", "tiny_qwen2.json"), TINY_QWEN2)
    _dump(os.path.join(b, "configs", "tiny_moe.json"), TINY_MOE)
    _dump(os.path.join(b, "configs", "tiny_qwen2_cuda.json"), TINY_QWEN2_CUDA)
    _dump(os.path.join(b, "traffic", "tiny_chat.json"), TINY_CHAT)
    _dump(os.path.join(b, "traffic", "tiny_rag.json"), TINY_RAG)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"] = [
        {"name": w, "config": c, "traffic": t, "chips": 1, "why": "test"}
        for w, (c, t) in TINY_WORKLOADS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for w in TINY_WORKLOADS:
        _dump(os.path.join(b, "cells", f"{w}.json"), TINY_CELL)
    _dump(os.path.join(dst, "BENCHMARK.json"), bench)
    return dst


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    import torch

    torch.set_num_threads(1)
    return make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def tiny_registry(tiny_tree):
    from benchmark.harness.registry import Registry

    return Registry(root=tiny_tree,
                    pkg_dir=os.path.join(tiny_tree, "benchmark"))
