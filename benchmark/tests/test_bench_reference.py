"""The harness end to end on the CPU at tiny sizes: the plain reference
against the port's ``PagedBatchedFusedSamEngine`` (tiny Qwen2 and tiny
Mixtral, int4 weights, int8 pages), the control held to the cell's limits
and not correct, the faults that must turn ``correct`` false, and the look
for a card."""

import contextlib
import io
import time

import pytest

from benchmark.harness.main import main, run_cell

SECONDS = 3.0


def run(reg, workload, seed=2 ** 31 + 9, trace=False, control=False):
    return run_cell(reg, workload, seed, SECONDS, trace, "cpu",
                    time.perf_counter(), control=control)


@pytest.mark.parametrize("workload", ["tiny_qwen2.chat", "tiny_moe.chat",
                                      "tiny_qwen2.rag"])
def test_the_reference_agrees_with_the_port(tiny_registry, workload):
    res, checks = run(tiny_registry, workload)
    assert res["correct"], checks
    assert checks["compared_tokens"]["value"] >= 4
    assert checks["logit_gap"]["value"] <= 0.1
    m = res["metrics"]
    assert {"output_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms",
            "setup_s"} <= set(m)
    assert m["output_tokens_per_s"]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0


def test_documents_are_drafted_from_the_corpus(tiny_registry):
    res, _ = run(tiny_registry, "tiny_qwen2.rag", trace=True)
    m = res["metrics"]
    assert m["corpus_draft_share"]["value"] > 50
    assert m["accept_len"]["value"] > 4


def test_a_traced_run_reports_the_span_metrics(tiny_registry):
    res, checks = run(tiny_registry, "tiny_qwen2.chat", trace=True)
    assert res["correct"], checks
    m = res["metrics"]
    for name in ("accept_len", "slot_occupancy", "steps_per_segment",
                 "step_ms", "prefill_ms_p50"):
        assert m[name]["value"] > 0
    assert 0 < m["slot_occupancy"]["value"] <= 100


@pytest.mark.parametrize("workload", ["tiny_qwen2.chat", "tiny_qwen2.rag"])
def test_the_control_is_not_correct(tiny_registry, workload):
    """fp8 activations in the reference's place, held to the cell's own
    limits by the same comparison: not correct on any of three seeds,
    where the program is."""
    for seed in (1, 2, 3):
        res, checks = run(tiny_registry, workload, seed=seed, control=True)
        r = res["readings"]
        assert res["correct"], checks
        assert r["control_correct"] is False, r
        assert r["control_logit_gap"] > r["logit_gap"]


def test_an_altered_token_is_not_correct(tiny_registry, monkeypatch):
    from samd_tpu_torch.fused_sam import BatchedFusedSamEngine

    step = BatchedFusedSamEngine._step

    def altered(self, *a, **k):
        out = list(step(self, *a, **k))
        out[1] = (out[1] + 1) % self.model_cfg.vocab_size   # the bonus
        return tuple(out)

    monkeypatch.setattr(BatchedFusedSamEngine, "_step", altered)
    res, checks = run(tiny_registry, "tiny_qwen2.chat")
    assert not res["correct"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        tiny_registry, monkeypatch):
    from samd_tpu_torch.fused_sam import BatchedFusedSamEngine

    def unchanged(self, hist_lens, starts, budgets, lives, slot_steps,
                  corpus_steps, *a, **k):
        return hist_lens, starts, budgets, lives, slot_steps, corpus_steps

    monkeypatch.setattr(BatchedFusedSamEngine, "_step", unchanged)
    # the engine's stall guard ends the run in set-up: no result line
    with pytest.raises(MemoryError):
        run(tiny_registry, "tiny_qwen2.chat")


def test_a_step_that_leaves_the_cache_unchanged_is_not_correct(
        tiny_registry, monkeypatch):
    """The decode steps' KV writes skipped (the prefill's hand-off to the
    pages stays): the step's cache state is left as it was."""
    import samd_tpu_torch.paged_kv as paged_kv

    monkeypatch.setattr(paged_kv, "paged_write_block",
                        lambda cache, block, pages, slots: None)
    res, checks = run(tiny_registry, "tiny_qwen2.chat")
    assert not res["correct"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_no_card_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(["--workload", "qwen2_7b-int4.chat", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.cuda
def test_a_traced_tiny_run_on_the_card(tiny_registry):
    """The profiler's device trace and the metrics that read it (a window
    long enough for CUPTI's first start, 6-7 s on an H100 and at times
    more, and the trace)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res, checks = run_cell(tiny_registry, "tiny_qwen2_cuda.chat", 5, 30.0,
                           True, "cuda", time.perf_counter())
    assert res["correct"], checks
    assert "busy_s" in res["device"], "the trace did not close in the window"
    assert res["device"]["busy_s"] > 0
    assert 0 <= res["metrics"]["device_idle_share"]["value"] < 100
    assert res["breakdown"]["device_ops"]
