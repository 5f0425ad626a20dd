"""Operations and bytes against hand counts at Qwen2-7B's and
Mixtral-8x7B's shapes."""

import numpy as np
import pytest

from benchmark.harness.registry import Registry
from benchmark.harness.spans import SegmentSpan
from benchmark.roofline import peaks
from benchmark.roofline import work as W


@pytest.fixture(scope="module")
def qwen2():
    return W.Shapes.of(Registry().config("qwen2_7b-int4"))


@pytest.fixture(scope="module")
def mixtral():
    """Mixtral-8x7B-v0.1's published sizes."""
    return W.Shapes.of({
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 32000,
        "num_local_experts": 8, "num_experts_per_tok": 2})


def test_parameters_a_row_touches(qwen2, mixtral):
    per_layer = 3584 * 3584 + 2 * 3584 * 512 + 3584 * 3584 \
        + 3 * 3584 * 18944
    assert qwen2.params_per_row() == 28 * per_layer + 3584 * 152064
    # Mixtral: attention, router, the two routed experts, the head
    per_layer = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096 + 4096 * 8 \
        + 2 * 3 * 4096 * 14336
    assert mixtral.params_per_row() == 32 * per_layer + 4096 * 32000
    assert 12.7e9 < mixtral.params_per_row() < 12.8e9     # "13B active"


def test_int4_products(qwen2, mixtral):
    # Qwen2: seven projections a layer and the head
    assert sum(n for *_, n in qwen2.int4_products()) == 7 * 28 + 1
    # Mixtral: four attention projections a layer and the head
    assert sum(n for *_, n in mixtral.int4_products()) == 4 * 32 + 1
    nbytes, flops = W.int4_product(192, 3584, 18944, 2)
    assert nbytes == 3584 * 18944 / 2 + 18944 * 4 + 192 * 3584 * 2 \
        + 192 * 18944 * 2
    assert flops == 2 * 192 * 3584 * 18944
    # at 192 rows w_gate is bound by operations, at 16 by bytes
    assert flops / peaks.PEAK_FLOPS["bfloat16"] > \
        nbytes / peaks.HBM_BYTES_PER_S
    nb16, fl16 = W.int4_product(16, 3584, 18944, 2)
    assert peaks.bound_s(nb16, fl16) == nb16 / peaks.HBM_BYTES_PER_S
    head = W.int4_product(192, 3584, 152064, 4)
    total = 28 * (peaks.bound_s(*W.int4_product(192, 3584, 3584, 2)) * 2
                  + peaks.bound_s(*W.int4_product(192, 3584, 512, 2)) * 2
                  + peaks.bound_s(*W.int4_product(192, 3584, 18944, 2)) * 2
                  + peaks.bound_s(*W.int4_product(192, 18944, 3584, 2))) \
        + peaks.bound_s(*head)
    assert W.int4_forward_bound_s(qwen2, 192) == pytest.approx(total)


def test_paged_attention_bound(qwen2):
    # one live slot, 900 committed + 16 block columns, 28 layers
    c, M = 916, 16
    nbytes = 2 * c * 4 * (128 + 4) + 2 * M * 28 * 128 * 2 + M * 256 \
        + 23 * 4 + 4
    flops = 4 * 28 * M * 128 * c
    got = W.paged_attention_bound_s(qwen2, M, 128, 23, [c])
    assert got == pytest.approx(28 * max(nbytes / 3.35e12, flops / 989e12))


def test_a_segment_counts_live_slots_only(qwen2):
    """Slots 0 and 2 live for 3 and 1 steps, one token a step; slot 1
    holds no request."""
    span = SegmentSpan(0.0, 0.1, 3, np.array([100, 0, 50]),
                       np.array([103, 0, 51]), np.array([True, False, True]),
                       np.array([3, 0, 1]), np.array([0, 0, 0]))
    w = W.Work()
    W.add_segment(w, qwen2, 16, 128, 23, span)
    assert w.decode_steps == 3
    rows = 16 * (3 + 1)
    causal = sum(16 * h + 16 * 17 / 2 for h in (100, 101, 102, 50))
    assert w.model_flops == pytest.approx(
        2 * qwen2.params_per_row() * rows + 4 * 28 * 128 * causal * 28)
    want = W.int4_forward_bound_s(qwen2, 32) \
        + 2 * W.int4_forward_bound_s(qwen2, 16)
    assert w.int4_bound_s == pytest.approx(want)


def test_a_prefill(mixtral):
    w = W.Work()
    W.add_prefill(w, mixtral, 500)
    head = 4096 * 32000
    assert w.model_flops == pytest.approx(
        2 * (mixtral.params_per_row() - head) * 500 + 2 * head
        + 4 * 32 * 128 * 500 * 501 / 2 * 32)
    assert w.mfu(1.0) == pytest.approx(w.model_flops / 989e12)


def test_a_qwen2_prefill_counts_the_head_at_one_row(qwen2):
    """A 512-row prompt: seven projections a layer at 512 rows, the
    3584 -> 152064 head at the last row only."""
    w = W.Work()
    W.add_prefill(w, qwen2, 512)
    bound = 28 * (peaks.bound_s(*W.int4_product(512, 3584, 3584, 2)) * 2
                  + peaks.bound_s(*W.int4_product(512, 3584, 512, 2)) * 2
                  + peaks.bound_s(*W.int4_product(512, 3584, 18944, 2)) * 2
                  + peaks.bound_s(*W.int4_product(512, 18944, 3584, 2))) \
        + peaks.bound_s(*W.int4_product(1, 3584, 152064, 4))
    assert w.int4_bound_s == pytest.approx(bound)
    head_bytes = 3584 * 152064 / 2 + 152064 * 4 + 3584 * 2 + 152064 * 4
    assert W.int4_product(1, 3584, 152064, 4) == (head_bytes,
                                                  2 * 3584 * 152064)
    per_layer = 3584 * 3584 + 2 * 3584 * 512 + 3584 * 3584 \
        + 3 * 3584 * 18944
    assert w.model_flops == pytest.approx(
        2 * 28 * per_layer * 512 + 2 * 3584 * 152064
        + 4 * 28 * 128 * 512 * 513 / 2 * 28)
    # the head at every row would count over 7 % more operations
    assert 2 * qwen2.params_per_row() * 512 > 1.07 * w.model_flops
