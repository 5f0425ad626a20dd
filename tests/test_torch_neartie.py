"""The near-tie rule of ``chip_smoke.py``'s judge (``near_tie_rule``), a
pure function of the oracle's rows, a plain prefill's rows and the gap
triple at a first difference: tau is 0.08 over bf16 KV and, over int8 KV,
the largest change the plain prefill makes to the oracle's top-2 gap when
that is larger; a first difference passes only within tau, and only when
neither the plain prefill nor the engine moves the gap past the drift
bound."""

import numpy as np
import pytest
import torch

from chip_smoke import NEAR_TIE, near_tie_rule, top2_gap_changes

V = 64


def rows_with_gap_changes(changes, seed=0):
    """Oracle rows [N, V] whose top-2 gap a plain prefill moves by exactly
    ``changes`` (the plain rows raise each row's second token), every
    other logit moved at random by up to 0.5 below the top two."""
    rng = np.random.default_rng(seed)
    n = len(changes)
    oracle = rng.standard_normal((n, V)).astype(np.float32)
    oracle[:, 0], oracle[:, 1] = 10.0, 9.0        # top-2: tokens 0 and 1
    plain = oracle.copy()
    plain[:, 1] += np.asarray(changes, np.float32)
    plain[:, 2:] += rng.uniform(-0.5, 0.0, (n, V - 2)).astype(np.float32)
    return torch.from_numpy(oracle), torch.from_numpy(plain)


def test_bf16_keeps_the_fixed_bound():
    """Over bf16 KV tau is 0.08 whatever the plain prefill does."""
    oracle, plain = rows_with_gap_changes([0.01, 0.3, 0.6])
    tau, why = near_tie_rule(oracle, plain, None, 1.0, int8=False)
    assert tau == NEAR_TIE and why is None
    assert near_tie_rule(oracle, plain, (0.07, 0.05, 0.06), 1.0,
                         int8=False) == (NEAR_TIE, None)
    assert near_tie_rule(oracle, plain, (0.09, 0.09, 0.09), 1.0,
                         int8=False)[1] is not None


@pytest.mark.parametrize("changes,tau", [([0.02, 0.25, 0.11], 0.25),
                                         ([0.01, 0.03, 0.05], NEAR_TIE)])
def test_int8_tau_from_gap_changes_alone(changes, tau):
    """Over int8 KV, tau is the largest top-2 gap change (never below
    0.08); logits outside each row's top two do not enter it."""
    oracle, plain = rows_with_gap_changes(changes)
    np.testing.assert_allclose(top2_gap_changes(oracle, plain), changes,
                               atol=1e-6)
    got, why = near_tie_rule(oracle, plain, None, 1.0, int8=True)
    assert why is None
    assert got == pytest.approx(tau, abs=1e-6)
    moved = plain.clone()
    moved[:, 2:] -= 3.0                         # far from the top two
    assert near_tie_rule(oracle, moved, None, 1.0, int8=True)[0] == got


def test_rejects_a_first_difference_beyond_tau():
    oracle, plain = rows_with_gap_changes([0.02, 0.2])
    tau = near_tie_rule(oracle, plain, None, 1.0, int8=True)[0]
    assert tau == pytest.approx(0.2, abs=1e-6)
    assert near_tie_rule(oracle, plain, (-0.19, 0.05, -0.1), 1.0,
                         int8=True)[1] is None
    for gap in (-0.21, 0.25):
        _, why = near_tie_rule(oracle, plain, (gap, gap, gap), 1.0,
                               int8=True)
        assert why is not None and "tau" in why


@pytest.mark.parametrize("drift", [2.04, 4.76])
def test_rejects_the_planted_fault_drifts(drift):
    """Phase 9's planted tree faults drift 2.04-4.76 from the oracle
    against a bound of 0.47-0.79: a gap the engine or the plain prefill
    moves that far is no near-tie, on int8 KV as on bf16."""
    oracle, plain = rows_with_gap_changes([0.05, 0.3])
    spread = 0.78853
    for int8 in (False, True):
        _, why = near_tie_rule(oracle, plain, (0.01, 0.01, 0.01 + drift),
                               spread, int8)
        assert why is not None and "engine" in why
        _, why = near_tie_rule(oracle, plain, (0.01, 0.01 - drift, 0.01),
                               spread, int8)
        assert why is not None and "plain prefill" in why
