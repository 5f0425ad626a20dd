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


# ---------------------------------------------------------------------------
# evaluation.neartie: the auditor against samd_tpu's (tests/test_neartie.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def auditors():
    """The reference tests' tiny model in both packages, an oracle output
    of the port's ArBaseline, and both auditors."""
    import jax

    from samd_tpu.evaluation.neartie import NearTieAuditor as JaxAuditor
    from samd_tpu.models import init_params, tiny_config
    from samd_tpu_torch.bridge import params_from_jax
    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.evaluation.neartie import NearTieAuditor
    from test_torch_model import port_config

    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    cfg = port_config(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(3).integers(3, 128, size=16).tolist()
    out = ArBaseline(cfg, params, max_cache_len=128, eos_token_id=-1,
                     prefill_buckets=(32,), device="cpu").generate(
        prompt, GenerationConfig(max_new_tokens=24, max_cache_len=128))
    return (NearTieAuditor(cfg, params, max_cache_len=128),
            JaxAuditor(jcfg, jp, max_cache_len=128), out.output_ids,
            len(prompt))


def test_first_divergence():
    from samd_tpu_torch.evaluation.neartie import first_divergence

    assert first_divergence([1, 2, 3], [1, 2, 3]) == -1
    assert first_divergence([1, 2, 3], [1, 9, 3]) == 1
    assert first_divergence([1, 2], [1, 2, 3]) == -1


def test_audit_equal_outputs_clean(auditors):
    auditor, _, oracle, _ = auditors
    r = auditor.audit([oracle], [list(oracle)])
    assert r == {"misses": 0, "near_tie_confirmed": True, "details": []}


def test_probe_logits_equal_jax(auditors):
    """The canonical-column probe's logits and top two equal JAX's probe
    within f32 tolerance, at prefixes of three bucket sizes."""
    auditor, jax_auditor, oracle, plen = auditors
    for j in (5, plen + 7, plen + 20):
        last, top2v, top2i = auditor.logits_at(oracle[:j])
        jl, jv, ji = jax_auditor.logits_at(oracle[:j])
        np.testing.assert_allclose(last, np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(top2v, np.asarray(jv), atol=1e-4)
        assert top2i.tolist() == np.asarray(ji).tolist()


def test_runner_up_divergence_measured(auditors):
    """The engine committed the runner-up: the gap equals the canonical
    top-2 gap, and tau decides the verdict (as JAX's auditor does)."""
    auditor, jax_auditor, oracle, plen = auditors
    j = plen + 7
    _, top2v, top2i = auditor.logits_at(oracle[:j])
    assert int(top2i[0]) == oracle[j]
    engine = list(oracle)
    engine[j] = int(top2i[1])
    d = auditor.audit([oracle], [engine], tau=1e9)["details"][0]
    assert d["pos"] == j and d["near_tie"] is True
    assert d["gap"] == pytest.approx(d["canonical_top2_gap"], abs=1e-4)
    jd = jax_auditor.audit([oracle], [engine], tau=1e9)["details"][0]
    assert d["gap"] == pytest.approx(jd["gap"], abs=1e-4)
    assert auditor.audit([oracle], [engine], tau=1e-9)[
        "near_tie_confirmed"] is False


def test_garbage_token_flagged_as_bug(auditors):
    auditor, _, oracle, plen = auditors
    engine = list(oracle)
    j = plen + 3
    engine[j] = (oracle[j] + 7) % 128
    r = auditor.audit([oracle], [engine])
    assert r["misses"] == 1 and r["near_tie_confirmed"] is False
    assert abs(r["details"][0]["gap"]) > 0.08
