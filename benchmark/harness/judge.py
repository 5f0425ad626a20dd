"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the window finished, the longest of
them first, then others until the cell's ``sample_tokens`` served tokens
(at most ``sample_requests`` requests), goes through the configuration's
plain reference: one forward over each prompt with its served tokens.  The
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position (every request is greedy),
and where the cell's ``limits`` name them, the mean of those gaps and the
share of served tokens that are not the reference's best.

A run with a control (``benchmark/control.py``) holds the control's gap
numbers, on the same sample, to the same limits:
``control_correct`` has to come out false.

Beside it, with limit 0 each: requests whose streamed tokens differ from
their ``Outputs``, finished requests shorter than their budget (the end
token is off), and requests that failed in the window.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .draws import stream_seed


def sample(finished: List, seed: int, tokens: int, at_most: int) -> List:
    """The longest finished request, then others drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: (
        -(len(finished[i].request.ids) + len(finished[i].served)), i))
    rng = np.random.default_rng(stream_seed(seed, "judge"))
    rest = [order[0]] + [order[1:][j] for j in
                         rng.permutation(len(order) - 1)]
    picked, n = [], 0
    for i in rest:
        if n >= tokens or len(picked) >= at_most:
            break
        picked.append(finished[i])
        n += len(finished[i].served)
    return picked


def check(name: str, value, limit, rule: str = "<=") -> Tuple[str, Dict]:
    return name, {"value": value, "limit": limit, "rule": rule}


def passes(c: Dict) -> bool:
    v, lim = c["value"], c["limit"]
    if v is None:
        return False
    return v <= lim if c["rule"] == "<=" else v >= lim


def stream_checks(records: List) -> List[Tuple[str, Dict]]:
    finished = [r for r in records if r.finished]
    mismatch = sum(r.output != r.served for r in finished)
    short = sum(len(r.served) != r.request.max_new for r in finished)
    failed = sum(r.error is not None for r in records)
    return [check("stream_vs_outputs", mismatch, 0),
            check("short_answers", short, 0),
            check("failed_requests", failed, 0)]


def gap_numbers(gaps: List) -> Dict[str, float]:
    """The numbers a sample's per-token gaps give: the widest gap, the mean
    gap, and the share (%) of tokens that are not the reference's best."""
    import torch

    g = torch.cat([x.flatten() for x in gaps]).double()
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()),
            "differing_share": 100.0 * float((g > 0).double().mean())}


def judge(records: List, reference, cell: Dict, seed: int
          ) -> Tuple[bool, Dict[str, Dict], Dict]:
    """(correct, the checks, readings that decide nothing: every gap
    number of the sample and, with a control reference, the control's on
    the same sample, and whether those pass the limits).
    The cell's ``limits`` name the gap numbers compared."""
    finished = [r for r in records if r.finished]
    picked = sample(finished, seed, cell["sample_tokens"],
                    cell["sample_requests"])
    n_tok = sum(len(r.served) for r in picked)
    readings: Dict = {}
    if picked:
        res = reference.gaps([(r.request.ids, r.served) for r in picked])
        readings = gap_numbers([g["served"] for g in res])
        if res[0].get("control") is not None:
            ctrl = {f"control_{k}": v for k, v in
                    gap_numbers([g["control"] for g in res]).items()}
            readings.update(ctrl)
            readings["control_correct"] = all(passes(check(
                name, ctrl.get(f"control_{name}"), limit)[1])
                for name, limit in cell["limits"].items())
    checks = dict([check(name, readings.get(name), limit)
                   for name, limit in cell["limits"].items()]
                  + [check("compared_tokens", n_tok, cell["min_tokens"],
                           ">="), *stream_checks(records)])
    return all(passes(c) for c in checks.values()), checks, readings
