"""End-to-end metrics, on the host's clock, over the closed loop's window
[t0, t_end]:

    output_tokens_per_s  every output token whose chunk arrived in the
                         window, over the window's seconds
    ttft_p90_ms          90th percentile over every request submitted in
                         the window of submit -> first chunk; a request
                         with no chunk at the close counts at its wait so
                         far, a failed one at the whole window
    tpot_p90_ms          90th percentile over the requests finished in the
                         window of (last chunk - first chunk) / (n - 1)
    setup_s              process start -> window start

Percentiles interpolate linearly between the closest ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def output_tokens_per_s(records: List, t0: float, t_end: float) -> float:
    n = sum(k for r in records for t, k in r.chunks if t <= t_end)
    return n / (t_end - t0)


def ttft_p90_ms(records: List, t0: float, t_end: float) -> Optional[float]:
    waits = []
    for r in records:
        if r.t_submit > t_end:
            continue
        if r.error is not None:
            waits.append(t_end - t0)
        elif r.t_first is not None and r.t_first <= t_end:
            waits.append(r.t_first - r.t_submit)
        else:
            waits.append(t_end - r.t_submit)
    return float(np.percentile(waits, 90)) * 1e3 if waits else None


def tpot_p90_ms(records: List, t0: float, t_end: float) -> Optional[float]:
    per = [(r.t_last - r.t_first) / (len(r.served) - 1) for r in records
           if r.finished and r.t_last <= t_end and len(r.served) > 1]
    return float(np.percentile(per, 90)) * 1e3 if per else None


FUNCTIONS = {"output_tokens_per_s": output_tokens_per_s,
             "ttft_p90_ms": ttft_p90_ms, "tpot_p90_ms": tpot_p90_ms}


def measure(names: List[str], records: List, t0: float, t_end: float,
            setup_s: float) -> Dict[str, float]:
    out = {}
    for name in names:
        out[name] = setup_s if name == "setup_s" else \
            FUNCTIONS[name](records, t0, t_end)
    return out
