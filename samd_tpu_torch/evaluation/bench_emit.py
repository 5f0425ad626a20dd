"""Benchmark artifact emission: compact stdout lines and a full detail file
(counterpart of ``samd_tpu/evaluation/bench_emit.py``).

A run that prints one JSON line carrying every number at its end has two
ways to lose them: the line outgrows a reader that keeps only the tail of
the output, and a crash part way through leaves no line at all.  So:

  * ``compact_line`` builds a JSON line of the curated headline keys that
    never exceeds ``MAX_LINE`` characters;
  * ``BenchEmitter.emit``, called after every section, rewrites the full
    detail file and prints a fresh compact line.  A reader takes the last
    line, so a crash in section N still leaves sections 1 to N - 1 as valid
    JSON.

Plain Python: neither torch nor numpy is needed.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

MAX_LINE = 1800  # under a 2000-character tail capture, with margin

# The headline keys, in the order they are kept: when a line would be too
# long, keys are dropped from the end.  Everything else goes to the detail
# file only.
HEADLINE_KEYS = (
    "ar_tokens_per_s",
    "host_sam_only_speedup",
    "greedy_outputs_equal",
    "fused_sam_tokens_per_s",
    "fused_sam_mean_accept",
    "fused_sam_ms_per_step",
    "fused_sam_overlap_trajectory_equal",
    "int8_fused_sam_tokens_per_s",
    "int8_fused_sam_ms_per_step",
    "int8_vs_bf16_step_time_ratio",
    "int4_fused_sam_tokens_per_s",
    "int4_vs_int8_step_time_ratio",
    "int8_batched_peak_tokens_per_s",
    "int8_batched_hybrid_peak_tokens_per_s",
    "paged_fused_batched_tokens_per_s",
    "paged_fused_batched_vs_dense_ratio",
    "int8_7b_fused_sam_tokens_per_s",
    "int8_7b_fused_sam_ms_per_step",
    "int4_7b_fused_sam_tokens_per_s",
    "int4_7b_vs_int8_7b_step_time_ratio",
    "int4_7b_base_weights_match_int8_row",
    "int4_7b_paged_batched_tokens_per_s",
    "int4_13b_fused_sam_tokens_per_s",
    "int4_batched_fused_sam_tokens_per_s",
    "fused_sam_token_recycle_tokens_per_s",
    "fused_sam_token_recycle_mean_accept",
    "fused_sam_token_recycle_equal_count",
    "fused_sam_eagle2_tokens_per_s",
    "fused_sam_eagle2_equal_count",
    "int8_fused_eagle2_tokens_per_s",
    "flagship_ttft_ms",
    "flagship_ttft_2k_prompt_ms",
    "trained_accept_eagle2",
    "trained_accept_token_recycle",
    "longcache8k_flash_vs_xla_ratio",
    "specbench_fused_sam_speedup",
    "specbench_equal",
    # last, so that an overflowing line drops it before any measurement
    "skipped_sections",
)

METRIC = "fused_sam_speedup_vs_own_ar_synthetic_1b"


def compact_line(detail: Dict, *, value: float, vs_baseline: float,
                 complete: bool) -> str:
    """One JSON line holding only the headline keys of ``detail``, at most
    ``MAX_LINE`` characters: trailing headline keys are dropped until it
    fits, never the header."""
    head = {k: detail[k] for k in HEADLINE_KEYS if k in detail}
    base = {
        "metric": METRIC,
        "value": value,
        "unit": "x",
        "vs_baseline": vs_baseline,
        "complete": complete,
        "detail_file": "bench_detail.json",
    }
    line = json.dumps({**base, "detail": head})
    while len(line) > MAX_LINE and head:
        head.pop(next(reversed(head)))
        line = json.dumps({**base, "detail": head})
    return line


class BenchEmitter:
    """Writes the artifact after every section.  ``detail`` is the caller's
    dict, read afresh at each ``emit``; ``value`` and ``vs_baseline`` stay
    0.0 in the output until set."""

    def __init__(self, detail: Dict, path: str = "bench_detail.json"):
        self.detail = detail
        self.path = path
        self.value: Optional[float] = None
        self.vs_baseline: Optional[float] = None

    def emit(self, complete: bool = False) -> None:
        """Rewrite the detail file (a failed write is reported on stderr
        and the run goes on) and print the compact line."""
        value = self.value if self.value is not None else 0.0
        vsb = self.vs_baseline if self.vs_baseline is not None else 0.0
        full = {
            "metric": METRIC,
            "value": value, "unit": "x", "vs_baseline": vsb,
            "complete": complete, "detail": self.detail,
        }
        try:
            with open(self.path, "w") as f:
                json.dump(full, f)
        except OSError as e:
            print(f"bench_detail write failed: {e}", file=sys.stderr)
        print(compact_line(self.detail, value=value, vs_baseline=vsb,
                           complete=complete), flush=True)
