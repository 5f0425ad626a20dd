"""The readings that set a cell's ``logit_gap`` limit, on the card, in
one process (the benchmark's own runs never run this):

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it, then on the
same sample every gap number of the program (the lower readings) and of
the control (the upper readings): the reference put in the program's place
with every weight product's input in fp8 e4m3 instead of bf16
(``reference/llama_family.py``).  The control's numbers go through the
same comparison and limits as the program's (``harness/judge.py``).  One
JSON line a seed, then a summary; it exits 1 where the program is not
correct or the control is, on any seed.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

from benchmark.harness.main import power_line, run_cell  # noqa: E402
from benchmark.harness.registry import Registry  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    card = power_line()
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        res, checks = run_cell(reg, args.workload, seed, args.seconds, False,
                               "cuda", t, control=True)
        row = {"seed": seed, **res["readings"],
               "compared_tokens": checks["compared_tokens"]["value"],
               "correct": res["correct"], "metrics": res["metrics"],
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "card": card}
    for name in ("logit_gap", "mean_gap", "differing_share"):
        lower = max(r.get(name, float("nan")) for r in rows)
        upper = min(r.get(f"control_{name}", float("nan")) for r in rows)
        summary[name] = {"lower": lower, "upper": upper,
                         "ratio": upper / lower if lower else None}
    summary["program_correct"] = [r["correct"] for r in rows]
    summary["control_correct"] = [r.get("control_correct") for r in rows]
    print(json.dumps(summary), flush=True)
    separated = all(summary["program_correct"]) and \
        not any(c is not False for c in summary["control_correct"])
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())
