"""One run of one cell: set-up, the closed-loop window, the metrics, the
comparison that decides ``correct``, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (``setup_s``): build the port's kernels (served from
``samd_tpu_torch/csrc/build/`` after the first run in a checkout), draw the
configuration's weights on the device from the seed by its weight route,
build the engine, fill the corpus, and warm exactly the prefill buckets the
mix can send and the one ``[B, M]`` greedy step graph.  Then the window:
``clients`` closed-loop clients over ``server.Scheduler``.  With
``--trace 1`` the same window runs with spans around the engine's segments
and prefills and a device trace of a sub-window, and the line carries the
cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from .draws import stream_seed
from .e2e import measure
from .judge import judge
from .load import ClosedLoop, clock
from .registry import Registry
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "samd_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``samd_tpu_torch`` is not ``samd_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def model_config(cfg: Dict):
    """The port's ModelConfig of a config file, held to the port's preset
    of the same published model."""
    import torch

    from samd_tpu_torch import models
    from samd_tpu_torch.models.configs import from_hf_config

    mc = from_hf_config(cfg, dtype=torch.bfloat16)
    preset = cfg.get("port_preset")
    if preset is not None and mc != getattr(models, preset)():
        raise ValueError(f"{cfg['name']}: the file's sizes are not the "
                         f"port's {preset}()")
    return mc


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens past the largest bucket")


def warm(engine, traffic: Traffic, serving: Dict, seed: int, vocab: int):
    """One prefill in each bucket the mix can send (budget 1) and, in the
    smallest, one request long enough to capture the [B, M] step graph."""
    from samd_tpu_torch.config import GenerationConfig

    used = sorted({bucket(n, serving["prefill_buckets"])
                   for n in traffic.prompt_lengths()})
    rng = np.random.default_rng(stream_seed(seed, "warm"))
    block = serving["n_predicts"] + 1
    for i, b in enumerate(used):
        engine.add_request(rng.integers(0, vocab, size=b).tolist(),
                           GenerationConfig(max_new_tokens=block + 1
                                            if i == 0 else 1))
    engine.run()


def served_corpus(reg: Registry, cfg: Dict, traffic: Traffic, model_cfg,
                  params, device):
    """Each stored prompt (a document and its most asked question) served
    once through the cell's engine settings, its continuation stored after
    it in the corpus."""
    from samd_tpu_torch.config import GenerationConfig

    serving = cfg["serving"]
    eng = reg.module("engines", serving["engine"]).build(
        model_cfg, params, serving, None, device)
    n = int(traffic.mix["corpus"]["continuation"])
    prompts = traffic.stored_prompts()
    rids = [eng.add_request(d, GenerationConfig(max_new_tokens=n))
            for d in prompts]
    outs = eng.run()
    conts = [list(outs[r].output_ids[len(d):]) for r, d in
             zip(rids, prompts)]
    del eng, outs
    gc.collect()
    return traffic.document_corpus(conts)


def run_cell(reg: Registry, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, control: bool = False
             ) -> Tuple[Dict, Dict]:
    """Everything of a run but the look for a chip; returns the result
    line's dict and the checks.  ``control`` also reads the control's gap
    numbers, and whether they pass the cell's limits
    (``benchmark/control.py``), into the result's ``readings``; they
    decide nothing of the run's ``correct``."""
    import torch

    from samd_tpu_torch.config import GenerationConfig
    from samd_tpu_torch.server import Scheduler

    from ..roofline.work import Shapes
    from .spans import Tracer, instrument
    from .trace import summarize
    from .view import LayerView

    cell = reg.workload(workload)
    cfg = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    checks_doc = reg.cell(workload)
    serving = cfg["serving"]
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        from samd_tpu_torch.ops import _build

        _build.build_all()
    model_cfg = model_config(cfg)
    params = reg.module("weights", cfg["weights"]["route"]).build(
        cfg, model_cfg, seed, device)
    traffic = Traffic(mix, seed, model_cfg.vocab_size, cell["traffic"])
    if traffic.corpus_kind() == "random":
        corpus = traffic.random_corpus()
    else:
        corpus = served_corpus(reg, cfg, traffic, model_cfg, params, device)
    engine = reg.module("engines", serving["engine"]).build(
        model_cfg, params, serving, corpus, device)
    warm(engine, traffic, serving, seed, model_cfg.vocab_size)
    tracer = spans = None
    if trace:
        tracer = Tracer(start_at=float("inf"),
                        seconds=checks_doc["trace_seconds"])
        spans = instrument(engine, tracer)
    scheduler = Scheduler(engine)
    loop = ClosedLoop(scheduler, traffic.requests(), traffic.clients,
                      lambda r: GenerationConfig(max_new_tokens=r.max_new))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = clock()
    setup_s = t_window - t_start
    if tracer is not None:
        tracer.start_at = t_window + checks_doc["trace_start"] * seconds
    loop.run(seconds, tracer)
    summary = None
    if tracer is not None and tracer.t_start is not None:
        # a trace still open at the close ran past the window: no reading
        closed_in_window = tracer.t_stop is not None
        tracer.stop()
        if closed_in_window:
            summary = summarize(tracer, spans)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    records, t0, t_end = loop.records, loop.t0, loop.t_end
    if trace:
        view = LayerView(
            shapes=Shapes.of(cfg), B=serving["batch_size"],
            M=serving["n_predicts"] + 1, page=serving["page_size"],
            table_cols=engine._tables_t.shape[1],
            segments=[s for s in spans.segments
                      if s.t0 >= t0 and s.t1 <= t_end],
            prefills=[p for p in spans.prefills
                      if p.t0 >= t0 and p.t1 <= t_end],
            trace=summary)
        values = {m["name"]: reg.module("metrics", m["name"]).read(view)
                  for m in reg.per_layer(workload)}
        units = {m["name"]: m["unit"] for m in reg.per_layer(workload)}
    else:
        e2e = reg.end_to_end(workload)
        values = measure([m["name"] for m in e2e], records, t0, t_end,
                         setup_s)
        units = {m["name"]: m["unit"] for m in e2e}
    # the program's state goes before the reference runs (the spans'
    # wrappers and the profile hold the engine)
    del engine, scheduler, params, loop, spans, tracer
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = reg.module("reference", cfg["reference"]).Reference(
        cfg, seed, device, control=control)
    correct, checks, readings = judge(records, ref, checks_doc, seed)
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(r.error is not None for r in records),
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in values.items() if v is not None},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda
                   else "cpu", "count": cell["chips"],
                   "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    if control:
        result["readings"] = readings
    result["checks"] = checks
    return result, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = clock() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    reg = Registry()
    cell = reg.workload(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    card = power_line()
    result, checks = run_cell(reg, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["power"] = card
    if "breakdown" in result:
        out = os.path.join(reg.pkg_dir, "out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"trace-{args.workload}-{args.seed}"
                               ".json"), "w") as fh:
            json.dump({"device": result["device"],
                       "metrics": result["metrics"],
                       "breakdown": result["breakdown"]}, fh, indent=1)
    result["checks"] = result.pop("checks")
    print(json.dumps(result), flush=True)
    print(f"card: {card}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    return 0
