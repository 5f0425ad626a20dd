"""Time the int4 weight-streaming matmul (K3) at llama_7b's shapes with two
timers, for this checkout or another one.

    python3 samd_tpu_torch/tools/time_int4.py [--root DIR] [--label NAME]

Imports ``samd_tpu_torch`` from DIR (default: the checkout holding this
script), so one call can time two checkouts' kernels in turns with the same
timers.  At each projection and head shape of llama_7b (4096→4096,
4096→11008, 11008→4096; the head 4096→32000 with f32 out) and R = 16, 128,
192 and 256 bf16 rows, it times K3 and, as a yardstick, one bf16
``torch.matmul`` on the weight dequantized beforehand:

- ``event_ms``: CUDA events around 50 calls, the stream held by a sleep
  kernel while the host enqueues them (the timer behind every time
  ``chip_smoke.py`` prints);
- ``device_ms``: the device time of every kernel those calls ran, summed
  from ``torch.profiler`` (CUPTI) over 20 calls, per call.

The weights cycle over enough stacked layers to exceed the L2 cache, as a
forward finds each weight cold.  Prints a line per shape and one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = (("wq/wk/wv/wo", 4096, 4096, "bfloat16"),
          ("w_gate/w_up", 4096, 11008, "bfloat16"),
          ("w_down", 11008, 4096, "bfloat16"),
          ("lm_head", 4096, 32000, "float32"))
ROWS = (16, 128, 192, 256)
L2_BYTES = 50 << 20                       # H100 L2 cache
SLEEP_CYCLES = 100_000_000                # ~50 ms at the H100's clocks


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms of ``fn(i)`` between two CUDA events, the stream held by a
    sleep kernel while the host enqueues the calls."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 20, warmup: int = 5):
    """(device ms per call of the kernels ``fn(i)`` ran, kernels per call),
    from the profiler's CUDA kernel records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / iters / 1e3, len(kernels) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose samd_tpu_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("time_int4: no CUDA device is available", file=sys.stderr)
        return 1
    from samd_tpu_torch.ops.int4_matmul import int4_matmul
    from samd_tpu_torch.ops.quant import Int4Tensor, dequant

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name, IN, OUT, out_name in SHAPES:
        out_dtype = getattr(torch, out_name)
        L = max(2, math.ceil(2 * L2_BYTES / (IN * OUT // 2)))
        packed = torch.randint(0, 256, (L, IN, OUT // 2), generator=gen,
                               dtype=torch.uint8, device="cuda")
        scale = torch.rand((L, OUT), generator=gen, device="cuda") * 4e-3 \
            + 1e-3
        w16 = [dequant(Int4Tensor(packed[l], scale[l]), torch.bfloat16)
               for l in range(L)]
        for R in ROWS:
            x = torch.randn((R, IN), generator=gen, device="cuda").to(
                torch.bfloat16)

            def k3(i):
                return int4_matmul(x, packed, scale, i % L,
                                   out_dtype=out_dtype)

            def library(i):
                return torch.matmul(x, w16[i % L])

            k3_dev, k3_n = device_ms(k3)
            lib_dev, lib_n = device_ms(library)
            row = {"shape": name, "in": IN, "out": OUT, "R": R,
                   "k3_event_ms": event_ms(k3), "k3_device_ms": k3_dev,
                   "k3_kernels_per_call": k3_n,
                   "library_event_ms": event_ms(library),
                   "library_device_ms": lib_dev,
                   "library_kernels_per_call": lib_n}
            rows.append(row)
            print(f"{args.label} {name} R={R}: K3 event "
                  f"{row['k3_event_ms']:.4f} device {k3_dev:.4f} ms "
                  f"({k3_n:g} kernels/call); library "
                  f"event {row['library_event_ms']:.4f} device {lib_dev:.4f} "
                  f"ms [{card}]", flush=True)
        del packed, scale, w16
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": str(root), "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
