"""The serving paths of a checkout's ``chip_smoke.py`` (phases 4-8), timed
on one card, to set two trees side by side in one call.

    python3 samd_tpu_torch/tools/path_times.py --root DIR [--out FILE]

Imports ``DIR/chip_smoke.py`` and ``DIR``'s ``samd_tpu_torch`` (run it as a
file, not with ``-m``, so that no other tree's package is imported first),
builds that tree's kernels and runs its phases 4 (llama_1b), 5 (llama_7b
int4, int8 KV), 6 (the paged B = 12 engine), 8 (the server; it needs 6's
requests) and 7 (llama_1b at B = 4), with every check they hold.  Each
phase prints its own lines (ms/step, tok/s, launches); the last line is
one JSON object: the card, each phase's wall seconds and the tree's
detail numbers (``chip_smoke.DETAIL``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    if "samd_tpu_torch" in sys.modules:
        raise RuntimeError("samd_tpu_torch was imported before --root")
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from samd_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.nvidia_smi()
    _build.build_all()
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        print(f"wall: {name} {walls[name]:.1f} s", flush=True)
        return out

    timed("phase 4", smoke.main_path_1b, card)
    cfg7, params7 = smoke.llama_7b_int4_params()
    timed("phase 5", smoke.main_path_7b, card, cfg7, params7)
    _, requests, oracle = timed("phase 6", smoke.main_path_7b_paged, card,
                                cfg7, params7)
    timed("phase 8", smoke.main_path_server, card, cfg7, params7, requests,
          oracle)
    del params7
    timed("phase 7", smoke.main_path_1b_batched, card)
    line = json.dumps({"root": root, "card": card, "walls_s": walls,
                       "detail": smoke.DETAIL}, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
