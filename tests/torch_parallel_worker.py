"""One rank of the port's multi-device runs on the CPU, over gloo.

    python tests/torch_parallel_worker.py JOB RANK WORLD PORT DIR

Run by ``tests/test_torch_parallel.py`` as WORLD spawned processes.  Each
reads ``DIR/inputs.pt`` (the port's parameter trees, carried from JAX by
``bridge.params_from_jax`` in the parent, and the cases' inputs), joins
the world through ``parallel.multihost.init_distributed(backend="gloo")``,
runs JOB's cases on its rank, and writes what it computed to
``DIR/JOB_rankRANK.pt``.  It imports ``samd_tpu_torch`` only, never JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from samd_tpu_torch.cache import init_kv_cache  # noqa: E402
from samd_tpu_torch.config import GenerationConfig, SamdConfig  # noqa: E402
from samd_tpu_torch.drafters import make_drafter  # noqa: E402
from samd_tpu_torch.engine import ArBaseline, SamdEngine  # noqa: E402
from samd_tpu_torch.models.llama import (block_decode_mask,  # noqa: E402
                                         forward, prefill_mask)
from samd_tpu_torch.ops.int4_matmul import (int4_matmul,  # noqa: E402
                                            int4_matmul_tp, int4_tp_slab)
from samd_tpu_torch.parallel import (check_shardable, make_mesh,  # noqa: E402
                                     shard_kv, shard_params)
from samd_tpu_torch.parallel.multihost import (global_mesh,  # noqa: E402
                                               init_distributed,
                                               shard_requests)
from samd_tpu_torch.parallel.seq_parallel import (  # noqa: E402
    make_sp_forward, shard_kv_seq)

CPU = "cpu"


def leaves(tree, prefix=""):
    """(path, tensor) for every tensor of a parameter tree, a quantized
    leaf's parts as ``path.q``/``path.packed`` and ``path.scale``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        for part in ("q", "packed", "scale"):
            if hasattr(tree, part):
                yield f"{prefix[:-1]}.{part}", getattr(tree, part)


def engine_run(inp, params, mesh, prompt, new):
    cfg = inp["shardable_cfg"]
    samd_cfg = SamdConfig(draft_source="sam_only", max_predicts=8,
                          len_bias=0)
    eng = SamdEngine(cfg, params, samd_cfg,
                     make_drafter(samd_cfg, cfg.vocab_size),
                     max_cache_len=128, eos_token_id=-1,
                     prefill_buckets=(32,), device=CPU, mesh=mesh)
    out = eng.generate(prompt, GenerationConfig(max_new_tokens=new,
                                                max_cache_len=128))
    return {"output_ids": out.output_ids, "decode_tokens": out.decode_tokens}


def job_mesh(inp):
    """The cases of the world of four; every rank builds the same meshes
    in the same order."""
    res = {}
    meshes = {"tp4": make_mesh(4, device=CPU),
              "dp2": make_mesh(4, dp=2, device=CPU),
              "pp2": make_mesh(4, dp=1, pp=2, device=CPU),
              "ep2": make_mesh(4, ep=2, device=CPU)}
    res["shapes"] = {k: dict(m.shape) for k, m in meshes.items()}
    res["coords"] = {k: dict(m.coords) for k, m in meshes.items()}
    refusals = {}
    for name, cfg, mesh in inp["refusal_cases"]:
        try:
            check_shardable(cfg, meshes[mesh])
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    res["refusals"] = refusals

    # rank shards of plain, int8 and int4 leaves
    res["shards"] = {}
    for tag, (cfg, tree, mesh) in inp["shard_cases"].items():
        local = shard_params(tree, meshes[mesh], cfg)
        res["shards"][tag] = dict(leaves(local))
    kcfg = inp["shardable_cfg"]
    kv_k, kv_v = init_kv_cache(kcfg, 2, 32, CPU)
    kv_k.copy_(torch.arange(kv_k.numel(), dtype=torch.float32).reshape(
        kv_k.shape))
    res["kv_shard"] = shard_kv(kv_k, kv_v, meshes["dp2"])[0]

    # engines: tp 4, pp 2 x tp 2, int8 under tp 4
    res["tp_engine"] = engine_run(inp, inp["engine_params"], meshes["tp4"],
                                  inp["tp_prompt"], 24)
    res["pp_engine"] = engine_run(inp, inp["engine_params"], meshes["pp2"],
                                  inp["pp_prompt"], 16)
    res["int8_engine"] = engine_run(inp, inp["int8_params"], meshes["tp4"],
                                    inp["int8_prompt"], 16)
    ar = ArBaseline(kcfg, inp["engine_params"], max_cache_len=128,
                    eos_token_id=-1, prefill_buckets=(32,), block_size=8,
                    device=CPU, mesh=meshes["tp4"])
    res["tp_ar8"] = ar.generate(inp["tp_prompt"], GenerationConfig(
        max_new_tokens=24, max_cache_len=128)).output_ids

    # dp 2 x tp 2 batched forward
    mesh = meshes["dp2"]
    params = shard_params(inp["dp_params"], mesh, kcfg)
    toks = inp["dp_tokens"]
    B, T = toks.shape
    S = 32
    kv_k, kv_v = shard_kv(*init_kv_cache(kcfg, B, S, CPU), mesh)
    pos = torch.arange(T)[None].expand(B, T)
    res["dp_logits"] = forward(params, kcfg, toks, pos, kv_k, kv_v, 0,
                               prefill_mask(B, T, S), mesh=mesh)[0]

    # sequence parallel: a prefill straddling the shards, then greedy steps
    mesh = meshes["tp4"]
    sp = make_sp_forward(kcfg, mesh)
    sp_params = inp["sp_params"]
    for tag, toks, S, steps in (("sp_prefill", inp["sp_prefill_tokens"], 64,
                                 0),
                                ("sp_decode", inp["sp_decode_tokens"], 64,
                                 8)):
        B, T0 = toks.shape
        kv_k, kv_v = shard_kv_seq(*init_kv_cache(kcfg, B, S, CPU), mesh)
        logits, _, kv_k, kv_v = sp(sp_params, toks, torch.arange(T0)[None],
                                   kv_k, kv_v, 0, prefill_mask(B, T0, S))
        tokens = [int(logits[0, T0 - 1].argmax())]
        chain = torch.ones((1, 1), dtype=torch.bool)
        for step in range(steps):
            cl = T0 + step
            lo, _, kv_k, kv_v = sp(
                sp_params, torch.tensor([[tokens[-1]]]),
                torch.tensor([[cl]]), kv_k, kv_v, cl,
                block_decode_mask(chain, cl, S))
            tokens.append(int(lo[0, 0].argmax()))
        res[tag] = {"logits": logits, "tokens": tokens}

    # packed int4 under tp 4: whole weights on every rank
    icfg = inp["int4_cfg"]
    params = shard_params(inp["int4_params"], mesh, icfg)
    toks = inp["int4_tokens"]
    T = toks.shape[1]
    kv_k, kv_v = shard_kv(*init_kv_cache(icfg, 1, 32, CPU), mesh)
    calls = mesh.stats.calls
    res["int4_logits"] = forward(params, icfg, toks, torch.arange(T)[None],
                                 kv_k, kv_v, 0, prefill_mask(1, T, 32),
                                 mesh=mesh)[0]
    res["int4_collectives"] = mesh.stats.calls - calls

    # int4_matmul_tp: 2-D, then stacked at layers 0 and 2
    x = inp["tp_x"]
    out = {}
    for tag, packed, scale, layer in (
            ("2d", inp["tp_packed"], inp["tp_scale"], None),
            ("stacked0", inp["tp_stack_packed"], inp["tp_stack_scale"], 0),
            ("stacked2", inp["tp_stack_packed"], inp["tp_stack_scale"], 2)):
        own = int4_tp_slab(mesh, *((packed, scale) if layer is None
                                   else (packed[layer], scale[layer])))
        out[tag] = (int4_matmul(x, *own),
                    int4_matmul_tp(mesh, x, packed, scale, layer))
    res["int4_tp"] = out

    # MoE: ep 2 x tp 2, plain, int8 and int4 expert stacks
    mcfg = inp["moe_cfg"]
    mesh = meshes["ep2"]
    check_shardable(mcfg, mesh)
    toks = inp["moe_tokens"]
    T, S = toks.shape[1], 32
    moe = {}
    for tag, tree in inp["moe_params"].items():
        kv_k, kv_v = shard_kv(*init_kv_cache(mcfg, 1, S, CPU), mesh)
        moe[tag] = forward(shard_params(tree, mesh, mcfg), mcfg, toks,
                           torch.arange(T)[None], kv_k, kv_v, 0,
                           prefill_mask(1, T, S), mesh=mesh)[0]
    res["moe_logits"] = moe
    return res


def job_multihost(inp):
    """The two-process generate: one tensor-parallel engine across both
    processes, and the request list split between them."""
    mesh = global_mesh(1, device=CPU)
    cfg = inp["mh_cfg"]
    ar = ArBaseline(cfg, inp["mh_params"], max_cache_len=64,
                    eos_token_id=-1, prefill_buckets=(16,), device=CPU,
                    mesh=mesh)
    out = ar.generate(inp["mh_prompt"], GenerationConfig(max_new_tokens=16,
                                                         max_cache_len=64))
    return {"shape": dict(mesh.shape), "output_ids": out.output_ids,
            "requests": shard_requests(list(range(5)))}


def main():
    job, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    with torch.no_grad():
        res = {"mesh": job_mesh, "multihost": job_multihost}[job](inp)
    res["jax_imported"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "samd_tpu"))
    torch.save(res, os.path.join(d, f"{job}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
