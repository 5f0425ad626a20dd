"""samd_tpu_torch.parallel against samd_tpu.parallel on the CPU.

The port's side runs in spawned processes over gloo that import no JAX
(``torch_parallel_worker.py``): a world of four runs every mesh case once
(tp 4; dp 2 x tp 2; pp 2 x tp 2; ep 2 x tp 2), and a world of two the
two-process generate.  The reference runs here on conftest's virtual
devices cut to the same shapes (``make_mesh(4, ...)``), with weights
carried across by ``bridge.params_from_jax``.  Mirrors
``tests/test_sharding.py``, ``test_model_families.py::
test_moe_expert_parallel_matches_unsharded`` and ``test_multiprocess.py``.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.config import SamdConfig as JaxSamd
from samd_tpu.drafters import make_drafter as jax_make_drafter
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.engine import SamdEngine as JaxEngine
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.configs import ModelConfig as JaxConfig
from samd_tpu.models.configs import tiny_moe_config
from samd_tpu.models.llama import block_decode_mask as jax_decode_mask
from samd_tpu.models.llama import forward as jax_forward
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from samd_tpu.ops.int4_matmul import int4_matmul_tp as jax_int4_matmul_tp
from samd_tpu.ops.quant import quantize_llama_params as jax_quantize
from samd_tpu.ops.quant import quantize_weight4 as jax_quantize4
from samd_tpu.parallel import check_shardable as jax_check_shardable
from samd_tpu.parallel import kv_spec as jax_kv_spec
from samd_tpu.parallel import make_mesh as jax_make_mesh
from samd_tpu.parallel import param_specs as jax_param_specs
from samd_tpu.parallel import shard_params as jax_shard_params
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.engine import ArBaseline, SamdEngine
from samd_tpu_torch.parallel import param_specs
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
MESHES = {"tp4": {}, "dp2": {"dp": 2}, "pp2": {"pp": 2}, "ep2": {"ep": 2}}


def shardable_config():
    return JaxConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
        max_position_embeddings=512, dtype=jnp.float32)


def int4_config():
    """256-divisible contraction dims and tp-divisible heads, as the
    reference's int4 sharding test; its plain int4 route, against which
    the port's kernel route runs its plain version on the CPU."""
    return JaxConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=8, num_kv_heads=8, head_dim=32,
        max_position_embeddings=512, dtype=jnp.float32)


def to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def jmesh(name):
    return jax_make_mesh(4, **MESHES[name])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_trees():
    cfg, icfg, mcfg = shardable_config(), int4_config(), tiny_moe_config()
    engine = init_params(cfg, jax.random.PRNGKey(1), scale=0.4)
    moe = init_params(mcfg, jax.random.PRNGKey(7))
    return {
        "cfg": cfg, "int4_cfg": icfg, "moe_cfg": mcfg,
        "layout": init_params(cfg, jax.random.PRNGKey(0)),
        "engine": engine,
        "int8": jax_quantize(engine),
        "dp": init_params(cfg, jax.random.PRNGKey(2)),
        "sp": init_params(cfg, jax.random.PRNGKey(5), scale=0.4),
        "int4": jax_quantize(init_params(icfg, jax.random.PRNGKey(0),
                                         scale=0.2), dtype=jnp.int4),
        "moe": {"plain": moe, "int8": jax_quantize(moe),
                "int4": jax_quantize(moe, dtype=jnp.int4)},
        "mh_cfg": tiny_config(vocab_size=128, num_kv_heads=4),
        "mh": init_params(tiny_config(vocab_size=128, num_kv_heads=4),
                          jax.random.PRNGKey(0), scale=0.4),
    }


def refusal_cases(jt):
    cfg, mcfg = jt["cfg"], jt["moe_cfg"]
    return [("ok", cfg, "tp4"),
            ("kv_heads", dataclasses.replace(cfg, num_kv_heads=2), "tp4"),
            ("vocab", dataclasses.replace(cfg, vocab_size=258), "tp4"),
            ("layers", dataclasses.replace(cfg, num_layers=3), "pp2"),
            ("experts", dataclasses.replace(mcfg, num_experts=3), "ep2")]


def shard_cases(jt):
    return {"plain": (jt["cfg"], jt["layout"], "tp4"),
            "plain_pp2": (jt["cfg"], jt["layout"], "pp2"),
            "int8": (jt["cfg"], jt["int8"], "tp4"),
            "int4": (jt["int4_cfg"], jt["int4"], "tp4"),
            "moe_int8": (jt["moe_cfg"], jt["moe"]["int8"], "ep2"),
            "moe_int4": (jt["moe_cfg"], jt["moe"]["int4"], "ep2")}


def case_inputs(jt):
    rng = np.random.default_rng(0)
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 512)).astype(
        jnp.float32)
    qt = jax_quantize4(jax.random.normal(jax.random.PRNGKey(4), (512, 256)))
    stack = [jax_quantize4(jax.random.normal(jax.random.PRNGKey(i),
                                             (512, 256))) for i in range(3)]
    return {
        "x": x, "qt": qt,
        "stack_packed": jnp.stack([s.packed for s in stack]),
        "stack_scale": jnp.stack([s.scale for s in stack]),
        "tp_prompt": np.random.default_rng(0).integers(3, 256, 16).tolist(),
        "pp_prompt": np.random.default_rng(3).integers(3, 256, 16).tolist(),
        "int8_prompt": np.random.default_rng(4).integers(3, 256,
                                                         12).tolist(),
        "dp_tokens": rng.integers(0, 256, (2, 8)).astype(np.int32),
        "sp_prefill_tokens": np.random.default_rng(0).integers(
            3, 256, (1, 32)).astype(np.int32),
        "sp_decode_tokens": np.random.default_rng(1).integers(
            3, 256, (1, 24)).astype(np.int32),
        "int4_tokens": (np.arange(8, dtype=np.int32) % 512)[None],
        "moe_tokens": np.random.default_rng(8).integers(
            0, 256, (1, 11)).astype(np.int32),
        "mh_prompt": [5, 9, 17, 3, 88, 41, 7, 23, 56, 12],
    }


@pytest.fixture(scope="module")
def runs(jax_trees, tmp_path_factory):
    """Both worlds' results, rank by rank."""
    jt = jax_trees
    ci = case_inputs(jt)
    pc = {k: port_config(jt[k]) for k in ("cfg", "int4_cfg", "moe_cfg",
                                          "mh_cfg")}
    pc["int4_cfg"] = dataclasses.replace(pc["int4_cfg"], int4_impl="kernel")
    def t(a):
        return torch.from_numpy(np.array(a))
    inp = {
        "shardable_cfg": pc["cfg"], "int4_cfg": pc["int4_cfg"],
        "moe_cfg": pc["moe_cfg"], "mh_cfg": pc["mh_cfg"],
        "refusal_cases": [(n, port_config(c), m)
                          for n, c, m in refusal_cases(jt)],
        "shard_cases": {k: (port_config(c), to_port(tree), m)
                        for k, (c, tree, m) in shard_cases(jt).items()},
        "engine_params": to_port(jt["engine"]),
        "int8_params": to_port(jt["int8"]),
        "dp_params": to_port(jt["dp"]), "sp_params": to_port(jt["sp"]),
        "int4_params": to_port(jt["int4"]),
        "moe_params": {k: to_port(v) for k, v in jt["moe"].items()},
        "mh_params": to_port(jt["mh"]),
        "tp_x": t(np.asarray(ci["x"])),
        "tp_packed": t(np.asarray(ci["qt"].packed)),
        "tp_scale": t(np.asarray(ci["qt"].scale)),
        "tp_stack_packed": t(np.asarray(ci["stack_packed"])),
        "tp_stack_scale": t(np.asarray(ci["stack_scale"])),
        **{k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in ci.items()
           if k.endswith(("_prompt", "_tokens"))},
    }
    d = tmp_path_factory.mktemp("parallel")
    torch.save(inp, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", "JAX_PLATFORMS"):
        env.pop(k, None)
    procs = []
    for job, world in (("mesh", 4), ("multihost", 2)):
        port = free_port()
        procs += [(job, r, subprocess.Popen(
            [sys.executable, WORKER, job, str(r), str(world), str(port),
             str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    out = {"mesh": {}, "multihost": {}, "inputs": ci}
    for job, r, p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{job} rank {r}:\n{log[-3000:]}"
        out[job][r] = torch.load(d / f"{job}_rank{r}.pt", weights_only=False)
    return out


def jax_shard(arr, device):
    return np.asarray(next(s.data for s in arr.addressable_shards
                           if s.device == device))


def jax_leaf(tree, path):
    keys, _, part = path.partition(".")
    node = tree
    for k in keys.split("/"):
        node = node[k]
    return getattr(node, part) if part else node


def jax_engine(cfg, params, prompt, new, mesh=None):
    samd_cfg = JaxSamd(draft_source="sam_only", max_predicts=8, len_bias=0)
    eng = JaxEngine(cfg, params, samd_cfg,
                    jax_make_drafter(samd_cfg, cfg.vocab_size),
                    max_cache_len=128, eos_token_id=-1,
                    prefill_buckets=(32,), mesh=mesh)
    return eng.generate(prompt, JaxGen(max_new_tokens=new,
                                       max_cache_len=128)).output_ids


def port_engine(cfg, params, prompt, new):
    samd_cfg = SamdConfig(draft_source="sam_only", max_predicts=8,
                          len_bias=0)
    eng = SamdEngine(cfg, params, samd_cfg,
                     make_drafter(samd_cfg, cfg.vocab_size),
                     max_cache_len=128, eos_token_id=-1,
                     prefill_buckets=(32,), device="cpu")
    return eng.generate(prompt, GenerationConfig(max_new_tokens=new,
                                                 max_cache_len=128))


# ----------------------------------------------------------------------
# Meshes and placement
# ----------------------------------------------------------------------

def test_mesh_creation(runs):
    devices = jax.devices()
    for name in MESHES:
        m = jmesh(name)
        for r, res in runs["mesh"].items():
            assert res["shapes"][name] == dict(m.shape)
            at = np.argwhere(m.devices == devices[r])[0]
            assert res["coords"][name] == dict(zip(m.axis_names,
                                                   at.tolist())), (name, r)


def test_check_shardable_refusals(runs, jax_trees):
    for name, cfg, mesh in refusal_cases(jax_trees):
        try:
            jax_check_shardable(cfg, jmesh(name=mesh))
            want = None
        except ValueError as e:
            want = str(e)
        assert (want is None) == (name == "ok")
        for res in runs["mesh"].values():
            assert res["refusals"][name] == want, name


def test_param_specs_match_jax(jax_trees):
    for cfg in (jax_trees["cfg"], jax_trees["moe_cfg"],
                dataclasses.replace(jax_trees["cfg"], attn_bias=True,
                                    tie_embeddings=True)):
        want = jax.tree.map(tuple, jax_param_specs(cfg),
                            is_leaf=lambda x: isinstance(x, P))
        assert param_specs(port_config(cfg)) == want


@pytest.mark.parametrize("case", ["plain", "plain_pp2", "int8", "int4",
                                  "moe_int8", "moe_int4"])
def test_rank_shards_match_jax(runs, jax_trees, case):
    """Every rank's shard of every leaf, bitwise the reference's shard on
    the device of the same index; int4 stays whole over tp (and ep)."""
    cfg, tree, mesh = shard_cases(jax_trees)[case]
    sharded = jax_shard_params(tree, jmesh(mesh), cfg)
    devices = jax.devices()
    for r, res in runs["mesh"].items():
        got = res["shards"][case]
        assert got, case
        for path, t in got.items():
            want = jax_shard(jax_leaf(sharded, path), devices[r])
            assert t.shape == want.shape, (case, path, r)
            np.testing.assert_array_equal(t.numpy(), want,
                                          err_msg=f"{case} {path} {r}")
            if case.endswith("int4") and path.endswith(".packed"):
                assert t.shape == jax_leaf(tree, path).shape


def test_kv_shard_matches_jax(runs, jax_trees):
    cfg = jax_trees["cfg"]
    shape = jax_init_kv(cfg, 2, 32)[0].shape
    kv = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    placed = jax.device_put(kv, NamedSharding(jmesh("dp2"), jax_kv_spec()))
    for r, res in runs["mesh"].items():
        np.testing.assert_array_equal(res["kv_shard"].numpy(),
                                      jax_shard(placed, jax.devices()[r]))


# ----------------------------------------------------------------------
# Engines and forwards
# ----------------------------------------------------------------------

def test_tp_engine_matches_single_device(runs, jax_trees):
    jt, ci = jax_trees, runs["inputs"]
    prompt = ci["tp_prompt"]
    ref = jax_engine(jt["cfg"], jt["engine"], prompt, 24)
    assert jax_engine(jt["cfg"], jt["engine"], prompt, 24,
                      jmesh("tp4")) == ref
    single = port_engine(port_config(jt["cfg"]), to_port(jt["engine"]),
                         prompt, 24)
    assert single.output_ids == ref
    for res in runs["mesh"].values():
        assert res["tp_engine"]["output_ids"] == ref
        assert res["tp_engine"]["decode_tokens"] == single.decode_tokens
        assert res["tp_ar8"] == ref


def test_pp_tp_engine_matches_single_device(runs, jax_trees):
    jt, prompt = jax_trees, runs["inputs"]["pp_prompt"]
    ref = jax_engine(jt["cfg"], jt["engine"], prompt, 16)
    assert jax_engine(jt["cfg"], jt["engine"], prompt, 16,
                      jmesh("pp2")) == ref
    assert port_engine(port_config(jt["cfg"]), to_port(jt["engine"]),
                       prompt, 16).output_ids == ref
    for res in runs["mesh"].values():
        assert res["pp_engine"]["output_ids"] == ref


def test_dp_tp_batched_forward(runs, jax_trees):
    cfg = jax_trees["cfg"]
    toks = jnp.asarray(runs["inputs"]["dp_tokens"])
    B, T = toks.shape
    S = 32
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    ref = jax_forward(jax_trees["dp"], cfg, toks, pos,
                      *jax_init_kv(cfg, B, S), jnp.int32(0),
                      jax_prefill_mask(B, T, S))[0]
    first = runs["mesh"][0]["dp_logits"]
    assert first.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(first.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    for res in runs["mesh"].values():
        assert torch.equal(res["dp_logits"], first)


def test_sequence_parallel_prefill(runs, jax_trees):
    """The port's sequence-parallel prefill stands in for the reference's
    GSPMD sequence-sharded prefill: both within float tolerance of the
    unsharded prefill, argmax equal."""
    cfg, params = jax_trees["cfg"], jax_trees["sp"]
    toks = jnp.asarray(runs["inputs"]["sp_prefill_tokens"])
    B, T = toks.shape
    S = 64
    pos, mask = jnp.arange(T)[None], jax_prefill_mask(B, T, S)
    ref = np.asarray(jax_forward(params, cfg, toks, pos,
                                 *jax_init_kv(cfg, B, S), jnp.int32(0),
                                 mask)[0])
    mesh = jmesh("tp4")
    gspmd = np.asarray(jax.jit(jax_forward, static_argnums=1)(
        jax_shard_params(params, mesh, cfg), cfg,
        jax.device_put(toks, NamedSharding(mesh, P(None, "tp"))),
        jax.device_put(pos, NamedSharding(mesh, P(None, "tp"))),
        *jax_init_kv(cfg, B, S), jnp.int32(0),
        jax.device_put(mask, NamedSharding(mesh, P(None, "tp", None))))[0])
    for res in runs["mesh"].values():
        got = res["sp_prefill"]["logits"].numpy()
        for want in (ref, gspmd):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
            assert (got.argmax(-1) == want.argmax(-1)).all()


def test_sequence_parallel_decode(runs, jax_trees):
    """KV sharded along S over four ranks (S_local 16 < the 24-token
    prompt): 8 greedy steps equal the unsharded forward's tokens."""
    cfg, params = jax_trees["cfg"], jax_trees["sp"]
    toks = jnp.asarray(runs["inputs"]["sp_decode_tokens"])
    B, T0 = toks.shape
    S = 64
    kv_k, kv_v = jax_init_kv(cfg, B, S)
    fwd = jax.jit(jax_forward, static_argnums=1)
    ref_logits, _, kv_k, kv_v = fwd(params, cfg, toks, jnp.arange(T0)[None],
                                    kv_k, kv_v, jnp.int32(0),
                                    jax_prefill_mask(B, T0, S))
    tokens = [int(ref_logits[0, T0 - 1].argmax())]
    chain = jnp.ones((1, 1), bool)
    for step in range(8):
        cl = T0 + step
        lo, _, kv_k, kv_v = fwd(
            params, cfg, jnp.asarray([[tokens[-1]]], jnp.int32),
            jnp.asarray([[cl]], jnp.int32), kv_k, kv_v, jnp.int32(cl),
            jax_decode_mask(chain, jnp.int32(cl), S))
        tokens.append(int(lo[0, 0].argmax()))
    for res in runs["mesh"].values():
        assert res["sp_decode"]["tokens"] == tokens
        np.testing.assert_allclose(res["sp_decode"]["logits"].numpy(),
                                   np.asarray(ref_logits), rtol=1e-3,
                                   atol=1e-4)


def test_int4_kernel_forward_under_tp_mesh_matches_unsharded(runs,
                                                              jax_trees):
    cfg = jax_trees["int4_cfg"]
    toks = jnp.asarray(runs["inputs"]["int4_tokens"])
    T, S = toks.shape[1], 32
    ref = np.asarray(jax_forward(
        jax_trees["int4"], cfg, toks, jnp.arange(T, dtype=jnp.int32)[None],
        *jax_init_kv(cfg, 1, S), jnp.int32(0), jax_prefill_mask(1, T, S))[0])
    for res in runs["mesh"].values():
        got = res["int4_logits"].numpy()
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
        assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_int4_mlp_under_tp_runs_whole_without_collectives(runs, jax_trees):
    """Packed int4 lies whole on every rank, so its MLP runs whole there
    with no collective, as GSPMD inserts none for a replicated MLP; the
    attention gathers its heads' context once before wo, and a sharded
    embedding and head add one each."""
    tree, cfg = jax_trees["int4"], jax_trees["int4_cfg"]

    def int4(leaf):
        return type(leaf).__name__ == "Int4Tensor"

    assert all(int4(tree["layers"][n])
               for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down"))
    head = tree["embed"] if cfg.tie_embeddings else tree["lm_head"]
    want = cfg.num_layers + (not int4(tree["embed"])) + (not int4(head))
    for res in runs["mesh"].values():
        assert res["int4_collectives"] == want


def test_int4_matmul_tp_shard_map_matches_dense(runs):
    """The port's tensor-parallel product (each rank's slab product,
    gathered into the global column order) against the reference's
    shard_map form and its whole-weight kernel (interpret mode); the
    rank's slab product alone is its low and high blocks of the global
    result."""
    ci = runs["inputs"]
    mesh = jmesh("tp4")
    x, qt = ci["x"], ci["qt"]
    cases = {"2d": (qt.packed, qt.scale, None),
             "stacked0": (ci["stack_packed"], ci["stack_scale"], 0),
             "stacked2": (ci["stack_packed"], ci["stack_scale"], 2)}
    for tag, (packed, scale, layer) in cases.items():
        lay = () if layer is None else (jnp.int32(layer),)
        want = np.asarray(jax.jit(
            lambda x, p, s, *l: jax_int4_matmul_tp(mesh, x, p, s, *l,
                                                   interpret=True)
        )(x, packed, scale, *lay))
        dense = np.asarray(jax_int4_matmul(x, packed, scale, *lay,
                                           interpret=True))
        OUTH = packed.shape[-1]
        c = OUTH // 4
        for r, res in runs["mesh"].items():
            own, gathered = (t.numpy() for t in res["int4_tp"][tag])
            np.testing.assert_allclose(gathered, want, atol=2e-4, rtol=2e-4)
            np.testing.assert_allclose(gathered, dense, atol=2e-4,
                                       rtol=2e-4)
            np.testing.assert_array_equal(
                own, np.concatenate([gathered[:, r * c:(r + 1) * c],
                                     gathered[:, OUTH + r * c:
                                              OUTH + (r + 1) * c]], -1))


def test_int8_quantized_params_shard_under_tp(runs, jax_trees):
    jt, prompt = jax_trees, runs["inputs"]["int8_prompt"]
    ref = jax_engine(jt["cfg"], jt["int8"], prompt, 16)
    assert jax_engine(jt["cfg"], jt["int8"], prompt, 16, jmesh("tp4")) == ref
    for res in runs["mesh"].values():
        assert res["int8_engine"]["output_ids"] == ref


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_moe_expert_parallel_matches_unsharded(runs, jax_trees, kind):
    cfg = jax_trees["moe_cfg"]
    toks = jnp.asarray(runs["inputs"]["moe_tokens"])
    T, S = toks.shape[1], 32
    ref = np.asarray(jax_forward(
        jax_trees["moe"][kind], cfg, toks, jnp.arange(T)[None],
        *jax_init_kv(cfg, 1, S), jnp.int32(0), jax_prefill_mask(1, T, S))[0])
    for res in runs["mesh"].values():
        np.testing.assert_allclose(res["moe_logits"][kind].numpy(), ref,
                                   rtol=2e-4, atol=2e-4)


def test_int8_kv_under_a_mesh_is_refused(jax_trees):
    """The reference asserts; the port raises before it touches the
    mesh."""
    cfg = dataclasses.replace(port_config(jax_trees["cfg"]), kv_quant=True)
    with pytest.raises(ValueError, match="int8 KV under a mesh"):
        ArBaseline(cfg, to_port(jax_trees["engine"]), device="cpu",
                   mesh=object())


# ----------------------------------------------------------------------
# Two processes
# ----------------------------------------------------------------------

def test_two_process_distributed_generate_matches(runs, jax_trees):
    """Two processes joined by ``init_distributed`` shard the tiny model tp
    2 across the process boundary and byte-match one process, the port's
    and the reference's; ``shard_requests`` splits by rank."""
    cfg = port_config(jax_trees["mh_cfg"])
    prompt = runs["inputs"]["mh_prompt"]
    gen = GenerationConfig(max_new_tokens=16, max_cache_len=64)
    one = ArBaseline(cfg, to_port(jax_trees["mh"]), max_cache_len=64,
                     eos_token_id=-1, prefill_buckets=(16,),
                     device="cpu").generate(prompt, gen).output_ids
    ref = JaxAr(jax_trees["mh_cfg"], jax_trees["mh"], max_cache_len=64,
                eos_token_id=-1, prefill_buckets=(16,)).generate(
        prompt, JaxGen(max_new_tokens=16, max_cache_len=64)).output_ids
    assert one == ref
    for r, res in runs["multihost"].items():
        assert res["shape"] == {"dp": 1, "pp": 1, "ep": 1, "tp": 2}
        assert res["output_ids"] == one
        assert res["requests"] == ([0, 2, 4] if r == 0 else [1, 3])


def test_children_import_no_jax(runs):
    for job in ("mesh", "multihost"):
        for r, res in runs[job].items():
            assert res["jax_imported"] == [], (job, r)
