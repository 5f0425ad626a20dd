"""samd_tpu_torch's Mixtral MoE MLP against samd_tpu's, at tiny_moe_config.

The forward (a 17-token prefill, then a tree block at an offset) on shared
weights, logits within 1e-4 in f32, and the experts each package selects
from its own router input per token and layer equal exactly; the int8,
fp8 and int4 MoE trees bytewise equal to JAX's ``quantize_llama_params``,
and the quantized forwards alike; ``FusedSamEngine`` and the SAM[Token
Recycle] hybrid in bf16, token for token with JAX's; a Mixtral directory
loaded as JAX's ``convert_state_dict`` loads it and, against HF's
``MixtralForCausalLM``, within 2e-4; ``from_hf_config``, the checkpoint
round trip, ``random_model("moe")``, ``cli --family moe`` and a Mixtral
directory through ``cli --model`` and ``server --model``.  Mirrors
``tests/test_model_families.py``; its
``test_moe_expert_parallel_matches_unsharded`` waits for the port's
multi-device item (ROADMAP queue 1 item 16)."""

import dataclasses
import io
import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401 (JAX's bf16 and fp8 numpy types)
import numpy as np
import pytest
import torch

import samd_tpu.models.llama as jax_llama
import samd_tpu_torch.models.llama as t_llama
from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.fused_hybrid import FusedHybridConfig as JaxHy
from samd_tpu.fused_hybrid import FusedHybridEngine as JaxHybrid
from samd_tpu.fused_sam import FusedSamConfig as JaxFsc
from samd_tpu.fused_sam import FusedSamEngine as JaxFused
from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config, tiny_moe_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.models.loader import convert_state_dict as jax_convert
from samd_tpu.ops.quant import quantize_llama_params as jax_quant
from samd_tpu.sam.trees import ancestor_closure, node_depths
from samd_tpu_torch import cli
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import init_kv_cache
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.fused_hybrid import FusedHybridConfig, FusedHybridEngine
from samd_tpu_torch.fused_sam import FusedSamConfig, FusedSamEngine
from samd_tpu_torch.models import block_decode_mask, forward, prefill_mask
from samd_tpu_torch.models.checkpoint import load_params, save_params
from samd_tpu_torch.models.configs import from_hf_config
from samd_tpu_torch.models.loader import load_llama, random_config
from samd_tpu_torch.ops.quant import INT4, quantize_llama_params, tensors
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config
from torch_mixtral_dir import HF_MIXTRAL, mixtral_state, write_mixtral

S = 64
JAX_QUANT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "int4": jnp.int4}
T_QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": INT4}


def pair(seed=0, scale=0.4, dtype=jnp.float32, make=tiny_moe_config, **kw):
    """(JAX config, JAX params, port config, bridged port params)."""
    jcfg = dataclasses.replace(make(dtype=dtype), **kw)
    jp = init_params(jcfg, jax.random.PRNGKey(seed), scale=scale)
    return jcfg, jp, port_config(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def moe():
    return pair()


def jax_topk(x, router, k):
    """JAX's selection from its router input: the reference's routing
    (``samd_tpu/models/llama.py:160-163``), the indices of the top k."""
    probs = jax.nn.softmax(jnp.einsum(
        "bth,he->bte", jnp.asarray(x, jnp.float32),
        jnp.asarray(router, jnp.float32)), axis=-1)
    return np.sort(np.asarray(jax.lax.top_k(probs, k)[1]), axis=-1)


def port_topk(x, router, k):
    wts = t_llama.moe_route(torch.from_numpy(np.array(x)),
                            torch.from_numpy(np.array(router)), k)
    idx = torch.nonzero(wts > 0)[:, -1].reshape(*wts.shape[:-1], k)
    return idx.numpy()


def run_forwards(jcfg, jp, tcfg, tp, monkeypatch):
    """A 17-token prefill, then an 8-node tree block at offset 17, through
    both packages; returns each side's logits and router inputs per
    forward and layer."""
    jx, tx = [], []
    orig_moe, orig_route = jax_llama._moe_mlp, t_llama.moe_route

    def jax_spy(x, lp, cfg):
        jax.debug.callback(lambda a: jx.append(np.array(a)), x, ordered=True)
        return orig_moe(x, lp, cfg)

    def port_spy(x, router, k):
        tx.append(x.numpy().copy())
        return orig_route(x, router, k)

    monkeypatch.setattr(jax_llama, "_moe_mlp", jax_spy)
    monkeypatch.setattr(t_llama, "moe_route", port_spy)
    rng = np.random.default_rng(0)
    T, M = 17, 8
    tokens = rng.integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)[None]
    jk, jv = jax_init_kv(jcfg, 1, S)
    tk, tv = init_kv_cache(tcfg, 1, S, "cpu")
    jl1, _, jk, jv = jax_forward(jp, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos), jk, jv, jnp.int32(0),
                                 jax_prefill_mask(1, T, S))
    tl1, _ = forward(tp, tcfg, torch.from_numpy(tokens),
                     torch.from_numpy(pos), tk, tv, 0, prefill_mask(1, T, S))
    parents = np.array([-1] + [rng.integers(0, i) for i in range(1, M)],
                       np.int32)
    tree = ancestor_closure(parents)
    vpos = (node_depths(parents) + T).astype(np.int32)[None]
    vtok = rng.integers(0, jcfg.vocab_size, (1, M)).astype(np.int32)
    jl2, _, _, _ = jax_forward(
        jp, jcfg, jnp.asarray(vtok), jnp.asarray(vpos), jk, jv,
        jnp.int32(T), jax_block_mask(jnp.asarray(tree), jnp.int32(T), S))
    tl2, _ = forward(tp, tcfg, torch.from_numpy(vtok),
                     torch.from_numpy(vpos), tk, tv,
                     torch.tensor(T, dtype=torch.int32),
                     block_decode_mask(torch.from_numpy(tree), T, S))
    jax.effects_barrier()
    return (jl1, jl2), (tl1, tl2), jx, tx


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_moe_forward_and_selection_match_jax(moe, impl, monkeypatch):
    jcfg, jp, tcfg, tp = moe
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    jls, tls, jx, tx = run_forwards(jcfg, jp, tcfg, tp, monkeypatch)
    for jl, tl in zip(jls, tls):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    L, k = jcfg.num_layers, jcfg.num_experts_per_tok
    assert len(jx) == len(tx) == 2 * L
    router = np.asarray(jp["layers"]["router"])
    for i, (a, b) in enumerate(zip(jx, tx)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        want = jax_topk(a, router[i % L], k)
        got = port_topk(b, router[i % L], k)
        np.testing.assert_array_equal(got, want)
        # several experts chosen over the rows: the routing is exercised
        assert len(np.unique(got)) > k


def test_moe_route_ties_and_weights():
    """Tied probabilities select the lower expert index first, as
    ``jax.lax.top_k`` does; the weights are the renormalized top-k
    probabilities, zero elsewhere."""
    rng = np.random.default_rng(1)
    H, E, k = 8, 6, 2
    router = rng.standard_normal((H, E)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 4] = router[:, 1]          # three columns tie
    x = rng.standard_normal((2, 5, H)).astype(np.float32)
    np.testing.assert_array_equal(port_topk(x, router, k),
                                  jax_topk(x, router, k))
    x[...] = 0.0                         # every expert ties: 0 and 1
    np.testing.assert_array_equal(port_topk(x, router, k),
                                  np.broadcast_to([0, 1], (2, 5, 2)))
    x = rng.standard_normal((1, 3, H)).astype(np.float32)
    got = t_llama.moe_route(torch.from_numpy(x), torch.from_numpy(router),
                            k).numpy()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1))
    topv, topi = jax.lax.top_k(probs, k)
    want = np.zeros_like(probs)
    np.put_along_axis(want, np.asarray(topi),
                      np.asarray(topv / topv.sum(-1, keepdims=True)), -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def raw(t):
    """A tensor's bytes, comparable across types (fp8 and bf16 too)."""
    return t.contiguous().view(torch.uint8).numpy() if t.dim() else \
        t.reshape(1).view(torch.uint8).numpy()


@pytest.fixture(scope="module")
def moe_q():
    """Weights at the scale of ``test_torch_quant.py``'s quantized
    forwards (0.1)."""
    return pair(seed=1, scale=0.1)


@pytest.mark.parametrize("q", ["int8", "fp8", "int4"])
def test_moe_quantized_bytes_and_forward_match_jax(moe_q, q, monkeypatch):
    """The port's ``quantize_llama_params`` of the bridged tree gives the
    bytes of JAX's on its own tree ([L, E, in, out] stacks along -2,
    scales [L, E, out], the router untouched); the bridge carries JAX's
    quantized tree across, and the two quantized forwards agree."""
    jcfg, jp, tcfg, tp = moe_q
    jq = jax_quant(jp, dtype=JAX_QUANT[q])
    bridged = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    mine = quantize_llama_params(tp, dtype=T_QUANT[q])
    got, want = list(tensors(mine)), list(tensors(bridged))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(raw(a), raw(b))
    E = jcfg.num_experts
    stack = mine["layers"]["w_gate"]
    assert stack.scale.shape == (jcfg.num_layers, E,
                                 jcfg.intermediate_size)
    assert mine["layers"]["router"] is tp["layers"]["router"]
    jls, tls, _, _ = run_forwards(jcfg, jq, tcfg, mine, monkeypatch)
    for jl, tl in zip(jls, tls):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))


KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
HY = dict(max_ngram=4, ext=12, n_predicts=8, len_threshold=2, len_bias=0,
          tree_nodes=13, topk=4, max_block=16, corpus_capacity=1024)
# the reference's "moe" cases: (engine, weight key, prompt seed, oracle M)
ENGINE_CASES = {"fused_sam": (3, 4, 8), "hybrid": (8, 9, 16)}


def both_engines(kind, dtype):
    """(JAX's output, its block-M oracle's, the port's, its oracle's,
    the pair, the prompt) of one of the reference's "moe" cases of
    ``test_fused_sam_greedy_equality`` / ``test_hybrid_greedy_equality``
    (weights of JAX's default scale, 0.02)."""
    key, pseed, M = ENGINE_CASES[kind]
    jcfg, jp, tcfg, tp = both = pair(seed=key, scale=0.02, dtype=dtype)
    p = np.random.default_rng(pseed).integers(3, 128, size=20).tolist()
    jgen = JaxGen(max_new_tokens=24, max_cache_len=256)
    gen = GenerationConfig(max_new_tokens=24, max_cache_len=256)
    if kind == "fused_sam":
        jeng = JaxFused(jcfg, jp, JaxFsc(n_predicts=7), **KW)
        teng = FusedSamEngine(tcfg, tp, FusedSamConfig(n_predicts=7),
                              device="cpu", **KW)
    else:
        jeng = JaxHybrid(jcfg, jp, JaxHy(**HY), **KW)
        teng = FusedHybridEngine(tcfg, tp, FusedHybridConfig(**HY),
                                 device="cpu", **KW)
    return (jeng.generate(p, jgen),
            JaxAr(jcfg, jp, block_size=M, **KW).generate(p, jgen),
            teng.generate(p, gen),
            ArBaseline(tcfg, tp, block_size=M, device="cpu",
                       **KW).generate(p, gen), both, p)


@pytest.mark.parametrize("kind", ["fused_sam", "hybrid"])
def test_moe_engines_match_jax_f32(kind):
    """f32, the reference tests' type: the port's stream and decode steps
    equal JAX's token for token, and both equal their block-M oracles."""
    want, want_ar, got, got_ar, _, _ = both_engines(kind, jnp.float32)
    assert want.output_ids == want_ar.output_ids
    assert got.output_ids == got_ar.output_ids == want.output_ids
    assert got.decode_steps == want.decode_steps


def prefill_logits(both, ids):
    """Each package's f32 logits [T, V] of a plain prefill of ``ids``."""
    jcfg, jp, tcfg, tp = both
    T = len(ids)
    jk, jv = jax_init_kv(jcfg, 1, S)
    jl, _, _, _ = jax_forward(jp, jcfg, jnp.asarray([ids], jnp.int32),
                              jnp.arange(T)[None], jk, jv, jnp.int32(0),
                              jax_prefill_mask(1, T, S))
    tk, tv = init_kv_cache(tcfg, 1, S, "cpu")
    tl, _ = forward(tp, tcfg, torch.tensor([ids]), torch.arange(T)[None],
                    tk, tv, 0, prefill_mask(1, T, S))
    return np.asarray(jl)[0], tl[0].numpy()


# The two packages round bf16 differently (XLA's fused elementwise ops
# against torch's), so their bf16 logits differ by that rounding.  At the
# engine cases' weights (scale 0.02, logits below 0.7) the dense trunk's
# largest difference over these prefills is 2.7e-3; both families are held
# to 2**-8, one bf16 step at the logits' size.
BF16_ATOL = 2.0 ** -8
# Where the bf16 streams first differ, each package's two candidates must
# lie within half a bf16 step at 0.5 of each other in its own logits.
BF16_TIE = 2.0 ** -10


@pytest.mark.parametrize("family", ["llama", "moe"])
@pytest.mark.parametrize("kind", ["fused_sam", "hybrid"])
def test_bf16_forward_matches_jax(kind, family):
    """bf16, at each engine case's weights: a 44-token prefill's logits at
    every position agree with JAX's within ``BF16_ATOL``, the dense trunk
    (``tiny_config``) and the MoE model alike."""
    key, pseed, _ = ENGINE_CASES[kind]
    make = tiny_moe_config if family == "moe" else tiny_config
    both = pair(seed=key, scale=0.02, dtype=jnp.bfloat16, make=make)
    ids = np.random.default_rng(pseed).integers(3, 128, size=44).tolist()
    jl, tl = prefill_logits(both, ids)
    assert jl.shape == tl.shape == (44, both[0].vocab_size)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("kind", ["fused_sam", "hybrid"])
def test_moe_engines_bf16(kind):
    """bf16: each package's engine equals its own block-M oracle token for
    token (lossless), and the two packages' streams are equal token for
    token up to a bf16 tie.  Where they first differ, the shared prefix's
    logits agree within ``BF16_ATOL``, each package picks its own argmax,
    and in each package's logits the two tokens lie within ``BF16_TIE``.
    The fused_sam case differs so at its 7th new token (86 against 60;
    JAX's gap 3.1e-4, the port's 3.8e-5); the hybrid case is equal."""
    want, want_ar, got, got_ar, both, p = both_engines(kind, jnp.bfloat16)
    assert want.output_ids == want_ar.output_ids
    assert got.output_ids == got_ar.output_ids
    a, b = want.output_ids, got.output_ids
    assert len(a) == len(b) == len(p) + 24
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        assert got.decode_steps == want.decode_steps
        return
    jl, tl = (x[-1] for x in prefill_logits(both, a[:i]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=BF16_ATOL)
    assert int(np.argmax(jl)) == a[i] and int(np.argmax(tl)) == b[i]
    assert jl[a[i]] - jl[b[i]] <= BF16_TIE, \
        f"token {i}: {a[i]} against {b[i]} is no bf16 tie in JAX's logits"
    assert tl[b[i]] - tl[a[i]] <= BF16_TIE, \
        f"token {i}: {b[i]} against {a[i]} is no bf16 tie in the port's"


# ----------------------------------------------------------------------
# A Mixtral directory
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    return write_mixtral(tmp_path_factory.mktemp("mx") / "hf")


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("tdtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
    ids=["f32", "bf16"])
def test_mixtral_dir_loads_like_jax(mixtral_dir, tdtype, jdtype):
    cfg, got = load_llama(mixtral_dir, dtype=tdtype, device="cpu")
    assert cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
    jcfg = dataclasses.replace(tiny_moe_config(dtype=jdtype),
                               rms_eps=cfg.rms_eps)
    want = params_from_jax(jax.tree.map(
        np.asarray, jax_convert(mixtral_state(), jcfg)), "cpu")
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype == tdtype, k
        assert g[k].shape == w[k].shape and torch.equal(g[k], w[k]), k
    assert g["layers.w_down"].shape == (2, 4, 128, 64)
    assert g["layers.router"].shape == (2, 64, 4)


@pytest.mark.parametrize("change,exc,match", [
    ("drop", KeyError, "experts.3.w2"),
    ("extra_expert", ValueError, "does not use")],
    ids=["missing-expert", "extra-expert"])
def test_mixtral_dir_refuses_missing_and_unused(tmp_path, change, exc,
                                                match):
    sd = mixtral_state()
    if change == "drop":
        del sd["model.layers.1.block_sparse_moe.experts.3.w2.weight"]
    else:
        sd = mixtral_state(extra=(
            "model.layers.0.block_sparse_moe.experts.4.w1.weight",))
    d = write_mixtral(tmp_path / "hf", sd)
    with pytest.raises(exc, match=match):
        load_llama(d, dtype=torch.float32, device="cpu")


def test_mixtral_dir_matches_hf_logits(mixtral_dir):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        **{k: v for k, v in HF_MIXTRAL.items() if k != "model_type"},
        attn_implementation="eager")
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    model.load_state_dict(mixtral_state())
    cfg, params = load_llama(mixtral_dir, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(1, 17)))
    with torch.no_grad():
        ref = model(tokens).logits
        kv_k, kv_v = init_kv_cache(cfg, 1, 32, "cpu")
        logits, _ = forward(params, cfg, tokens, torch.arange(17)[None],
                            kv_k, kv_v, 0, prefill_mask(1, 17, 32))
    torch.testing.assert_close(logits, ref, rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# Front ends
# ----------------------------------------------------------------------

def test_from_hf_config_families():
    base = {k: v for k, v in HF_MIXTRAL.items()
            if k not in ("model_type", "num_local_experts")}
    m = from_hf_config({**HF_MIXTRAL, "num_local_experts": 8},
                       dtype=torch.float32)
    assert m.num_experts == 8 and m.num_experts_per_tok == 2
    assert not m.attn_bias
    q = from_hf_config({**base, "model_type": "qwen2"})
    assert q.attn_bias and q.num_experts == 0
    # num_local_experts counts only for Mixtral, as in the reference
    ll = from_hf_config({**base, "model_type": "llama",
                         "num_local_experts": 8})
    assert ll.num_experts == 0 and not ll.attn_bias
    obj = from_hf_config(SimpleNamespace(**HF_MIXTRAL), dtype=torch.float32)
    assert obj == dataclasses.replace(m, num_experts=4)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_moe_checkpoint_round_trip_bitwise(moe, tmp_path, quant):
    _, _, tcfg, tp = moe
    params = tp if quant is None else quantize_llama_params(tp, dtype=INT4)
    save_params(str(tmp_path / "ckpt"), params, tcfg)
    cfg2, params2 = load_params(str(tmp_path / "ckpt"), device="cpu")
    assert cfg2 == tcfg
    a, b = list(tensors(params)), list(tensors(params2))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    kind = json.loads((tmp_path / "ckpt" / "leaves.json").read_text())
    assert kind["layers.w_gate"] == ("tensor" if quant is None else "int4")
    assert kind["layers.router"] == "tensor"


def test_random_model_moe_configs():
    """``--family moe``: the reference CLI's shapes (``samd_tpu/cli.py:
    35-52``)."""
    from samd_tpu.models import llama_1b as jax_1b
    from samd_tpu_torch.models.loader import random_model

    routes = dict(attention_impl="flash", int4_impl="kernel")
    tiny = random_config("moe", True)
    assert tiny == dataclasses.replace(
        port_config(tiny_moe_config(vocab_size=256)), **routes)
    big = random_config("moe", False)
    want = dataclasses.replace(jax_1b(), intermediate_size=2816,
                               num_experts=8, num_experts_per_tok=2)
    assert big == dataclasses.replace(port_config(want), **routes)
    cfg, params = random_model("moe", True, "cpu")
    assert cfg == tiny
    assert params["layers"]["w_up"].shape == (2, 4, 64, 128)


def run_cli(monkeypatch, capsys, argv, script):
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    cli.main(argv)
    return capsys.readouterr().out


def replies(out):
    return [ln.split("ASSISTANT>")[1].split("USER>")[0].split()
            for ln in out.splitlines() if "ASSISTANT>" in ln]


@pytest.mark.parametrize("flags", [[], ["--quantize", "int4", "--kv-quant"]],
                         ids=["bf16", "int4-int8kv"])
def test_cli_family_moe(monkeypatch, capsys, flags):
    out = run_cli(monkeypatch, capsys,
                  ["--random-model", "--tiny", "--cpu", "--family", "moe",
                   "--engine", "fused_sam", "--max-new-tokens", "8",
                   "--max-cache-len", "256"] + flags,
                  "5 6 7 8 9 10\n!!exit\n")
    (reply,) = replies(out)
    assert len(reply) == 8


def test_mixtral_dir_serves_cli_and_server(mixtral_dir, monkeypatch,
                                           capsys):
    """``cli --model DIR`` and ``server --model DIR`` on a Mixtral
    directory: each reply equals the same engine called in process."""
    from samd_tpu_torch.fused_sam import PagedBatchedFusedSamEngine
    from samd_tpu_torch.server import build_server_engine

    prompt = [9, 10, 11, 12, 13]
    argv = ["--model", mixtral_dir, "--cpu", "--engine", "samd",
            "--max-new-tokens", "8", "--max-cache-len", "256"]
    out = run_cli(monkeypatch, capsys, argv,
                  " ".join(map(str, prompt)) + "\n!!exit\n")
    engine, _, _ = cli.build_engine(cli.parse_args(argv))
    assert engine.model_cfg.num_experts == 4
    gen = GenerationConfig(max_new_tokens=8, max_cache_len=256)
    want = engine.generate(prompt, gen).output_ids[len(prompt):]
    assert [int(t) for t in replies(out)[0]] == want
    args = SimpleNamespace(model=mixtral_dir, random_model=False, tiny=False,
                           engine="paged_fused_sam", batch_size=2,
                           quantize=None, max_cache_len=256, sam=None,
                           cpu=True, inline_prefill=False)
    eng = build_server_engine(args)
    cfg, params = load_llama(mixtral_dir, device="cpu")
    ref = PagedBatchedFusedSamEngine(
        cfg, params, FusedSamConfig(steps_per_call=16, n_predicts=15),
        batch_size=2, max_cache_len=256, eos_token_id=-1, device="cpu")
    prompts = [prompt, list(range(30, 50))]
    rids = [eng.add_request(p, gen) for p in prompts]
    got = eng.run()
    rids2 = [ref.add_request(p, gen) for p in prompts]
    want = ref.run()
    for r, r2 in zip(rids, rids2):
        assert got[r].output_ids == want[r2].output_ids
        assert got[r].decode_tokens == 8
