"""samd_tpu_torch's EAGLE draft net and drafters against samd_tpu's: the
net's forward, checkpoint conversion and int8 quantization, the device
draft unpack, the EAGLE-2 expansion's packed drafts, ``SamdEngine`` with
the EAGLE-2 and EAGLE-1 tree drafters, and ``FusedEagle2Engine`` (greedy,
int8 target and net, EOS, sampled).  Token streams, decode steps and packed
drafts equal JAX's exactly, and the unpack's integers equal the host
unpack's; hidden states agree within 1e-5 (f32).  The draft net's
parameters are JAX's, carried across by ``bridge.eagle_params_from_jax``.
Mirrors ``tests/test_eagle.py`` and ``tests/test_eagle_fused.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.config import SamdConfig as JaxSamd
from samd_tpu.drafters import make_drafter as jax_make_drafter
from samd_tpu.drafters.eagle.drafter import make_eagle2 as jax_make_eagle2
from samd_tpu.drafters.eagle.net import EagleNetConfig as JaxNetCfg
from samd_tpu.drafters.eagle.net import convert_eagle_state_dict as jax_conv
from samd_tpu.drafters.eagle.net import eagle_forward as jax_eagle_forward
from samd_tpu.drafters.eagle.net import init_eagle_kv as jax_init_kv
from samd_tpu.drafters.eagle.net import init_eagle_params as jax_init_net
from samd_tpu.eagle_fused import FusedEagle2Engine as JaxFused
from samd_tpu.engine import SamdEngine as JaxSamdEngine
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops.quant import quantize_eagle_params as jax_quant_net
from samd_tpu.ops.quant import quantize_llama_params as jax_quant
from samd_tpu_torch.batching import BatchedSamdEngine
from samd_tpu_torch.bridge import eagle_params_from_jax, params_from_jax
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.drafters.eagle.drafter import make_eagle2
from samd_tpu_torch.drafters.eagle.net import (EagleNetConfig,
                                               convert_eagle_state_dict,
                                               eagle_forward, init_eagle_kv)
from samd_tpu_torch.eagle_fused import FusedEagle2Engine
from samd_tpu_torch.engine import ArBaseline, SamdEngine
from samd_tpu_torch.interleave import InterleavedSamdEngine
from samd_tpu_torch.ops.quant import quantize_eagle_params
from samd_tpu_torch.ops.treeops import _unpack_parents, unpack_draft_device
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

KW = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,))
FUSED = dict(depth=3, topk=4, total_tokens=15)


@pytest.fixture(scope="module")
def model():
    """The reference tests' tiny model and their default draft net
    (PRNGKey(7)), in both packages."""
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    jnet = jax_init_net(JaxNetCfg.from_target(jcfg), jax.random.PRNGKey(7))
    return (jcfg, jp, jnet, port_config(jcfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            eagle_params_from_jax(jax.tree.map(np.asarray, jnet), "cpu"))


def gens(n, **kw):
    return (JaxGen(max_new_tokens=n, max_cache_len=256, **kw),
            GenerationConfig(max_new_tokens=n, max_cache_len=256, **kw))


def same(got, want):
    assert got.output_ids == want.output_ids
    assert got.decode_tokens == want.decode_tokens
    assert got.decode_steps == want.decode_steps


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

def test_eagle_forward_matches_jax(model):
    """One net step over random embeddings and hidden states, written at
    offset 3 of a 32-column cache with a causal mask: hidden states and
    the written KV within 1e-5 of JAX's."""
    jcfg, _, jnet, tcfg, _, tnet = model
    jn, tn = JaxNetCfg.from_target(jcfg), EagleNetConfig.from_target(tcfg)
    rng = np.random.default_rng(0)
    T, H, off = 4, jcfg.hidden_size, 3
    emb, hid = (rng.standard_normal((1, T, H)).astype(np.float32)
                for _ in range(2))
    pos = np.arange(off, off + T)[None]
    mask = (np.arange(32)[None, None] <= pos[..., None])
    jh, jk, jv = jax_eagle_forward(
        jnet, jn, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(pos),
        *jax_init_kv(jn, 1, 32), jnp.int32(off), jnp.asarray(mask))
    tk, tv = init_eagle_kv(tn, 1, 32, "cpu")
    th = eagle_forward(tnet, tn, torch.from_numpy(emb),
                       torch.from_numpy(hid), torch.from_numpy(pos), tk, tv,
                       torch.tensor([off]), torch.from_numpy(mask))
    assert th.shape == (1, T, H) and not torch.isnan(th).any()
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_convert_eagle_state_dict_matches_jax(model):
    """An EAGLE checkpoint's state dict (torch tensors, [out, in] linears,
    with and without fc.bias) converts to JAX's parameters exactly."""
    jcfg, *_, tcfg, _, _ = model
    H, I = jcfg.hidden_size, jcfg.intermediate_size
    NH, KH, D = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    g = torch.Generator().manual_seed(3)
    p = "layers.0."
    shapes = {"fc.weight": (H, 2 * H), "fc.bias": (H,),
              p + "self_attn.q_proj.weight": (NH * D, H),
              p + "self_attn.k_proj.weight": (KH * D, H),
              p + "self_attn.v_proj.weight": (KH * D, H),
              p + "self_attn.o_proj.weight": (H, NH * D),
              p + "post_attention_layernorm.weight": (H,),
              p + "mlp.gate_proj.weight": (I, H),
              p + "mlp.up_proj.weight": (I, H),
              p + "mlp.down_proj.weight": (H, I)}
    sd = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    for bias in (True, False):
        d = sd if bias else {k: v for k, v in sd.items() if k != "fc.bias"}
        want = jax_conv(d, JaxNetCfg.from_target(jcfg))
        got = convert_eagle_state_dict(d, EagleNetConfig.from_target(tcfg),
                                       "cpu")
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], torch.from_numpy(np.array(want[k])))


def test_quantize_eagle_params_matches_jax(model):
    """int8 per-channel quantization of the net: values and scales equal
    JAX's bit for bit; fc_b and mlp_norm keep their type."""
    jnet, tnet = model[2], model[5]
    want = jax.tree.map(np.asarray, jax_quant_net(jnet))
    got = quantize_eagle_params(tnet)
    for k, w in want.items():
        if k in ("fc_b", "mlp_norm"):
            assert torch.equal(got[k], torch.from_numpy(np.array(w)))
        else:
            assert torch.equal(got[k].q, torch.from_numpy(np.array(w.q)))
            assert torch.equal(got[k].scale, torch.from_numpy(np.array(w.scale)))


# ---------------------------------------------------------------------------
# the device unpack and the expansion
# ---------------------------------------------------------------------------

def eagle_like_parents(rng, M, levels):
    """A random tree packed as EAGLE-2 packs one: (depth, index) order,
    parents before children, depth <= levels, self-parented padding."""
    n = int(rng.integers(1, M + 1))
    depth = [0]
    for _ in range(1, n):
        depth.append(int(rng.integers(1, levels + 1)))
    depth = sorted(depth)
    parents = [-1]
    for i in range(1, n):
        cands = [j for j in range(i) if depth[j] == depth[i] - 1]
        if not cands:           # keep the depths reachable
            depth[i] = depth[i - 1] + (depth[i - 1] < levels)
            cands = [j for j in range(i) if depth[j] == depth[i] - 1]
        parents.append(int(rng.choice(cands)))
    return np.concatenate([parents, np.arange(n, M)]).astype(np.int64)


@pytest.mark.parametrize("M,levels", [(16, 3), (24, 4), (64, 5)])
def test_unpack_draft_device_matches_host(M, levels):
    """On 64 random EAGLE-2-ordered drafts of one batch, padding included,
    the device unpack's mask, depths and paths (max depth M) equal the host
    unpack's integers exactly."""
    rng = np.random.default_rng(M)
    P = np.stack([eagle_like_parents(rng, M, levels) for _ in range(64)])
    draft = np.stack([rng.integers(0, 100, P.shape), P], axis=1)
    mask, depth, paths = _unpack_parents(P, M)
    got = unpack_draft_device(torch.from_numpy(draft), M, levels)
    assert torch.equal(got[0], torch.from_numpy(draft[:, 0]).int())
    for g, w in zip(got[1:], (mask, depth, paths)):
        assert g.dtype == torch.from_numpy(w).dtype
        assert torch.equal(g, torch.from_numpy(w))


EXPAND = dict(max_predicts=24, eagle_depth=3, eagle_topk=4,
              eagle_total_tokens=15)


@pytest.fixture(scope="module")
def drafters(model):
    """JAX's and the port's EAGLE-2 drafters after one prompt of random
    hidden states (from numpy): the same stable KV."""
    jcfg, jp, jnet, tcfg, tp, tnet = model
    hidden = np.random.default_rng(2).standard_normal(
        (6, jcfg.hidden_size)).astype(np.float32)
    jd = jax_make_eagle2(jcfg, jp, JaxSamd(draft_source="sam_hybrid",
                                           tree_method="eagle2", **EXPAND),
                         net_params=jnet)
    td = make_eagle2(tcfg, tp, SamdConfig(draft_source="sam_hybrid",
                                          tree_method="eagle2", **EXPAND),
                     net_params=tnet)
    prompt = list(range(3, 9))
    jd.observe_prompt_hidden(prompt, jnp.asarray(hidden))
    td.observe_prompt_hidden(prompt, torch.from_numpy(hidden))
    return jd, td


def test_expand_produces_valid_tree_equal_to_jax(drafters):
    jd, td = drafters
    assert td.stable_len == jd.stable_len == 5
    d = td.lookup(7)
    packed = d.packed.numpy()
    assert packed.shape == (2, 24) and d.num_nodes == 16 and d.depth == 3
    assert (packed == np.asarray(jd.lookup(7).packed)).all()
    tokens, parents = packed
    assert tokens[0] == 7 and parents[0] == -1
    assert all(0 <= parents[i] < i for i in range(1, 16))
    assert (parents[16:] == np.arange(16, 24)).all()
    assert (td.lookup(7).packed.numpy() == packed).all()     # deterministic


def test_expand_ancestor_closed_and_equal_to_jax(drafters):
    """Every selected node's parent is selected, at several starts, and
    each packed draft equals JAX's on the same stable KV."""
    jd, td = drafters
    for start in (3, 50, 100):
        packed = td.lookup(start).packed.numpy()
        assert (packed == np.asarray(jd.lookup(start).packed)).all()
        assert all(0 <= packed[1, i] < i for i in range(1, 16))


# ---------------------------------------------------------------------------
# SamdEngine with the EAGLE tree drafters
# ---------------------------------------------------------------------------

HOST = dict(draft_source="sam_hybrid", max_predicts=20, eagle_depth=3,
            eagle_topk=4, eagle_total_tokens=15, n_predicts=12,
            len_threshold=5, len_bias=5)


def host_engines(model, method, **cfg):
    jcfg, jp, jnet, tcfg, tp, tnet = model
    jc = JaxSamd(tree_method=method, **cfg)
    tc = SamdConfig(tree_method=method, **cfg)
    je = JaxSamdEngine(jcfg, jp, jc, jax_make_drafter(
        jc, 128, model_cfg=jcfg, params=jp, eagle_net_params=jnet), **KW)
    te = SamdEngine(tcfg, tp, tc, make_drafter(
        tc, 128, model_cfg=tcfg, params=tp, eagle_net_params=tnet),
        device="cpu", **KW)
    return je, te


def test_hybrid_eagle2_engine_equality(model):
    """SAM[EAGLE-2] through SamdEngine: each request equals the block-1
    AR oracle's and JAX's engine's, steps included; EAGLE-2 drafted."""
    je, te = host_engines(model, "eagle2", **HOST)
    ar = ArBaseline(model[3], model[4], device="cpu", **KW)
    jg, tg = gens(40)
    rng = np.random.default_rng(0)
    for _ in range(2):
        p = rng.integers(3, 128, size=18).tolist()
        out = te.generate(p, tg)
        assert out.output_ids == ar.generate(p, tg).output_ids
        same(out, je.generate(p, jg))
    assert "eagle2" in te.stats.source_counts
    assert te.stats.source_counts == je.stats.source_counts


def test_eagle1_static_tree_equality(model):
    """EAGLE-1 (the relabelled static topology): levels contiguous, output
    equal to the oracle's and JAX's."""
    cfg = dict(draft_source="sam_hybrid", max_predicts=30, n_predicts=12,
               len_threshold=5, len_bias=5)
    je, te = host_engines(model, "eagle", **cfg)
    e1 = te.drafter.tree_drafter
    assert (np.diff(e1.node_depths) >= 0).all()
    assert (e1.parents_np == je.drafter.tree_drafter.parents_np).all()
    jg, tg = gens(32)
    p = np.random.default_rng(1).integers(3, 128, size=16).tolist()
    out = te.generate(p, tg)
    assert out.output_ids == ArBaseline(model[3], model[4], device="cpu",
                                        **KW).generate(p, tg).output_ids
    same(out, je.generate(p, jg))
    assert "eagle" in te.stats.source_counts


def test_batched_and_interleaved_refuse_hidden_drafters(model):
    tcfg, tp, tnet = model[3:]
    tc = SamdConfig(tree_method="eagle2", **HOST)

    def factory():
        return make_drafter(tc, 128, model_cfg=tcfg, params=tp,
                            eagle_net_params=tnet)
    with pytest.raises(NotImplementedError, match="SamdEngine"):
        BatchedSamdEngine(tcfg, tp, tc, factory, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="SamdEngine"):
        InterleavedSamdEngine(tcfg, tp, tc, factory, device="cpu", **KW)


# ---------------------------------------------------------------------------
# FusedEagle2Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused(model):
    jcfg, jp, jnet, tcfg, tp, tnet = model
    return (JaxFused(jcfg, jp, net_params=jnet, steps_per_call=6, **FUSED,
                     **KW),
            FusedEagle2Engine(tcfg, tp, net_params=tnet, device="cpu",
                              **FUSED, **KW))


def test_fused_eagle2_equals_ar_and_jax(model, fused):
    je, te = fused
    ar = ArBaseline(model[3], model[4], device="cpu", **KW)
    jg, tg = gens(32)
    rng = np.random.default_rng(0)
    for _ in range(3):
        p = rng.integers(3, 128, size=20).tolist()
        out = te.generate(p, tg)
        assert out.output_ids == ar.generate(p, tg).output_ids
        same(out, je.generate(p, jg))


def test_fused_eagle2_quantized_equals_quantized_ar(model):
    """int8 target weights: the expansion's head ranking reads the
    quantized head; the output equals the int8 AR oracle's and JAX's."""
    jcfg, jp, jnet, tcfg, tp, tnet = model
    jq = jax_quant(jp)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    jg, tg = gens(24)
    p = np.random.default_rng(3).integers(3, 128, size=20).tolist()
    out = FusedEagle2Engine(tcfg, tq, net_params=tnet, device="cpu",
                            **FUSED, **KW).generate(p, tg)
    assert out.output_ids == ArBaseline(tcfg, tq, device="cpu",
                                        **KW).generate(p, tg).output_ids
    same(out, JaxFused(jcfg, jq, net_params=jnet, **FUSED,
                       **KW).generate(p, jg))


def test_fused_eagle2_quantized_net_lossless(model):
    """An int8 draft net and int8 target: lossless against the int8 AR
    oracle, and equal to JAX's engine."""
    jcfg, jp, jnet, tcfg, tp, tnet = model
    jq = jax_quant(jp)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    jqnet = jax_quant_net(jnet)
    tqnet = eagle_params_from_jax(jax.tree.map(np.asarray, jqnet), "cpu")
    jg, tg = gens(24)
    p = np.random.default_rng(5).integers(3, 128, size=20).tolist()
    out = FusedEagle2Engine(tcfg, tq, net_params=tqnet, device="cpu",
                            **FUSED, **KW).generate(p, tg)
    assert out.output_ids == ArBaseline(tcfg, tq, device="cpu",
                                        **KW).generate(p, tg).output_ids
    same(out, JaxFused(jcfg, jq, net_params=jqnet, **FUSED,
                       **KW).generate(p, jg))


def test_fused_eagle2_runs_budget(model, fused):
    """The whole budget in at most one step per token."""
    _, te = fused
    p = np.random.default_rng(1).integers(3, 128, size=18).tolist()
    out = te.generate(p, gens(24)[1])
    assert out.decode_tokens == 24 and out.decode_steps <= 24


def test_fused_eagle2_eos(model, fused):
    jcfg, jp, jnet, tcfg, tp, tnet = model
    p = np.random.default_rng(2).integers(3, 128, size=16).tolist()
    ref = ArBaseline(tcfg, tp, device="cpu", **KW).generate(p, gens(12)[1])
    eos = ref.output_ids[len(p) + 5]
    kw = {**KW, "eos_token_id": eos}
    out = FusedEagle2Engine(tcfg, tp, net_params=tnet, device="cpu",
                            **FUSED, **kw).generate(p, gens(40)[1])
    gen_part = out.output_ids[len(p):]
    assert eos in gen_part and gen_part.index(eos) == len(gen_part) - 1
    same(out, JaxFused(jcfg, jp, net_params=jnet, **FUSED,
                       **kw).generate(p, gens(40)[0]))


@pytest.mark.parametrize("mode,knobs", [
    ("rejection", dict(temperature=0.8, top_p=0.9)),
    ("typical", dict(temperature=0.8)),
    ("nucleus", dict(temperature=0.8, top_p=0.9)),
])
def test_fused_eagle2_sampling_runs(model, fused, mode, knobs):
    """Each tree accept rule runs through the fused loop, stays in the
    vocabulary and repeats with its seed."""
    _, te = fused
    gen = GenerationConfig(max_new_tokens=16, max_cache_len=256,
                           greedy=False, accept_mode=mode, seed=9, **knobs)
    p = np.random.default_rng(1).integers(3, 128, size=20).tolist()
    out1, out2 = te.generate(p, gen), te.generate(p, gen)
    assert out1.output_ids == out2.output_ids
    assert len(out1.output_ids) == len(p) + 16
    assert all(0 <= t < 128 for t in out1.output_ids)
