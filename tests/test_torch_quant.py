"""Weight quantization of samd_tpu_torch against samd_tpu's: quantizer bytes
and scales, the int4 requant from an int8 tree, the readers, and the
forward on int8, fp8 and int4 weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.models import ModelConfig as JaxModelConfig
from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.ops import quant as jq
from samd_tpu.sam.trees import ancestor_closure, node_depths
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import init_kv_cache
from samd_tpu_torch.engine import check_params_device
from samd_tpu_torch.models import block_decode_mask, forward, prefill_mask
from samd_tpu_torch.models import tiny_config as port_tiny
from samd_tpu_torch.ops import quant as tq
from test_torch_model import port_config

JAX_TYPES = {"int8": jnp.int8, "float8_e4m3fn": jnp.float8_e4m3fn,
             "float8_e5m2": jnp.float8_e5m2}


def raw(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def jraw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    w[..., 0, :] *= 20          # one large row: a wide amax per channel
    w[..., :, 1] = 0            # an all-zero channel: the 1e-12 floor
    return w


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
@pytest.mark.parametrize("qdtype", list(JAX_TYPES))
def test_quantize_weight_bytes_match_jax(qdtype, shape):
    w = weights(shape)
    want = jq.quantize_weight(jnp.asarray(w), dtype=JAX_TYPES[qdtype])
    got = tq.quantize_weight(torch.from_numpy(w),
                             dtype=getattr(torch, qdtype))
    assert got.q.dtype == getattr(torch, qdtype)
    np.testing.assert_array_equal(raw(got.q), jraw(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_weight4_bytes_match_jax(shape):
    w = weights(shape, seed=1)
    want = jq.quantize_weight4(jnp.asarray(w))
    got = tq.quantize_weight4(torch.from_numpy(w))
    assert got.packed.dtype == torch.uint8
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("qdtype", list(JAX_TYPES) + ["int4"])
def test_readers_match_jax(qdtype):
    """dequant bitwise (the same products in the same type); qmatmul
    within f32 rounding of another summation order."""
    w = weights((2, 48, 32), seed=2)
    x = np.random.default_rng(3).standard_normal((5, 48)).astype(np.float32)
    if qdtype == "int4":
        jt = jq.quantize_weight4(jnp.asarray(w))
        tt = tq.quantize_weight4(torch.from_numpy(w))
    else:
        jt = jq.quantize_weight(jnp.asarray(w), dtype=JAX_TYPES[qdtype])
        tt = tq.quantize_weight(torch.from_numpy(w),
                                dtype=getattr(torch, qdtype))
    np.testing.assert_array_equal(tq.dequant(tt, torch.float32).numpy(),
                                  np.asarray(jq.dequant(jt, jnp.float32)))
    for l in range(2):
        jl = type(jt)(*(a[l] for a in jax.tree.leaves(jt)))
        want = np.asarray(jq.qmatmul(jnp.asarray(x), jl))
        got = tq.qmatmul(torch.from_numpy(x), tt.layer(l)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a layer is a view of the stacked tensor, not a copy
    part = tt.packed if qdtype == "int4" else tt.q
    lpart = tt.layer(1).packed if qdtype == "int4" else tt.layer(1).q
    assert lpart.untyped_storage().data_ptr() \
        == part.untyped_storage().data_ptr()


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn", "int4"])
def test_quantize_llama_params_matches_jax(qdtype):
    cfg = tiny_config(vocab_size=64)
    jp = init_params(cfg, jax.random.PRNGKey(4))
    want = params_from_jax(jax.tree.map(np.asarray, jq.quantize_llama_params(
        jp, dtype=jnp.int4 if qdtype == "int4" else JAX_TYPES[qdtype])),
        "cpu")
    got = tq.quantize_llama_params(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        dtype=tq.INT4 if qdtype == "int4" else getattr(torch, qdtype))
    want_t, got_t = list(tq.tensors(want)), list(tq.tensors(got))
    assert len(want_t) == len(got_t)
    for a, b in zip(want_t, got_t):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(raw(b), raw(a))
    assert tq.quantized_bytes(got) == sum(
        leaf.size * leaf.dtype.itemsize for leaf in
        jax.tree.leaves(jq.quantize_llama_params(
            jp, dtype=jnp.int4 if qdtype == "int4" else JAX_TYPES[qdtype])))


@pytest.mark.parametrize("seed,scale", [(0, 0.4), (7, 0.02)])
def test_int4_from_int8_matches_jax_requant(seed, scale):
    """The port requantizes the int8 base tree the bridge carries across;
    the reference regenerates the same base from its key: the packed bytes
    and scales agree exactly."""
    cfg = tiny_config(vocab_size=128)
    key = jax.random.PRNGKey(seed)
    p8 = params_from_jax(jax.tree.map(np.asarray, jq._init_quantized_llama_params(
        cfg, key, scale=scale)), "cpu")
    want = params_from_jax(jax.tree.map(
        np.asarray, jq.int4_requant_from_int8_init(cfg, key,
                                                   scale=scale)[0]), "cpu")
    got = tq.int4_from_int8_params(p8)
    for name in tq.PROJECTIONS:
        assert isinstance(got["layers"][name], tq.Int4Tensor)
        assert torch.equal(got["layers"][name].packed,
                           want["layers"][name].packed), name
        assert torch.equal(got["layers"][name].scale,
                           want["layers"][name].scale), name
    assert torch.equal(got["lm_head"].packed, want["lm_head"].packed)
    assert torch.equal(got["lm_head"].scale, want["lm_head"].scale)
    assert got["embed"] is p8["embed"]


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_init_quantized_llama_params(qdtype):
    """The port's own random quantized init: types, shapes, and the
    per-channel scale that gives the dequantized weights std ≈ scale."""
    cfg = port_tiny(vocab_size=64)
    gen = torch.Generator().manual_seed(0)
    dtype = torch.int8 if qdtype == "int8" else tq.INT4
    p = tq.init_quantized_llama_params(cfg, gen, scale=0.05, dtype=dtype,
                                       device="cpu")
    wg = p["layers"]["w_gate"]
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    assert tuple(wg.shape) == (L, H, I) and wg.scale.shape == (L, I)
    assert p["embed"].dtype == cfg.dtype and p["embed"].shape == (64, H)
    std = tq.dequant(wg, torch.float32).std().item()
    assert 0.04 < std < 0.06
    if qdtype == "int8":
        assert wg.q.dtype == torch.int8 and wg.q.min() >= -127
    else:
        assert wg.packed.dtype == torch.uint8


def test_check_params_device_sees_quantized_leaves():
    cfg = port_tiny(vocab_size=64)
    p = tq.init_quantized_llama_params(cfg, torch.Generator(), dtype=tq.INT4,
                                       device="cpu")
    check_params_device(p, torch.device("cpu"))
    p["layers"]["wq"].scale = p["layers"]["wq"].scale.to("meta")
    with pytest.raises(ValueError, match="meta"):
        check_params_device(p, torch.device("cpu"))


def kernel_cfg(**kw) -> JaxModelConfig:
    """The reference's int4-kernel test shape (``tests/test_quant.py:
    285-290``): contraction dims that are multiples of 256."""
    return JaxModelConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=3, num_heads=4,
                          num_kv_heads=2, head_dim=64, dtype=jnp.float32, **kw)


def forward_both(jcfg, jp, tcfg, tp, S=128, P=32, n=20, M=8, seed=0):
    """A prefill and then an M-node tree verify at offset n, through both
    packages; returns [(jax logits, port logits)] and both caches."""
    rng = np.random.default_rng(seed)
    V = jcfg.vocab_size
    jk, jv = jax_init_kv(jcfg, 1, S)
    tk, tv = init_kv_cache(tcfg, 1, S, "cpu")
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :n] = rng.integers(0, V, n)
    pos = np.arange(P, dtype=np.int32)[None]
    out = []
    jl, _, jk, jv = jax_forward(jp, jcfg, jnp.asarray(tokens),
                                jnp.asarray(pos), jk, jv, jnp.int32(0),
                                jax_prefill_mask(1, P, S))
    tl, _ = forward(tp, tcfg, torch.from_numpy(tokens),
                    torch.from_numpy(pos), tk, tv, 0, prefill_mask(1, P, S))
    out.append((np.asarray(jl), tl.numpy()))
    parents = np.array([-1] + [rng.integers(0, i) for i in range(1, M)],
                       np.int32)
    tree = ancestor_closure(parents)
    vpos = (node_depths(parents) + n).astype(np.int32)[None]
    vtok = rng.integers(0, V, (1, M)).astype(np.int32)
    jl, _, jk, jv = jax_forward(
        jp, jcfg, jnp.asarray(vtok), jnp.asarray(vpos), jk, jv,
        jnp.int32(n), jax_block_mask(jnp.asarray(tree), jnp.int32(n), S))
    tl, _ = forward(tp, tcfg, torch.from_numpy(vtok), torch.from_numpy(vpos),
                    tk, tv, torch.tensor(n, dtype=torch.int32),
                    block_decode_mask(torch.from_numpy(tree), n, S))
    out.append((np.asarray(jl), tl.numpy()))
    return out, (jk, jv), (tk, tv)


@pytest.mark.parametrize("qdtype,impl", [
    ("int8", "xla"), ("float8_e4m3fn", "xla"), ("float8_e5m2", "xla"),
    ("int4", "xla"), ("int4", "kernel_interpret")])
def test_forward_quantized_matches_jax(qdtype, impl):
    """Logits of the forward on quantized weights agree with JAX's, with
    the port's "kernel" route (the K3 kernel's plain version on the CPU)
    against the reference's interpret-mode Pallas kernel."""
    jcfg = kernel_cfg(int4_impl=impl)
    jp = jq.quantize_llama_params(
        init_params(jcfg, jax.random.PRNGKey(1), scale=0.1),
        dtype=jnp.int4 if qdtype == "int4" else JAX_TYPES[qdtype])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = port_config(jcfg)
    assert tcfg.int4_impl == ("kernel" if impl.startswith("kernel")
                              else "xla")
    pairs, (jk, _), (tk, _) = forward_both(jcfg, jp, tcfg, tp)
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)


def test_forward_int4_kernel_route_calls_int4_matmul(monkeypatch):
    """Under int4_impl="kernel" every projection and the head go through
    ``int4_matmul`` with the whole stacked tensor and a layer index; under
    "xla" none do."""
    from samd_tpu_torch.models import llama

    calls = []

    def spy(x, packed, scale, layer=None, *, out_dtype=None):
        calls.append((packed.dim(), layer, out_dtype))
        return real(x, packed, scale, layer, out_dtype=out_dtype)

    real = llama.int4_matmul
    monkeypatch.setattr(llama, "int4_matmul", spy)
    cfg = dataclasses.replace(port_config(kernel_cfg()), int4_impl="kernel")
    p = tq.init_quantized_llama_params(cfg, torch.Generator().manual_seed(0),
                                       dtype=tq.INT4, device="cpu")
    kv = init_kv_cache(cfg, 1, 16, "cpu")
    forward(p, cfg, torch.zeros((1, 4), dtype=torch.int32),
            torch.arange(4)[None], *kv, 0, prefill_mask(1, 4, 16))
    L = cfg.num_layers
    assert len(calls) == 7 * L + 1
    assert sorted({c[1] for c in calls[:-1]}) == list(range(L))
    assert all(c[0] == 3 for c in calls[:-1])
    assert calls[-1] == (2, None, torch.float32)
    calls.clear()
    forward(p, dataclasses.replace(cfg, int4_impl="xla"),
            torch.zeros((1, 4), dtype=torch.int32), torch.arange(4)[None],
            *kv, 0, prefill_mask(1, 4, 16))
    assert calls == []
