"""Weight bridge JAX → samd_tpu_torch: the bytes and layout survive."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.models import init_params, tiny_config, tiny_moe_config
from samd_tpu.models import tiny_qwen2_config
from samd_tpu.ops.quant import quantize_llama_params
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.ops.quant import Int4Tensor, QuantizedTensor
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def _leaves(tree, prefix=""):
    """(path, array) for every array of a tree, quantized leaves' parts
    included, whichever package's classes they are."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        elif type(v).__name__ in ("QuantizedTensor", "Int4Tensor"):
            for part in ("q", "packed", "scale"):
                if hasattr(v, part):
                    yield prefix + k + "." + part, getattr(v, part)
        else:
            yield prefix + k, v


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes, whatever its type (bf16 and fp8 have no numpy
    view)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("make_cfg", [tiny_config, tiny_qwen2_config])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_round_trip_exact(make_cfg, dtype):
    cfg = make_cfg(vocab_size=64, dtype=dtype)
    jp = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, "cpu")
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert want.keys() == got.keys()
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape, name
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert raw.numpy().tobytes() == a.tobytes(), name
    # stacked [L, ...] layer layout is kept
    assert tp["layers"]["wq"].shape == (cfg.num_layers, cfg.hidden_size,
                                        cfg.num_heads * cfg.head_dim)
    want_t = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert tp["embed"].dtype == want_t


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn", "float8_e5m2",
                                    "int4"])
def test_quantized_round_trip_exact(qdtype):
    """Quantized trees cross with their int8 / fp8 / packed bytes and f32
    scales unchanged, as the port's classes of the same names."""
    cfg = tiny_config(vocab_size=64)
    jp = jax.tree.map(np.asarray, quantize_llama_params(
        init_params(cfg, jax.random.PRNGKey(1)), dtype=getattr(jnp, qdtype)))
    tp = params_from_jax(jp, "cpu", dtype=torch.float32)
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert want.keys() == got.keys()
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        assert _raw_bytes(got[name]) == a.tobytes(), name
    cls = Int4Tensor if qdtype == "int4" else QuantizedTensor
    assert isinstance(tp["layers"]["wq"], cls)
    assert isinstance(tp["lm_head"], cls)
    if qdtype != "int4":
        assert tp["layers"]["wq"].q.dtype == getattr(torch, qdtype)
    assert tp["layers"]["wq"].scale.dtype == torch.float32


def test_quantized_and_moe_trees_raise():
    """A quantized tree now crosses (``test_quantized_round_trip_exact``
    holds its bytes); an MoE tree still raises."""
    cfg = tiny_config(vocab_size=64)
    jp = init_params(cfg, jax.random.PRNGKey(0))
    q8 = jax.tree.map(np.asarray, quantize_llama_params(jp))
    assert isinstance(params_from_jax(q8, "cpu")["layers"]["wq"],
                      QuantizedTensor)
    moe = jax.tree.map(np.asarray, init_params(tiny_moe_config(vocab_size=64),
                                               jax.random.PRNGKey(0)))
    with pytest.raises(NotImplementedError, match="item 14"):
        params_from_jax(moe, "cpu")


def test_unsupported_config_settings_raise():
    from samd_tpu_torch.models.configs import check_supported
    from samd_tpu_torch.models.configs import tiny_config as t_tiny

    base = t_tiny()
    check_supported(base)
    assert base.int4_impl == "kernel" and not base.kv_quant
    for change in ({"kv_quant": True}, {"int4_impl": "xla"},
                   {"kv_quant": True, "int4_impl": "kernel"}):
        check_supported(dataclasses.replace(base, **change))
    for change, exc, match in [({"kv_layout": "ds"}, NotImplementedError,
                                "'sd'"),
                               ({"num_experts": 4}, NotImplementedError,
                                "item 14"),
                               ({"int4_impl": "kernel_interpret"},
                                ValueError, "'kernel' or 'xla'")]:
        with pytest.raises(exc, match=match):
            check_supported(dataclasses.replace(base, **change))
