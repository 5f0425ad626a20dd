"""samd_tpu_torch's Llama forward against samd_tpu's, on shared weights.

A prefill block and then an M-block tree verify at a nonzero offset, with
plain attention in both packages and with the flash route in both (JAX's
Pallas kernel in interpret mode, the port's plain version of its kernel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.models import forward as jax_forward
from samd_tpu.models import init_params, tiny_config, tiny_qwen2_config
from samd_tpu.models.llama import block_decode_mask as jax_block_mask
from samd_tpu.models.llama import prefill_mask as jax_prefill_mask
from samd_tpu.cache import init_kv_cache as jax_init_kv
from samd_tpu.sam.trees import ancestor_closure, node_depths
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import init_kv_cache
from samd_tpu_torch.models import ModelConfig, block_decode_mask, forward
from samd_tpu_torch.models import prefill_mask


def port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig with the same fields as a JAX one: the
    reference's interpret-mode kernel routes map to the port's kernel
    routes, and its "ds" cache layout to the port's "sd" (the tests permute
    where they compare caches)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = getattr(torch, np.dtype(jcfg.dtype).name)
    fields["attention_impl"] = (
        "flash" if jcfg.attention_impl.startswith("flash") else "xla")
    fields["int4_impl"] = (
        "kernel" if jcfg.int4_impl.startswith("kernel") else "xla")
    fields["kv_layout"] = "sd"
    return ModelConfig(**fields)


def tiny_kh8(vocab_size=128):
    return dataclasses.replace(tiny_config(vocab_size), num_heads=8,
                               num_kv_heads=8)


@pytest.mark.parametrize("impl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("make_cfg", [tiny_config, tiny_qwen2_config,
                                      tiny_kh8])
def test_forward_matches_jax(make_cfg, impl):
    jcfg = dataclasses.replace(make_cfg(vocab_size=128), attention_impl=impl)
    tcfg = port_config(jcfg)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    S, P, n, M = 128, 32, 20, 8
    rng = np.random.default_rng(0)
    jk, jv = jax_init_kv(jcfg, 1, S)
    tk, tv = init_kv_cache(tcfg, 1, S, "cpu")

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))

    # prefill: P tokens (n real) at offset 0
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :n] = rng.integers(0, 128, n)
    pos = np.arange(P, dtype=np.int32)[None]
    jl, _, jk, jv = jax_forward(jp, jcfg, jnp.asarray(tokens),
                                jnp.asarray(pos), jk, jv, jnp.int32(0),
                                jax_prefill_mask(1, P, S))
    tl, _ = forward(tp, tcfg, torch.from_numpy(tokens),
                    torch.from_numpy(pos), tk, tv, 0,
                    prefill_mask(1, P, S))
    check(jl, tl)

    # verify: an M-node tree written at offset n
    parents = np.array([-1] + [rng.integers(0, i) for i in range(1, M)],
                       np.int32)
    tree = ancestor_closure(parents)
    vpos = (node_depths(parents) + n).astype(np.int32)[None]
    vtok = rng.integers(0, 128, (1, M)).astype(np.int32)
    jl, _, jk, jv = jax_forward(
        jp, jcfg, jnp.asarray(vtok), jnp.asarray(vpos), jk, jv,
        jnp.int32(n), jax_block_mask(jnp.asarray(tree), jnp.int32(n), S))
    tl, _ = forward(
        tp, tcfg, torch.from_numpy(vtok), torch.from_numpy(vpos), tk, tv,
        torch.tensor(n, dtype=torch.int32),
        block_decode_mask(torch.from_numpy(tree), n, S))
    check(jl, tl)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cache_len", [0, 5, 120])
def test_masks_match_jax(cache_len):
    rng = np.random.default_rng(cache_len)
    M, S = 8, 128
    parents = np.array([-1] + [rng.integers(0, i) for i in range(1, M)],
                       np.int32)
    tree = ancestor_closure(parents)
    want = np.asarray(jax_block_mask(jnp.asarray(tree), jnp.int32(cache_len),
                                     S))
    got = block_decode_mask(torch.from_numpy(tree), cache_len, S).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(prefill_mask(1, 32, S).numpy(),
                                  np.asarray(jax_prefill_mask(1, 32, S)))
