"""samd_tpu_torch's verify step against samd_tpu's: tree ops, greedy
acceptance and KV compaction integer for integer, and the AR oracle's
token streams on shared weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.cache import compact_accepted as jax_compact
from samd_tpu.config import GenerationConfig as JaxGen
from samd_tpu.engine import ArBaseline as JaxAr
from samd_tpu.models import init_params, tiny_config
from samd_tpu.ops.treeops import pack_draft_host as jax_pack
from samd_tpu.ops.treeops import unpack_draft as jax_unpack
from samd_tpu.verify import greedy_accept as jax_accept
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.cache import compact_accepted
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.engine import ArBaseline
from samd_tpu_torch.models import ModelConfig
from samd_tpu_torch.ops.treeops import pack_draft_host, unpack_draft
from samd_tpu_torch.verify import greedy_accept
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def random_draft(rng, M):
    """A random tree of n <= M real nodes (parents precede children),
    packed with self-parent padding by both packages' packers."""
    n = int(rng.integers(1, M + 1))
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, n)]
    tokens = rng.integers(0, 50, n).tolist()
    packed = pack_draft_host(tokens, parents, M)
    np.testing.assert_array_equal(packed, jax_pack(tokens, parents, M))
    return packed


@pytest.mark.parametrize("seed", range(6))
def test_unpack_draft_matches_jax(seed):
    rng = np.random.default_rng(seed)
    M = 12
    packed = random_draft(rng, M)
    want = jax_unpack(jnp.asarray(packed), M)
    got = unpack_draft(torch.from_numpy(packed), M)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(6))
def test_greedy_accept_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    M, V = 12, 16
    packed = random_draft(rng, M)
    logits = rng.standard_normal((M, V)).astype(np.float32)
    # make most children agree with their parent's argmax, so paths of
    # several accepted tokens occur
    for i in range(1, M):
        p = packed[1, i]
        if p < i and rng.random() < 0.8:
            packed[0, i] = logits[p].argmax()
    tokens, _, _, paths = jax_unpack(jnp.asarray(packed), M)
    want = jax_accept(jnp.asarray(logits), tokens, paths)
    t_tokens, _, _, t_paths = unpack_draft(torch.from_numpy(packed), M)
    got = greedy_accept(torch.from_numpy(logits), t_tokens, t_paths)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("seed", range(4))
def test_compact_accepted_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    L, KH, S, D, M = 2, 2, 64, 8, 12
    kv = rng.standard_normal((L, 1, KH, S, D)).astype(np.float32)
    offset = int(rng.integers(0, S - M + 1))
    idx = rng.integers(0, M, M).astype(np.int32)
    want = jax_compact(jnp.asarray(kv), jnp.int32(offset), jnp.asarray(idx),
                       M)
    got = torch.from_numpy(kv.copy())
    out = compact_accepted(got, torch.tensor(offset), torch.from_numpy(idx),
                           M)
    assert out is got                       # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = tiny_config(vocab_size=128)
    jp = init_params(jcfg, jax.random.PRNGKey(0), scale=0.4)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = ModelConfig(**{**fields, "dtype": torch.float32})
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.mark.parametrize("block_size", [1, 8])
def test_ar_baseline_matches_jax(tiny_model, block_size):
    jcfg, jp, tcfg, tp = tiny_model
    kw = dict(max_cache_len=256, eos_token_id=-1, prefill_buckets=(32,),
              block_size=block_size)
    jax_ar = JaxAr(jcfg, jp, **kw)
    port_ar = ArBaseline(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(block_size)
    for _ in range(2):
        p = rng.integers(3, 128, size=20).tolist()
        want = jax_ar.generate(p, JaxGen(max_new_tokens=24,
                                         max_cache_len=256))
        got = port_ar.generate(p, GenerationConfig(max_new_tokens=24,
                                                   max_cache_len=256))
        assert got.output_ids == want.output_ids
        assert got.decode_steps == want.decode_steps
        assert got.accept_length_per_step == want.accept_length_per_step
