"""samd_tpu_torch.models.loader and models.checkpoint against samd_tpu's:
the hand-written safetensors reader against the safetensors package, the
HF loader against JAX's ``load_llama`` on the same ``save_pretrained``
directory (Llama, Qwen2 with its biases, a sharded directory, ``.bin``
files, f16 weights), bitwise in f32 and bf16; an unported
``rope_scaling`` raises, and a Mixtral config is read (its directories are
held in ``test_torch_model_families.py``).  The port's checkpoint format round-trips plain,
int8, fp8 and int4 parameters bit for bit, and ``server --model`` serves a
loaded directory.  Mirrors ``tests/test_checkpoint_and_loaders.py``."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401 (JAX's bf16 numpy type)
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file
from transformers import (LlamaConfig, LlamaForCausalLM, Qwen2Config,
                          Qwen2ForCausalLM)

from samd_tpu.models.loader import load_llama as jax_load_llama
from samd_tpu_torch.bridge import params_from_jax
from samd_tpu_torch.config import GenerationConfig
from samd_tpu_torch.models import tiny_config
from samd_tpu_torch.models.checkpoint import load_params, save_params
from samd_tpu_torch.models.loader import (checkpoint_eos, load_llama,
                                          read_safetensors)
from samd_tpu_torch.ops.quant import (INT4, Int4Tensor, QuantizedTensor,
                                      quantize_llama_params, tensors)
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             rms_norm_eps=1e-6, tie_word_embeddings=False)


def save_hf(path, family="llama", dtype=torch.float32, seed=1, **kw):
    cls = {"llama": (LlamaConfig, LlamaForCausalLM),
           "qwen2": (Qwen2Config, Qwen2ForCausalLM)}[family]
    torch.manual_seed(seed)
    model = cls[1](cls[0](**SMALL, attn_implementation="eager")).eval()
    model.to(dtype).save_pretrained(str(path), **kw)
    return str(path)


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def assert_same_params(got, want):
    """Every leaf of the port's tree bitwise equal to the bridged JAX
    tree's, with the same dtype and shape."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def from_jax(model_dir, jdtype, tdtype):
    _, jp = jax_load_llama(model_dir, dtype=jdtype)
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), tdtype


@pytest.mark.parametrize("family,save_kw,tdtype", [
    ("llama", {}, torch.float32),
    ("llama", {}, torch.bfloat16),
    ("qwen2", {}, torch.float32),
    ("llama", dict(max_shard_size="60KB"), torch.float32),
    ("llama", dict(safe_serialization=False), torch.float32)],
    ids=["llama-f32", "llama-bf16", "qwen2", "sharded", "bin"])
def test_loader_equals_jax(tmp_path, family, save_kw, tdtype):
    d = save_hf(tmp_path / "hf", family, **save_kw)
    if "max_shard_size" in save_kw:
        assert len(list((tmp_path / "hf").glob("*.safetensors"))) > 1
    cfg, params = load_llama(d, dtype=tdtype, device="cpu")
    jdtype = jnp.float32 if tdtype == torch.float32 else jnp.bfloat16
    want, _ = from_jax(d, jdtype, tdtype)
    assert_same_params(params, want)
    assert cfg.num_layers == 2 and cfg.vocab_size == 256
    assert cfg.attn_bias == (family == "qwen2")
    assert ("bq" in params["layers"]) == (family == "qwen2")


def test_f16_checkpoint_cast_like_jax(tmp_path):
    """An f16 checkpoint served in bf16: each value goes through f32, as
    the reference casts it, and the bits equal JAX's."""
    d = save_hf(tmp_path / "hf", dtype=torch.float16)
    _, params = load_llama(d, dtype=torch.bfloat16, device="cpu")
    want, _ = from_jax(d, jnp.bfloat16, torch.bfloat16)
    assert_same_params(params, want)


def test_loaded_model_matches_hf_logits(tmp_path):
    """The loaded weights through the port's forward give HF's logits."""
    from samd_tpu_torch.cache import init_kv_cache
    from samd_tpu_torch.models import forward, prefill_mask

    torch.manual_seed(1)
    model = LlamaForCausalLM(LlamaConfig(
        **SMALL, attn_implementation="eager")).eval()
    model.save_pretrained(str(tmp_path / "hf"))
    cfg, params = load_llama(str(tmp_path / "hf"), dtype=torch.float32,
                             device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(1, 9)))
    with torch.no_grad():
        ref = model(tokens).logits
        kv_k, kv_v = init_kv_cache(cfg, 1, 32, "cpu")
        logits, _ = forward(params, cfg, tokens, torch.arange(9)[None],
                            kv_k, kv_v, 0, prefill_mask(1, 9, 32))
    torch.testing.assert_close(logits, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_reader_equals_safetensors(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    want = {"a": torch.randn(3, 5, generator=g).to(dtype),
            "b.c": torch.randn(7, generator=g).to(dtype),
            "empty": torch.zeros(0, 4, dtype=dtype)}
    save_file(want, str(tmp_path / "x.safetensors"),
              metadata={"format": "pt"})
    got = read_safetensors(str(tmp_path / "x.safetensors"))
    ref = load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == dtype and torch.equal(got[k], ref[k])


def test_reader_refuses_other_dtypes(tmp_path):
    save_file({"q": torch.zeros(4, dtype=torch.int8)},
              str(tmp_path / "x.safetensors"))
    with pytest.raises(ValueError, match="I8"):
        read_safetensors(str(tmp_path / "x.safetensors"))


def write_config(d, **kw):
    d.mkdir()
    cfg = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 512, "rms_norm_eps": 1e-6, **kw}
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.mark.parametrize("kw,exc,match", [
    # a Mixtral config is read now; a directory without weights raises
    (dict(model_type="mixtral", num_local_experts=4), FileNotFoundError,
     "no weights"),
    (dict(rope_scaling={"rope_type": "llama3", "factor": 8.0}),
     NotImplementedError, "rope_scaling"),
    (dict(rope_scaling={"type": "linear", "factor": 2.0}),
     NotImplementedError, "rope_scaling")],
    ids=["mixtral", "llama3-rope", "linear-rope"])
def test_loader_refuses(tmp_path, kw, exc, match):
    d = write_config(tmp_path / "hf", **kw)
    with pytest.raises(exc, match=match):
        load_llama(d, device="cpu")


@pytest.mark.parametrize("kw", [dict(attention_bias=True),
                                dict(mlp_bias=True)],
                         ids=["o_proj-bias", "mlp-bias"])
def test_loader_refuses_unused_tensors(tmp_path, kw):
    """A checkpoint whose tensors the port would not use (Llama's o_proj
    or MLP biases) raises rather than serving without them."""
    torch.manual_seed(1)
    LlamaForCausalLM(LlamaConfig(**SMALL, **kw)).save_pretrained(
        str(tmp_path / "hf"))
    with pytest.raises(ValueError, match="does not use"):
        load_llama(str(tmp_path / "hf"), dtype=torch.float32, device="cpu")


def test_convert_state_dict_missing_and_tied(tmp_path):
    """A missing layer tensor raises; a tied model's saved ``lm_head``
    is the embedding's and is skipped; pairs convert as the dict does."""
    from samd_tpu_torch.models.configs import from_hf_config
    from samd_tpu_torch.models.loader import convert_state_dict

    torch.manual_seed(1)
    model = LlamaForCausalLM(LlamaConfig(**{**SMALL,
                                            "tie_word_embeddings": True}))
    sd = model.state_dict()
    cfg = from_hf_config(model.config, dtype=torch.float32)
    assert cfg.tie_embeddings and "lm_head.weight" in sd
    params = convert_state_dict(sd, cfg, "cpu")
    assert "lm_head" not in params
    assert_same_params(convert_state_dict(iter(sd.items()), cfg, "cpu"),
                       params)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj"):
        convert_state_dict(sd, cfg, "cpu")


def test_default_rope_scaling_and_eos(tmp_path):
    """A ``rope_scaling`` of the default rope loads; ``checkpoint_eos``
    reads config.json's end token, the first of a list."""
    from samd_tpu_torch.models.configs import from_hf_config
    from samd_tpu_torch.models.loader import read_hf_config

    d = write_config(tmp_path / "hf", rope_scaling={"rope_type": "default"},
                     eos_token_id=[7, 9])
    assert from_hf_config(read_hf_config(d)).head_dim == 16
    assert checkpoint_eos(d) == 7
    assert checkpoint_eos(write_config(tmp_path / "b")) is None


def test_loader_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    d = save_hf(tmp_path / "hf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_llama(d)


# ---------------------------------------------------------------------------
# the port's checkpoint format
# ---------------------------------------------------------------------------

def random_params(dtype):
    from samd_tpu_torch.models import init_params

    g = torch.Generator().manual_seed(3)
    cfg = tiny_config(vocab_size=128, dtype=dtype)
    return cfg, init_params(cfg, g, scale=0.4, device="cpu")


def same_leaf(a, b):
    assert type(a) is type(b)
    for x, y in zip(tensors(a), tensors(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn),
    (torch.float32, INT4)], ids=["f32", "bf16", "int8", "fp8", "int4"])
def test_checkpoint_round_trip_bitwise(tmp_path, dtype, quant):
    import dataclasses

    cfg, params = random_params(dtype)
    cfg = dataclasses.replace(cfg, kv_quant=True)
    if quant is not None:
        params = quantize_llama_params(params, dtype=quant)
    save_params(str(tmp_path / "ckpt"), params, cfg)
    meta = json.loads((tmp_path / "ckpt" / "model_config.json").read_text())
    assert meta["dtype"] == str(dtype).removeprefix("torch.")
    cfg2, params2 = load_params(str(tmp_path / "ckpt"), device="cpu")
    assert cfg2 == cfg
    a, b = dict(leaves(params)), dict(leaves(params2))
    assert a.keys() == b.keys()
    for k in a:
        same_leaf(a[k], b[k])
    kinds = {QuantizedTensor: "quantized", Int4Tensor: "int4"}
    want = kinds.get(type(params["layers"]["wq"]), "tensor")
    stored = json.loads((tmp_path / "ckpt" / "leaves.json").read_text())
    assert stored["layers.wq"] == want and stored["embed"] == "tensor"


def test_checkpoint_keys_match_jax(tmp_path):
    """model_config.json carries the reference's keys."""
    import dataclasses

    from samd_tpu.models import tiny_config as jax_tiny

    cfg, params = random_params(torch.float32)
    save_params(str(tmp_path / "ckpt"), params, cfg)
    meta = json.loads((tmp_path / "ckpt" / "model_config.json").read_text())
    assert set(meta) == {f.name for f in dataclasses.fields(jax_tiny())}


def test_server_serves_model_dir(tmp_path):
    """``server --model DIR`` loads the directory and takes its end token."""
    from samd_tpu_torch.fused_sam import (FusedSamConfig,
                                          PagedBatchedFusedSamEngine)
    from samd_tpu_torch.server import build_server_engine

    d = save_hf(tmp_path / "hf")
    cfg = json.loads((tmp_path / "hf" / "config.json").read_text())
    cfg["eos_token_id"] = 5
    (tmp_path / "hf" / "config.json").write_text(json.dumps(cfg))
    args = SimpleNamespace(model=d, random_model=False, tiny=False,
                           engine="paged_fused_sam", batch_size=2,
                           quantize=None, max_cache_len=256, sam=None,
                           cpu=True, inline_prefill=False)
    eng = build_server_engine(args)
    assert eng.eos_token_id == 5
    gen = GenerationConfig(max_new_tokens=12, max_cache_len=256)
    prompts = [[9, 10, 11, 12], list(range(30, 50))]
    rids = [eng.add_request(p, gen) for p in prompts]
    got = eng.run()
    mcfg, params = load_llama(d, device="cpu")
    ref = PagedBatchedFusedSamEngine(
        mcfg, params, FusedSamConfig(steps_per_call=16, n_predicts=15),
        batch_size=2, max_cache_len=256, eos_token_id=5, device="cpu")
    rids2 = [ref.add_request(p, gen) for p in prompts]
    want = ref.run()
    for r, r2 in zip(rids, rids2):
        assert got[r].output_ids == want[r2].output_ids
