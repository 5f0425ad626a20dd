"""Checkpoint loading: a local HF model directory (Llama / Qwen2 families)
→ the port's parameter dict (counterpart of ``samd_tpu/models/loader.py``).

A directory holds ``config.json`` and either safetensors shards (every
``*.safetensors``, in sorted order) or PyTorch ``*.bin`` files.  The
safetensors files are read by ``read_safetensors``, written here against
the format (an 8-byte little-endian header length, a JSON header of
``dtype``, ``shape`` and ``data_offsets``, then the raw bytes), so no
package beyond torch is needed.  Weights are converted once into the
stacked-layer layout of ``models.llama`` (HF's ``[out, in]`` linear
weights transposed to ``[in, out]``) in the serving dtype, on the serving
device, one file in host memory at a time.  A Mixtral directory's
``block_sparse_moe`` tensors become the router and the ``[L, E, in, out]``
expert stacks of the reference's layout.

``build_params`` is the front ends' one way to a model: ``--model DIR``,
or ``--random-model`` (llama_1b, a tiny config with ``--tiny``, the
family from ``--family``), quantized by ``--quantize``.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from dataclasses import replace
from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

import torch

from ..device import resolve_device
from .configs import ModelConfig, from_hf_config
from .llama import Params

# the safetensors dtypes the reader takes
ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over one
    buffer that the file's data is read into once.  A dtype other than
    F32, F16 or BF16 raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the file ends inside its data")
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{spec['dtype']}; the reader takes "
                             f"{sorted(ST_DTYPES)}")
        dtype = ST_DTYPES[spec["dtype"]]
        start, end = spec["data_offsets"]
        count = (end - start) // dtype.itemsize
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=start) \
            if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(spec["shape"])
    return out


def _iter_checkpoint_tensors(model_dir: str
                             ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) from safetensors shards or PyTorch .bin files,
    one file in host memory at a time."""
    entries = sorted(os.listdir(model_dir))
    st_files = [f for f in entries if f.endswith(".safetensors")]
    if st_files:
        for f in st_files:
            yield from read_safetensors(os.path.join(model_dir, f)).items()
        return
    bin_files = [f for f in entries if f.endswith(".bin")]
    if not bin_files:
        raise FileNotFoundError(f"no weights found in {model_dir}")
    for f in bin_files:
        yield from torch.load(os.path.join(model_dir, f), map_location="cpu",
                              weights_only=True).items()


def read_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def checkpoint_eos(model_dir: str) -> Optional[int]:
    """The ``eos_token_id`` of a directory's ``config.json`` (the first,
    where it lists several), or None."""
    eos = read_hf_config(model_dir).get("eos_token_id")
    if isinstance(eos, list):
        eos = eos[0] if eos else None
    return eos


def load_llama(model_dir: str, dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda"
               ) -> Tuple[ModelConfig, Params]:
    """(config, parameters on ``device`` in ``dtype``) of a local HF
    directory; the family follows ``config.json``'s ``model_type``."""
    dev = resolve_device(device)
    cfg = from_hf_config(read_hf_config(model_dir), dtype=dtype)
    return cfg, convert_state_dict(_iter_checkpoint_tensors(model_dir), cfg,
                                   dev)


# ``load_llama`` dispatches on the checkpoint's model_type, so it is the
# generic loader, as in the reference.
load_model = load_llama

# HF's per-layer tensors: (the port's leaf, HF's name under
# ``model.layers.{i}.``, transposed from HF's [out, in])
LAYER_LEAVES = (
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("mlp_norm", "post_attention_layernorm.weight", False))
MLP_LEAVES = (("w_gate", "mlp.gate_proj.weight", True),
              ("w_up", "mlp.up_proj.weight", True),
              ("w_down", "mlp.down_proj.weight", True))
# Mixtral (samd_tpu/models/loader.py:101-113): the router, and expert e's
# w1/w3/w2 into slot e of the [L, E, in, out] gate/up/down stacks
MOE_LEAVES = (("router", "block_sparse_moe.gate.weight", True),)
EXPERT_LEAVES = (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))
BIAS_LEAVES = (("bq", "self_attn.q_proj.bias", False),
               ("bk", "self_attn.k_proj.bias", False),
               ("bv", "self_attn.v_proj.bias", False))
# the other tensors: HF's name → (the port's leaf, transposed)
TOP_LEAVES = {"model.embed_tokens.weight": ("embed", False),
              "model.norm.weight": ("final_norm", False),
              "lm_head.weight": ("lm_head", True)}


def convert_state_dict(sd: Union[Dict[str, torch.Tensor],
                                 Iterable[Tuple[str, torch.Tensor]]],
                       cfg: ModelConfig,
                       device: Union[str, torch.device] = "cuda") -> Params:
    """An HF state dict (a dict of torch tensors, or (name, tensor)
    pairs) → the port's stacked-layer parameters on ``device`` in
    ``cfg.dtype``.  Qwen2 adds the q/k/v biases (``cfg.attn_bias``);
    Mixtral (``cfg.num_experts``) has a router and expert stacks in place
    of the MLP.  A
    tensor of another dtype is cast through f32, as the reference casts
    it; one already in ``cfg.dtype`` keeps its bits.

    Each tensor goes to the device as it arrives and is copied into its
    slot of a stacked ``[L, ...]`` leaf, so no second copy of a stacked
    leaf is made.  A tensor the conversion does not use (an ``o_proj``
    or MLP bias, a layer or expert past the config's) raises, as does a
    missing one: no weight is dropped in silence."""
    L, E = cfg.num_layers, cfg.num_experts
    # HF's name under the layer → (leaf, transposed, expert slot or None)
    per_layer = {hf: (key, tr, None) for key, hf, tr in
                 LAYER_LEAVES + (BIAS_LEAVES if cfg.attn_bias else ())
                 + (MOE_LEAVES if E else MLP_LEAVES)}
    per_layer.update({f"block_sparse_moe.experts.{e}.{w}.weight":
                      (key, True, e)
                      for e in range(E) for key, w in EXPERT_LEAVES})
    layers: Dict[str, torch.Tensor] = {}
    filled = set()
    top: Params = {}
    unused = []
    for name, t in (sd.items() if isinstance(sd, dict) else sd):
        parts = name.split(".", 3)
        if (len(parts) == 4 and parts[:2] == ["model", "layers"]
                and parts[2].isdigit() and int(parts[2]) < L
                and parts[3] in per_layer):
            key, tr, e = per_layer[parts[3]]
        elif name in TOP_LEAVES and not (name == "lm_head.weight"
                                         and cfg.tie_embeddings):
            key, tr = TOP_LEAVES[name]
        elif (name == "lm_head.weight"         # tied: the embedding serves
              or name.endswith("rotary_emb.inv_freq")):    # a buffer
            continue
        else:
            unused.append(name)
            continue
        t = t.detach().to(device, copy=True)
        if t.dtype != cfg.dtype:
            t = t.float().to(cfg.dtype)
        t = t.T if tr else t
        if name in TOP_LEAVES:
            top[key] = t.contiguous()
            continue
        slot = (int(parts[2]),) if e is None else (int(parts[2]), e)
        if key not in layers:
            stack = (L,) if e is None else (L, E)
            layers[key] = torch.empty((*stack, *t.shape), dtype=t.dtype,
                                      device=t.device)
        layers[key][slot].copy_(t)
        filled.add((parts[3], int(parts[2])))
    if unused:
        raise ValueError(
            f"the checkpoint holds {len(unused)} tensors the port does not "
            f"use (first: {sorted(unused)[:4]}); refusing to drop weights")
    missing = [f"model.layers.{i}.{hf}" for hf in per_layer
               for i in range(L) if (hf, i) not in filled]
    missing += [n for n, (key, _) in TOP_LEAVES.items()
                if key in ("embed", "final_norm") and key not in top]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} tensors "
                       f"(first: {missing[:4]})")
    params: Params = {"embed": top["embed"],
                      "layers": {key: layers[key]
                                 for key, _, _ in per_layer.values()},
                      "final_norm": top["final_norm"]}
    if not cfg.tie_embeddings:
        params["lm_head"] = (top["lm_head"] if "lm_head" in top
                             else params["embed"].T.contiguous())
    return params


# ---------------------------------------------------------------------------
# the front ends' model: the CLI and the server build it here
# ---------------------------------------------------------------------------

TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model",
                   "tokenizer_config.json")


def load_tokenizer(model_dir: str):
    """The directory's HF tokenizer, or None (with a one-line notice) when
    it has none or transformers cannot load it."""
    if not any(os.path.exists(os.path.join(model_dir, f))
               for f in TOKENIZER_FILES):
        print(f"(token-id mode: {model_dir} holds no tokenizer)",
              file=sys.stderr)
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_dir)
    except (ImportError, OSError, ValueError) as e:
        print(f"(token-id mode: the tokenizer did not load: {e!r})",
              file=sys.stderr)
        return None


def quant_dtype(name: Optional[str]):
    """The weight type of a ``--quantize`` choice; None for none."""
    if name in (None, "none"):
        return None
    from ..ops.quant import INT4

    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "int4": INT4}[name]


def random_config(family: str, tiny: bool) -> ModelConfig:
    """``--random-model``'s config: llama_1b, or with ``tiny`` a tiny
    config of 256 tokens, of the family ``llama``, ``qwen2`` or ``moe``
    (the reference CLI's shapes, ``samd_tpu/cli.py:35-52``)."""
    from . import llama_1b, tiny_config, tiny_moe_config, tiny_qwen2_config

    if tiny:
        cfg = {"llama": tiny_config, "qwen2": tiny_qwen2_config,
               "moe": tiny_moe_config}[family](vocab_size=256)
    elif family == "qwen2":
        # a 1B-class Qwen2-family shape (qkv biases, 1e6 rope)
        cfg = replace(llama_1b(), attn_bias=True, rope_theta=1e6)
    elif family == "moe":
        # 8 experts at half the trunk's FFN width, top-2
        cfg = replace(llama_1b(), intermediate_size=2816, num_experts=8,
                      num_experts_per_tok=2)
    else:
        cfg = llama_1b()
    return cfg


def random_model(family: str, tiny: bool, device):
    """(``random_config(family, tiny)``, random parameters from a
    generator seeded 0 on ``device``)."""
    from . import init_params

    cfg = random_config(family, tiny)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def build_params(args, device):
    """(config, parameters, end token, tokenizer or None) for a front
    end's arguments: ``args.model`` (a local HF directory: its tokenizer
    when it has one, its ``config.json`` end token, else the tokenizer's,
    else none) or ``args.random_model`` (``random_model`` over
    ``args.family`` and ``args.tiny``; no tokenizer, no end token), the
    weights quantized to ``args.quantize``."""
    if args.random_model:
        cfg, params = random_model(getattr(args, "family", "llama"),
                                   args.tiny, device)
        tokenizer, eos = None, None
    else:
        cfg, params = load_llama(args.model, device=device)
        tokenizer = load_tokenizer(args.model)
        eos = checkpoint_eos(args.model)
        if eos is None and tokenizer is not None:
            eos = tokenizer.eos_token_id
    qdtype = quant_dtype(args.quantize)
    if qdtype is not None:
        from ..ops.quant import quantize_llama_params

        params = quantize_llama_params(params, dtype=qdtype)
    return cfg, params, -1 if eos is None else eos, tokenizer
