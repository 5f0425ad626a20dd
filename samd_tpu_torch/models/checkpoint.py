"""Save and restore the port's parameters (counterpart of
``samd_tpu/models/checkpoint.py``, which writes orbax).

A checkpoint is a directory of three files:

  * ``model_config.json``: the ModelConfig's fields, the keys the
    reference writes, with ``dtype`` as its name ("bfloat16");
  * ``leaves.json``: each leaf's path (keys joined by ".") and kind:
    ``"tensor"``, ``"quantized"`` (``ops.quant.QuantizedTensor``: int8 or
    fp8 values and f32 scales) or ``"int4"`` (``Int4Tensor``: packed bytes
    and f32 scales);
  * ``params.pt``: one flat dict of plain tensors (``torch.save``), read
    back with ``torch.load(weights_only=True)``: nothing pickles a class.

A round trip is bitwise.  The two packages' checkpoints are not
interchangeable: parameters cross from JAX through
``bridge.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple, Union

import torch

from ..device import resolve_device
from ..ops.quant import Int4Tensor, QuantizedTensor
from .configs import ModelConfig
from .llama import Params

# kind → the tensor fields a leaf of that kind is stored as
_FIELDS = {"quantized": ("q", "scale"), "int4": ("packed", "scale")}
_CLASSES = {"quantized": QuantizedTensor, "int4": Int4Tensor}


def _flatten(tree, prefix="") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if "." in k:
            raise ValueError(f"parameter key {k!r} holds a '.'")
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def save_params(path: str, params: Params, cfg: ModelConfig) -> None:
    os.makedirs(path, exist_ok=True)
    kinds, tensors = {}, {}
    for name, leaf in _flatten(params).items():
        if isinstance(leaf, QuantizedTensor):
            kind = "quantized"
        elif isinstance(leaf, Int4Tensor):
            kind = "int4"
        elif isinstance(leaf, torch.Tensor):
            kind = "tensor"
        else:
            raise TypeError(f"{name}: unsupported leaf {type(leaf).__name__}")
        kinds[name] = kind
        if kind == "tensor":
            tensors[name] = leaf.detach().cpu().contiguous()
        else:
            for field in _FIELDS[kind]:
                tensors[f"{name}.{field}"] = \
                    getattr(leaf, field).detach().cpu().contiguous()
    torch.save(tensors, os.path.join(path, "params.pt"))
    meta = dataclasses.asdict(cfg)
    meta["dtype"] = str(cfg.dtype).removeprefix("torch.")
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(path, "leaves.json"), "w") as f:
        json.dump(kinds, f, indent=2)


def load_params(path: str, device: Union[str, torch.device] = "cuda"
                ) -> Tuple[ModelConfig, Params]:
    dev = resolve_device(device)
    with open(os.path.join(path, "model_config.json")) as f:
        meta = json.load(f)
    meta["dtype"] = getattr(torch, meta["dtype"])
    cfg = ModelConfig(**meta)
    with open(os.path.join(path, "leaves.json")) as f:
        kinds = json.load(f)
    tensors = torch.load(os.path.join(path, "params.pt"), map_location="cpu",
                         weights_only=True, mmap=True)
    params: Params = {}
    def take(key):          # a copy, not a view of the mapped file
        return tensors[key].to(dev, copy=True)

    for name, kind in kinds.items():
        if kind == "tensor":
            leaf = take(name)
        else:
            leaf = _CLASSES[kind](*(take(f"{name}.{field}")
                                    for field in _FIELDS[kind]))
        *parents, key = name.split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return cfg, params
