"""Weights from the JAX package into the port, with their bytes unchanged.

The caller converts each JAX leaf to numpy (``jax.tree.map(np.asarray,
params)``) and hands the tree here, so this module never imports JAX.  The
layout is the reference's: a dict with ``embed``, ``final_norm``, optional
``lm_head`` and a ``layers`` dict of arrays stacked on a leading ``[L, ...]``
axis.  bf16 and fp8 numpy arrays (``ml_dtypes``) are reinterpreted bit for
bit.  The reference's quantized leaves (its ``QuantizedTensor`` and
``Int4Tensor`` pytree nodes, whose children ``jax.tree.map`` turns into numpy
arrays) become the port's classes of the same names, their int8, fp8 or
packed bytes and f32 scales unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .ops.quant import Int4Tensor, QuantizedTensor

Params = Dict[str, object]

# ml_dtypes names of the numpy types torch reads through a same-width view
_VIEWED = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(a).__name__}")
    a = np.array(a, order="C", copy=True)   # JAX's numpy views are read-only
    if a.dtype.name in _VIEWED:
        raw, tdtype = _VIEWED[a.dtype.name]
        t = torch.from_numpy(a.view(raw)).view(tdtype)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device).contiguous()


def _leaf(node, device, dtype=None):
    """One leaf: a quantized node's bytes and scales, or a plain array."""
    kind = type(node).__name__
    if kind == "QuantizedTensor":
        return QuantizedTensor(_to_tensor(node.q, device),
                               _to_tensor(node.scale, device))
    if kind == "Int4Tensor":
        return Int4Tensor(_to_tensor(node.packed, device),
                          _to_tensor(node.scale, device))
    return _to_tensor(node, device, dtype)


def eagle_params_from_jax(net: Params, device: Union[str, torch.device]
                          ) -> Params:
    """The reference's EAGLE draft-net parameters (its
    ``drafters.eagle.net`` dict, plain or through
    ``quantize_eagle_params``) with numpy leaves → the port's
    ``drafters.eagle.net`` parameters on ``device``, bytes unchanged."""
    return {k: _leaf(v, device) for k, v in net.items()}


def params_from_jax(tree: Params, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Params:
    """JAX parameter pytree with numpy leaves → the port's dict of tensors
    on ``device``.  ``dtype=None`` keeps each leaf's own type; otherwise
    plain leaves are cast to ``dtype`` and quantized leaves keep theirs.
    A Mixtral tree's ``router`` and ``[L, E, in, out]`` expert stacks cross
    like any other leaf."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, device, dtype)

    return conv(tree)
