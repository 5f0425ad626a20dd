"""Sharding rules: megatron-style parallelism over a mesh of ranks
(counterpart of ``samd_tpu/parallel/sharding.py``).

The reference places weights and KV on a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives; here a ``Mesh`` holds the world's ranks
reshaped ``("dp", "pp", "ep", "tp")``, ``shard_params`` and ``shard_kv``
hand each rank its own slice of every leaf on its device, and
``models.llama.forward(..., mesh=)`` calls ``parallel.comm`` where GSPMD
would insert a psum or an all-gather.

Layout (``param_specs``, the reference's axis names per dimension):
  * column-parallel: wq/wk/wv, w_gate/w_up  → output dim over "tp"
  * row-parallel:    wo, w_down             → input dim over "tp"
  * embed rows and lm_head columns over "tp" (the vocabulary)
  * every layer-stacked leaf's layer axis over "pp"
  * MoE stacks: experts over "ep", each expert's SwiGLU over "tp"
  * KV cache [L, B, KH, S, D]: layers over "pp", batch over "dp", KV heads
    over "tp" (``kv_spec``)

Quantized leaves follow ``_put_leaf``: an int8/fp8 ``QuantizedTensor``'s
values take the weight's spec and its per-channel scale the spec without
the contraction axis; a packed int4 ``Int4Tensor`` stays whole over every
axis but "pp", as in the reference, whose Pallas kernel GSPMD could not
split: each rank streams the whole packed array; the forward keeps its
heads' columns of q/k/v, gathers wo's input, and runs an MLP of whole
int4 weights whole, with no collective
(``ops.int4_matmul.int4_matmul_tp`` is the per-shard streaming form).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..cache import QuantizedKV
from ..device import resolve_device
from ..models.configs import ModelConfig
from ..ops.quant import Int4Tensor, QuantizedTensor
from .comm import Axis, CommStats

AXES = ("dp", "pp", "ep", "tp")
Spec = Tuple[Optional[str], ...]


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: ``cuda:<local rank mod device count>`` for
    "cuda" (the local rank from ``LOCAL_RANK``, else the global rank), or
    the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


class Mesh:
    """The world's ranks reshaped ``(dp, pp, ep, tp)``: ``shape`` (axis →
    size), this rank's ``coords`` (axis → index), its ``device``, one
    ``comm.Axis`` per axis (``axis(name)``) and the ``comm.CommStats`` of
    the collectives run over them (``stats``).  Building one calls
    ``torch.distributed.new_group`` for every slice of every axis longer
    than one, in the same order on every rank, so every rank builds its
    meshes in the same order."""

    def __init__(self, dp: int, pp: int, ep: int, tp: int,
                 device: Union[str, torch.device] = "cuda"):
        world, rank = dist.get_world_size(), dist.get_rank()
        self.ranks = np.arange(world).reshape(dp, pp, ep, tp)
        self.shape = dict(zip(AXES, (dp, pp, ep, tp)))
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, self.ranks.shape))))
        self.rank = rank
        self.device = rank_device(device)
        self.stats = CommStats()
        self._axes = {}
        for a, name in enumerate(AXES):
            slices = np.moveaxis(self.ranks, a, -1).reshape(
                -1, self.ranks.shape[a])
            for members in slices.tolist():
                group = dist.new_group(members) if len(members) > 1 else None
                if rank in members:
                    self._axes[name] = Axis(name, len(members),
                                            members.index(rank), members,
                                            group, self.stats)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(num_devices: Optional[int] = None, *, dp: int = 1,
              pp: int = 1, ep: int = 1,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """Mesh with axes ("dp", "pp", "ep", "tp") over every rank of the
    initialized world; dp/pp/ep default to 1, so the common tensor-parallel
    case is a (1, 1, 1, tp) mesh.  ``num_devices``, when given, must be the
    world size (one rank per mesh position)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "parallel.multihost.init_distributed, or "
            "torch.distributed.init_process_group, first")
    n = dist.get_world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"num_devices={num_devices}, but the world has {n} "
                         "ranks (one rank per mesh position)")
    if n % (dp * pp * ep) != 0:
        raise ValueError(
            f"{n} devices not divisible by dp*pp*ep={dp * pp * ep}")
    return Mesh(dp, pp, ep, n // (dp * pp * ep), device)


def check_shardable(cfg: ModelConfig, mesh: Mesh) -> None:
    tp = mesh.shape["tp"]
    pp = mesh.shape.get("pp", 1)
    ep = mesh.shape.get("ep", 1)
    for name, dim in [("num_kv_heads", cfg.num_kv_heads),
                      ("num_heads", cfg.num_heads),
                      ("intermediate_size", cfg.intermediate_size),
                      ("vocab_size", cfg.vocab_size)]:
        if dim % tp != 0:
            raise ValueError(f"{name}={dim} not divisible by tp={tp}")
    if cfg.num_layers % pp != 0:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by pp={pp}")
    if ep > 1 and cfg.num_experts % ep != 0:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by ep={ep}")


def param_specs(cfg: ModelConfig) -> dict:
    """Axis names per dimension for every leaf of
    ``models.llama.init_params``, the reference's ``PartitionSpec``s as
    tuples."""
    if cfg.num_experts:
        mlp = {
            "router": ("pp", None, None),
            "w_gate": ("pp", "ep", None, "tp"),
            "w_up": ("pp", "ep", None, "tp"),
            "w_down": ("pp", "ep", "tp", None),
        }
    else:
        mlp = {
            "w_gate": ("pp", None, "tp"),
            "w_up": ("pp", None, "tp"),
            "w_down": ("pp", "tp", None),
        }
    specs = {
        "embed": ("tp", None),
        "layers": {
            "attn_norm": ("pp", None),
            "wq": ("pp", None, "tp"),
            "wk": ("pp", None, "tp"),
            "wv": ("pp", None, "tp"),
            "wo": ("pp", "tp", None),
            "mlp_norm": ("pp", None),
            **mlp,
        },
        "final_norm": (None,),
    }
    if cfg.attn_bias:
        specs["layers"]["bq"] = ("pp", "tp")
        specs["layers"]["bk"] = ("pp", "tp")
        specs["layers"]["bv"] = ("pp", "tp")
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def kv_spec() -> Spec:
    return ("pp", "dp", "tp", None, None)


def local_slice(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, on the mesh's device, in
    storage of its own (a tensor that needs no cut and already lies there
    is returned as it is)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not fit a tensor of shape "
                         f"{tuple(t.shape)}")
    cut = False
    for dim, name in enumerate(spec):
        n = mesh.shape[name] if name else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide by {name}={n}")
        c = t.shape[dim] // n
        t = t.narrow(dim, mesh.coords[name] * c, c)
        cut = True
    if not cut and t.device == mesh.device and t.is_contiguous():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=mesh.device)
    out.copy_(t)
    return out


def _drop_contraction(s: Spec) -> Spec:
    return tuple(e for i, e in enumerate(s) if i != len(s) - 2)


def _put_leaf(s: Spec, x, mesh: Mesh):
    """This rank's part of one parameter leaf under spec ``s``, quantized
    leaves included: a ``QuantizedTensor``'s scale drops the contraction
    (-2) axis of the weight's spec; an ``Int4Tensor`` keeps only "pp" and
    stays whole over the other axes (the module docstring says why)."""
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(local_slice(x.q, s, mesh),
                               local_slice(x.scale, _drop_contraction(s),
                                           mesh))
    if isinstance(x, Int4Tensor):
        pp_only = tuple(e if e == "pp" else None for e in s)
        return Int4Tensor(local_slice(x.packed, pp_only, mesh),
                          local_slice(x.scale, _drop_contraction(pp_only),
                                      mesh))
    return local_slice(x, s, mesh)


def shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """This rank's slice of a parameter dict (plain, int8/fp8
    ``QuantizedTensor`` or packed-int4 ``Int4Tensor`` leaves) per
    ``param_specs``, on the mesh's device."""
    def walk(specs, node):
        if isinstance(node, dict):
            return {k: walk(specs[k], v) for k, v in node.items()}
        return _put_leaf(specs, node, mesh)

    return walk(param_specs(cfg), params)


def shard_kv(kv_k, kv_v, mesh: Mesh):
    """This rank's ``[L/pp, B/dp, KH/tp, S, D]`` block of a dense cache.
    An int8 ``QuantizedKV`` raises, as the reference has no spec for it."""
    if isinstance(kv_k, QuantizedKV) or isinstance(kv_v, QuantizedKV):
        raise ValueError("int8 KV under a mesh needs a QuantizedKV sharding "
                         "spec")
    return local_slice(kv_k, kv_spec(), mesh), \
        local_slice(kv_v, kv_spec(), mesh)
