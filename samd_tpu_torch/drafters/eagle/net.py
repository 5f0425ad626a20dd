"""The EAGLE draft network (counterpart of
``samd_tpu/drafters/eagle/net.py``): one Llama-style decoder layer over the
fused input (token embedding ⊕ the target's hidden state).

A linear ``fc: 2H → H`` fuses the embedding of token t + 1 with the target
model's hidden state at t; one decoder layer, with no input norm before its
attention (the EAGLE convention), predicts the target's next hidden state,
which the target's own head decodes.  The net shares the target's building
blocks (``models.llama``) and keeps one layer of KV, ``[B, KH, S, D]``, in
place.  Its matmuls are plain (``ops.quant.qmatmul``, so int8 weights from
``ops.quant.quantize_eagle_params`` dequantize first) and so is its
attention (``models.llama._attention`` over every cache column): no kernel
of the port runs here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...models.configs import ModelConfig
from ...models.llama import _attention, apply_rope, rms_norm, rope_tables
from ...ops.quant import qmatmul


@dataclass(frozen=True)
class EagleNetConfig:
    hidden_size: int
    intermediate_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_target(cls, cfg: ModelConfig) -> "EagleNetConfig":
        return cls(hidden_size=cfg.hidden_size,
                   intermediate_size=cfg.intermediate_size,
                   num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                   rms_eps=cfg.rms_eps, dtype=cfg.dtype)

    @property
    def kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


def init_eagle_params(cfg: EagleNetConfig, generator: torch.Generator, *,
                      scale: float = 0.02,
                      device: Union[str, torch.device] = "cuda") -> Dict:
    """Random-normal draft-net parameters drawn from ``generator`` (which
    must live on ``device``).  torch cannot replay JAX's threefry draws,
    so tests carry JAX's net across with ``bridge.eagle_params_from_jax``."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def norm(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(cfg.dtype)

    return {
        "fc_w": norm(2 * H, H),
        "fc_b": torch.zeros((H,), dtype=cfg.dtype, device=device),
        "wq": norm(H, NH * D),
        "wk": norm(H, KH * D),
        "wv": norm(H, KH * D),
        "wo": norm(NH * D, H),
        "mlp_norm": torch.ones((H,), dtype=cfg.dtype, device=device),
        "w_gate": norm(H, I),
        "w_up": norm(H, I),
        "w_down": norm(I, H),
    }


def init_eagle_kv(cfg: EagleNetConfig, batch: int, max_len: int,
                  device: Union[str, torch.device] = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def eagle_forward(params: Dict, cfg: EagleNetConfig, embeds: torch.Tensor,
                  prev_hidden: torch.Tensor, position_ids: torch.Tensor,
                  kv_k: torch.Tensor, kv_v: torch.Tensor,
                  write_offset: torch.Tensor, attn_mask: torch.Tensor
                  ) -> torch.Tensor:
    """One draft-net step.

    embeds, prev_hidden: [B, T, H]; position_ids: [B, T]; kv_k, kv_v:
    [B, KH, S, D], written IN PLACE: each slot's T new rows go to columns
    ``write_offset[b] + t`` (write_offset [B]; the caller keeps them below
    S); attn_mask: [B, T, S] bool.  Returns the hidden states [B, T, H]."""
    B, T, _ = embeds.shape
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = torch.cat([embeds.to(cfg.dtype), prev_hidden.to(cfg.dtype)], dim=-1)
    h = qmatmul(x, params["fc_w"]) + params["fc_b"]
    # EAGLE: no input norm before the (only) attention block
    cos, sin = rope_tables(position_ids, D, cfg.rope_theta)
    q = apply_rope(qmatmul(h, params["wq"]).reshape(B, T, NH, D), cos, sin)
    k = apply_rope(qmatmul(h, params["wk"]).reshape(B, T, KH, D), cos, sin)
    v = qmatmul(h, params["wv"]).reshape(B, T, KH, D)
    rows = torch.arange(B, device=h.device)[:, None]
    cols = (write_offset.to(torch.int64)[:, None]
            + torch.arange(T, device=h.device)[None, :])
    kv_k[rows, :, cols] = k
    kv_v[rows, :, cols] = v
    h = h + qmatmul(_attention(q, kv_k, kv_v, attn_mask, cfg), params["wo"])
    xm = rms_norm(h, params["mlp_norm"], cfg.rms_eps)
    gated = F.silu(qmatmul(xm, params["w_gate"])) * qmatmul(xm, params["w_up"])
    return h + qmatmul(gated, params["w_down"])


def convert_eagle_state_dict(sd: Dict, cfg: EagleNetConfig,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Dict:
    """An official EAGLE checkpoint's state dict (``pytorch_model.bin``:
    torch tensors or numpy arrays, linear weights ``[out, in]``) → the
    net's parameters on ``device`` in ``cfg.dtype``."""

    def get(name):
        arr = sd[name]
        if isinstance(arr, torch.Tensor):
            return arr.detach().to(torch.float32).cpu()
        return torch.from_numpy(np.asarray(arr, dtype=np.float32))

    def lin(name):
        return get(name).T.contiguous().to(device=device, dtype=cfg.dtype)

    def vec(name):
        return get(name).to(device=device, dtype=cfg.dtype)

    p = "layers.0."
    return {
        "fc_w": lin("fc.weight"),
        "fc_b": (vec("fc.bias") if "fc.bias" in sd else torch.zeros(
            (cfg.hidden_size,), dtype=cfg.dtype, device=device)),
        "wq": lin(p + "self_attn.q_proj.weight"),
        "wk": lin(p + "self_attn.k_proj.weight"),
        "wv": lin(p + "self_attn.v_proj.weight"),
        "wo": lin(p + "self_attn.o_proj.weight"),
        "mlp_norm": vec(p + "post_attention_layernorm.weight"),
        "w_gate": lin(p + "mlp.gate_proj.weight"),
        "w_up": lin(p + "mlp.up_proj.weight"),
        "w_down": lin(p + "mlp.down_proj.weight"),
    }
