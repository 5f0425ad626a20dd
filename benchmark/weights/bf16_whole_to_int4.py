"""The whole bf16 tree drawn on the device, then quantized whole to packed
int4 by the port's ``quantize_llama_params(dtype=INT4)`` (projections and
head; embedding, norms and biases stay bf16), and the bf16 tree freed."""

from __future__ import annotations

import torch

from ..harness import draws


def build(cfg, model_cfg, seed: int, device):
    from samd_tpu_torch.ops.quant import INT4, quantize_llama_params

    L = model_cfg.num_layers
    layers = {}
    for name, shape, kind in draws.layer_leaves(cfg):
        t = torch.empty((L,) + shape, dtype=torch.bfloat16, device=device)
        for layer in range(L):
            t[layer] = draws.leaf(cfg, seed, name, layer, shape, kind,
                                  device)
        layers[name] = t
    params = {"embed": draws.embed(cfg, seed, device), "layers": layers,
              "final_norm": torch.ones(model_cfg.hidden_size,
                                       dtype=torch.bfloat16, device=device),
              "lm_head": draws.lm_head(cfg, seed, device)}
    q4 = quantize_llama_params(params, dtype=INT4)
    del params, layers
    return q4
