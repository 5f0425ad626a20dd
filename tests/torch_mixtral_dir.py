"""A small Mixtral checkpoint directory for the port's tests: HF's
config and tensor names, seeded numpy weights, two safetensors shards."""

import json

import numpy as np
import torch
from safetensors.torch import save_file

HF_MIXTRAL = dict(model_type="mixtral", vocab_size=256, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  num_local_experts=4, num_experts_per_tok=2,
                  max_position_embeddings=512, rms_norm_eps=1e-6,
                  rope_theta=10000.0, tie_word_embeddings=False)


def mixtral_state(seed=1, E=4, L=2, extra=()):
    """HF Mixtral tensors [out, in] from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    H, I, V, NH, KH, D = 64, 128, 256, 4, 2, 16

    def w(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.1).astype(np.float32))

    sd = {"model.embed_tokens.weight": w(V, H),
          "model.norm.weight": 1 + w(H), "lm_head.weight": w(V, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(H),
                   p + "post_attention_layernorm.weight": 1 + w(H),
                   p + "self_attn.q_proj.weight": w(NH * D, H),
                   p + "self_attn.k_proj.weight": w(KH * D, H),
                   p + "self_attn.v_proj.weight": w(KH * D, H),
                   p + "self_attn.o_proj.weight": w(H, NH * D),
                   p + "block_sparse_moe.gate.weight": w(E, H)})
        for e in range(E):
            m = f"{p}block_sparse_moe.experts.{e}."
            sd.update({m + "w1.weight": w(I, H), m + "w3.weight": w(I, H),
                       m + "w2.weight": w(H, I)})
    for name in extra:
        sd[name] = w(4)
    return sd


def write_mixtral(d, sd=None, **cfg):
    d.mkdir()
    sd = mixtral_state() if sd is None else sd
    names = sorted(sd)
    save_file({n: sd[n] for n in names[:len(names) // 2]},
              str(d / "model-00001-of-00002.safetensors"))
    save_file({n: sd[n] for n in names[len(names) // 2:]},
              str(d / "model-00002-of-00002.safetensors"))
    (d / "config.json").write_text(json.dumps({**HF_MIXTRAL, **cfg}))
    return str(d)
