"""The weights of a configuration, drawn from the seed.

Every leaf of every layer is drawn from a generator of its own, seeded by
``stream_seed(seed, name, layer)``, on the device and in one call: normal
times the configuration's ``init_scale`` in f32, then cast to bf16; norms
are ones.  So the program's weight route and the reference draw the same
bf16 tensors, each on its own and in any order, and the reference can work
out one layer at a time what the program holds whole.

The leaves and their shapes follow the published config's keys (HF names):
``hidden_size``, ``intermediate_size``, ``num_hidden_layers``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``vocab_size``, and for a Mixtral ``num_local_experts``; a Qwen2 has q/k/v
biases.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one leaf of one run's seed."""
    key = repr((int(seed),) + tuple(parts)).encode()
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def sizes(cfg: Dict) -> Dict[str, int]:
    """The sizes the draws and the reference read from a config file."""
    return dict(
        H=cfg["hidden_size"], I=cfg["intermediate_size"],
        L=cfg["num_hidden_layers"], NH=cfg["num_attention_heads"],
        KH=cfg["num_key_value_heads"], D=cfg["head_dim"],
        V=cfg["vocab_size"], E=cfg.get("num_local_experts", 0),
        K=cfg.get("num_experts_per_tok", 0),
        bias=int(cfg.get("model_type") == "qwen2"))


def layer_leaves(cfg: Dict) -> List[Tuple[str, Shape, str]]:
    """(name, shape, kind) of one decoder layer's leaves; kind is
    "normal" (drawn) or "ones"."""
    s = sizes(cfg)
    H, I, NH, KH, D, E = s["H"], s["I"], s["NH"], s["KH"], s["D"], s["E"]
    leaves = [("attn_norm", (H,), "ones"), ("mlp_norm", (H,), "ones"),
              ("wq", (H, NH * D), "normal"), ("wk", (H, KH * D), "normal"),
              ("wv", (H, KH * D), "normal"), ("wo", (NH * D, H), "normal")]
    if E:
        leaves += [("router", (H, E), "normal"),
                   ("w_gate", (E, H, I), "normal"),
                   ("w_up", (E, H, I), "normal"),
                   ("w_down", (E, I, H), "normal")]
    else:
        leaves += [("w_gate", (H, I), "normal"), ("w_up", (H, I), "normal"),
                   ("w_down", (I, H), "normal")]
    if s["bias"]:
        leaves += [("bq", (NH * D,), "normal"), ("bk", (KH * D,), "normal"),
                   ("bv", (KH * D,), "normal")]
    return leaves


def draw(cfg: Dict, seed: int, name: str, layer: int, shape: Shape,
         device) -> torch.Tensor:
    """One drawn leaf in bf16 (``layer`` -1 for the embedding and head)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name, layer))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * cfg["weights"]["init_scale"]).to(torch.bfloat16)


def leaf(cfg: Dict, seed: int, name: str, layer: int, shape: Shape,
         kind: str, device) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    return draw(cfg, seed, name, layer, shape, device)


def embed(cfg: Dict, seed: int, device) -> torch.Tensor:
    s = sizes(cfg)
    return draw(cfg, seed, "embed", -1, (s["V"], s["H"]), device)


def lm_head(cfg: Dict, seed: int, device) -> torch.Tensor:
    s = sizes(cfg)
    return draw(cfg, seed, "lm_head", -1, (s["H"], s["V"]), device)
