"""Model architecture configs (counterpart of ``samd_tpu/models/configs.py``).

The fields and presets are the reference's, with ``dtype`` a torch dtype.
``check_supported`` raises for a setting the port does not run.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_position_embeddings: int = 4096
    tie_embeddings: bool = False
    attn_bias: bool = False          # Qwen2-family q/k/v biases
    num_experts: int = 0             # Mixtral-family MoE (0 = dense MLP)
    num_experts_per_tok: int = 2
    dtype: torch.dtype = torch.bfloat16
    # attention for decode/verify blocks (B == 1, T <= 128):
    #   "flash" – the verify-attention kernel (csrc/flash_block_attention.cu)
    #             on CUDA tensors, its plain version on CPU tensors; it
    #             streams only the live prefix of the cache
    #   "xla"   – plain dot-product attention over the whole cache, the
    #             counterpart of the reference's "xla" route, against which
    #             the tests hold it
    # The port defaults to the kernel; the reference defaults to "xla".
    attention_impl: str = "flash"
    # The reference's flash KV block size.  Kept so the two configs stay
    # parallel; the CUDA kernel chooses its own KV tile.
    flash_block_s: int = 512
    # "sd" only: [L, B, KH, S, D], for int8 KV too (the reference's "ds"
    # layout served its TPU kernel's lane tiling)
    kv_layout: str = "sd"
    # matmul for packed-int4 weights (ops.quant.Int4Tensor):
    #   "kernel" – the int4 matmul kernel (csrc/int4_matmul.cu) on CUDA
    #              tensors, its plain version on CPU tensors; streams the
    #              packed bytes
    #   "xla"    – the pre-dequant form (unpack, then a matmul), the
    #              counterpart of the reference's "xla" route
    # The two round differently, so an engine and its equality oracle share
    # the setting.  The port defaults to the kernel; the reference to "xla".
    int4_impl: str = "kernel"
    # The reference's int4 kernel tiles and unpack variant.  Kept so the two
    # configs stay parallel; the CUDA kernel picks its own tiles and has one
    # unpack form.
    int4_block_n: int = 1024
    int4_block_k: int = 2048
    int4_variant: str = "v2-sum"
    # int8 KV cache (cache.QuantizedKV): one f32 scale per (token, KV head);
    # engines and their oracles share the flag
    kv_quant: bool = False

    @property
    def kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def with_dtype(self, dtype: torch.dtype) -> "ModelConfig":
        return replace(self, dtype=dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a setting the port does not run, naming what covers
    it."""
    if cfg.kv_layout != "sd":
        raise NotImplementedError(
            f"kv_layout={cfg.kv_layout!r}: the port keeps the 'sd' cache, "
            "for int8 KV too; the 'ds' layout served the reference's TPU "
            "kernel")
    if cfg.int4_impl not in ("kernel", "xla"):
        raise ValueError(
            f"int4_impl={cfg.int4_impl!r}; the port takes 'kernel' or 'xla'")
    if cfg.num_experts and not 0 < cfg.num_experts_per_tok <= \
            cfg.num_experts:
        raise ValueError(
            f"num_experts_per_tok={cfg.num_experts_per_tok} must be in "
            f"[1, num_experts={cfg.num_experts}]")
    if cfg.attention_impl not in ("xla", "flash"):
        raise ValueError(
            f"attention_impl={cfg.attention_impl!r}; the port takes 'xla' "
            "or 'flash'")
    if cfg.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {cfg.dtype}; the port takes f32 or bf16")


def llama_7b() -> ModelConfig:
    """Vicuna-7B-v1.3 / Llama-2-7B shape."""
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        rope_theta=10000.0, rms_eps=1e-6, max_position_embeddings=4096,
    )


def llama_13b() -> ModelConfig:
    """Vicuna-13B-v1.3 / Llama-2-13B shape."""
    return ModelConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, num_kv_heads=40, head_dim=128,
        rope_theta=10000.0, rms_eps=1e-6, max_position_embeddings=4096,
    )


def llama3_8b() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rms_eps=1e-5, max_position_embeddings=8192,
    )


def llama_1b() -> ModelConfig:
    """~1.1B TinyLlama shape: the default model when no checkpoint is
    available."""
    return ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
        rope_theta=10000.0, rms_eps=1e-5, max_position_embeddings=2048,
    )


def qwen2_7b() -> ModelConfig:
    """Qwen2-7B-Instruct shape."""
    return ModelConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, rms_eps=1e-6, max_position_embeddings=32768,
        attn_bias=True,
    )


def mixtral_8x7b() -> ModelConfig:
    """Mixtral-8x7B shape (the reference's vendored Mixtral family)."""
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, rms_eps=1e-5, max_position_embeddings=32768,
        num_experts=8, num_experts_per_tok=2,
    )


def tiny_config(vocab_size: int = 256, *, num_kv_heads: int = 2,
                dtype=torch.float32) -> ModelConfig:
    """Small config for unit tests (f32 for exactness)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=num_kv_heads, head_dim=16,
        rope_theta=10000.0, rms_eps=1e-6, max_position_embeddings=512,
        dtype=dtype,
    )


def tiny_qwen2_config(vocab_size: int = 256, *, dtype=torch.float32
                      ) -> ModelConfig:
    """Qwen2-family tiny config (qkv biases) for tests."""
    return replace(tiny_config(vocab_size, dtype=dtype), attn_bias=True,
                   rope_theta=1000000.0)


def tiny_moe_config(vocab_size: int = 256, *, num_experts: int = 4,
                    dtype=torch.float32) -> ModelConfig:
    """Mixtral-family tiny config (top-2 of num_experts) for tests."""
    return replace(tiny_config(vocab_size, dtype=dtype),
                   num_experts=num_experts, num_experts_per_tok=2)


def from_hf_config(hf_config, dtype=torch.bfloat16) -> ModelConfig:
    """A ModelConfig from an HF ``config.json`` (the parsed dict, or a
    transformers config object) of the Llama, Qwen2 or Mixtral families
    (counterpart of ``samd_tpu/models/configs.py:183-209``).

    A ``rope_scaling`` other than the default rope raises: the port
    implements plain RoPE only (the reference ignores the field and would
    serve such a checkpoint with the wrong positions)."""
    if isinstance(hf_config, dict):
        get = hf_config.get
    else:
        def get(key, default=None):
            return getattr(hf_config, key, default)
    scaling = get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) not in (
            None, "default"):
        raise NotImplementedError(
            f"rope_scaling {scaling!r}: the port implements plain RoPE only")
    model_type = get("model_type", "llama")
    num_heads = get("num_attention_heads")
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=num_heads,
        num_kv_heads=get("num_key_value_heads") or num_heads,
        head_dim=get("head_dim") or get("hidden_size") // num_heads,
        rope_theta=get("rope_theta", 10000.0),
        rms_eps=get("rms_norm_eps"),
        max_position_embeddings=get("max_position_embeddings"),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        attn_bias=model_type == "qwen2" or bool(get("attention_bias", False)),
        num_experts=(get("num_local_experts", 0)
                     if model_type == "mixtral" else 0),
        num_experts_per_tok=get("num_experts_per_tok", 2),
        dtype=dtype,
    )
