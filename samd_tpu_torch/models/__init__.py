from .configs import (
    ModelConfig,
    check_supported,
    from_hf_config,
    llama3_8b,
    llama_13b,
    llama_1b,
    llama_7b,
    mixtral_8x7b,
    qwen2_7b,
    tiny_config,
    tiny_moe_config,
    tiny_qwen2_config,
)
from .llama import (
    block_decode_mask,
    forward,
    init_params,
    param_count,
    prefill_mask,
)

__all__ = [
    "ModelConfig", "check_supported", "from_hf_config", "llama3_8b",
    "llama_1b", "llama_7b", "llama_13b", "qwen2_7b", "mixtral_8x7b", "tiny_config",
    "tiny_qwen2_config", "tiny_moe_config", "forward", "init_params",
    "param_count", "prefill_mask", "block_decode_mask",
]
