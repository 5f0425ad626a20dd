"""Decode-time sequence parallelism: the KV cache sharded along its
sequence axis, attention combined blockwise across shards (counterpart of
``samd_tpu/parallel/seq_parallel.py``).

Each rank holds ``S/n`` cache slots of every layer and head; queries and
weights are whole on every rank, and the softmax is combined exactly with
the blockwise (flash/ring) algebra:

    m      = max_i  max(scores_i)
    num    = sum_i  exp(scores_i - m) @ V_i
    denom  = sum_i  sum(exp(scores_i - m))
    ctx    = num / denom

through ``parallel.comm``'s all-reduces.  The block's KV write may
straddle shards, so each rank applies a masked gather-write of the block
into its own slots.  It is plain torch, as the reference's is plain jnp:
the verify kernel returns no partial softmax statistics for the combine.
The combine reorders float sums, so outputs match the unsharded forward to
float tolerance (argmax-stable), not bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..models.configs import ModelConfig, check_supported
from ..models.llama import _head, _layer, rms_norm, rope_tables
from . import comm
from .sharding import Mesh, local_slice


def kv_seq_spec() -> tuple:
    """KV cache [L, B, KH, S, D] sharded along S over the "tp" axis."""
    return (None, None, None, "tp", None)


def shard_kv_seq(kv_k: torch.Tensor, kv_v: torch.Tensor, mesh: Mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``[L, B, KH, S/n, D]`` block of a dense cache."""
    return (local_slice(kv_k, kv_seq_spec(), mesh),
            local_slice(kv_v, kv_seq_spec(), mesh))


def _write_block_local(cache: torch.Tensor, block: torch.Tensor,
                       write_offset, shard_base: int) -> torch.Tensor:
    """Masked gather-write of ``block`` [B, KH, T, D] into the local cache
    shard [B, KH, S_local, D]; global column ``shard_base + j`` receives
    block element ``shard_base + j - write_offset`` when in range.  Returns
    the new shard."""
    T = block.shape[2]
    S_local = cache.shape[2]
    g = shard_base + torch.arange(S_local, device=cache.device)
    b = g - torch.as_tensor(write_offset, device=cache.device)
    in_range = (b >= 0) & (b < T)
    picked = torch.index_select(block, 2, torch.clamp(b, 0, T - 1))
    return torch.where(in_range[None, None, :, None], picked, cache)


def make_sp_forward(cfg: ModelConfig, mesh: Mesh, *, axis: str = "tp"):
    """A forward with the KV cache sequence-sharded over ``axis``; the
    signature of ``models.llama.forward`` (scalar write offset, the batch
    whole on every rank), with weights whole on every rank.

    Returns ``fn(params, tokens, position_ids, kv_k, kv_v, write_offset,
    attn_mask) -> (logits, hidden, kv_k, kv_v)``: ``kv_k``/``kv_v`` are the
    rank's shards (``shard_kv_seq``), updated in place and returned;
    ``attn_mask`` is the whole ``[B, T, S]`` mask.  Dense Llama configs
    only (no q/k/v biases, no MoE MLP), as in the reference."""
    check_supported(cfg)
    if cfg.attn_bias or cfg.num_experts:
        raise ValueError("the sequence-parallel forward models dense Llama "
                         "layers only (no attention biases, no MoE MLP)")
    ax = mesh.axis(axis)
    KH, G, D = cfg.num_kv_heads, cfg.kv_groups, cfg.head_dim

    def sp_attention(q, k_shard, v_shard, mask_shard):
        """q: [B,T,NH,D] whole; k/v_shard: [B,KH,S_l,D]; mask_shard:
        [B,T,S_l] -> [B,T,NH*D] whole."""
        B, T = q.shape[0], q.shape[1]
        qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4)
        scores = torch.matmul(qg.float(),
                              k_shard.float()[:, :, None].transpose(-1, -2))
        scores = scores * (D ** -0.5)                     # [B,KH,G,T,S_l]
        bias = torch.where(mask_shard[:, None, None], 0.0, -1e30)
        scores = scores + bias
        m = comm.max_(torch.amax(scores, dim=-1), ax)     # global max
        e = torch.exp(scores - m[..., None])
        denom = comm.sum_(torch.sum(e, dim=-1), ax)
        num = comm.sum_(torch.matmul(e.to(v_shard.dtype).float(),
                                     v_shard.float()[:, :, None]), ax)
        ctx = (num / denom[..., None]).to(q.dtype)
        return ctx.permute(0, 3, 1, 2, 4).reshape(B, T, KH * G * D)

    def sp_forward(params, tokens, position_ids, kv_k, kv_v, write_offset,
                   attn_mask):
        S_local = kv_k.shape[3]
        base = ax.index * S_local
        mask = attn_mask[..., base:base + S_local]

        def write(cache, block):
            cache.copy_(_write_block_local(cache, block.transpose(1, 2),
                                           write_offset, base))

        def attend(q, k_shard, v_shard):
            return sp_attention(q, k_shard, v_shard, mask)

        h = F.embedding(tokens.long(), params["embed"])
        cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
        for l in range(cfg.num_layers):
            h = _layer(h, params["layers"], l, kv_k, kv_v, cfg, cos, sin,
                       write, attend)
        h = rms_norm(h, params["final_norm"], cfg.rms_eps)
        return _head(h, params, cfg), h, kv_k, kv_v

    return sp_forward
