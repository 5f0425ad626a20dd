"""Dense KV cache (counterpart of ``samd_tpu/cache.py``, "sd" caches).

The cache is a pair of tensors ``[L, B, KH, S, D]``, preallocated once, or
with ``ModelConfig.kv_quant`` a pair of ``QuantizedKV``: int8 values of
that shape and one f32 scale per (token, KV head), ``[L, B, KH, S]``.  The
port keeps the "sd" layout for int8 KV too (the reference's int8 kernel
needed "ds").  Writes and the acceptance compaction update the cache in
place — the counterpart of the reference's donated buffers.  The committed
length lives in the engine loop, not in the tensors.  ``update_slot``
admits a request into one slot of a batched cache, and
``compact_accepted_batched`` compacts each slot's accepted tree path (the
batched host engines, ``batching.BatchedSamdEngine``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from .models.configs import ModelConfig, check_supported


@dataclass
class QuantizedKV:
    """int8 KV values + per-(token, head) f32 scales (amax over D / 127).

    q:     int8 [..., KH, S, D]
    scale: f32  [..., KH, S]
    Indexing the leading (layer) axis gives views of both."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def __getitem__(self, l) -> "QuantizedKV":
        return QuantizedKV(self.q[l], self.scale[l])

    def zero_(self) -> "QuantizedKV":
        self.q.zero_()
        self.scale.zero_()
        return self


KV = Union[torch.Tensor, QuantizedKV]


def quantize_kv_block(block: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """block: [B, KH, T, D] → (int8 [B, KH, T, D], f32 scale [B, KH, T]).
    Symmetric per token and head: scale max(amax over D / 127, 1e-12).

    The reference's engines run this inside ``jit``, where XLA turns the
    division by the constant 127 into a product with its f32 reciprocal
    (one ulp away from the quotient for some amax); the port computes that
    product, so its cache bytes equal the reference engines'."""
    bf = block.float()
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32,
                          device=block.device)
    scale = torch.clamp(bf.abs().amax(dim=-1) * inv127, min=1e-12)
    q = torch.clamp(torch.round(bf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(kv: KV, dtype) -> torch.Tensor:
    """The reference's pre-dequant form for the plain attention: ``q ·
    scale`` in ``dtype`` (the product rounds in ``dtype``).  Plain caches
    pass through."""
    if not isinstance(kv, QuantizedKV):
        return kv
    return kv.q.to(dtype) * kv.scale.to(dtype)[..., None]


def init_kv_cache(cfg: ModelConfig, batch: int, max_cache_len: int,
                  device: Union[str, torch.device],
                  dtype=None) -> Tuple[KV, KV]:
    check_supported(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_cache_len,
             cfg.head_dim)
    if cfg.kv_quant:
        def make():
            return QuantizedKV(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return make(), make()
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def update_slot(kv: KV, fk: KV, slot: int) -> KV:
    """Write a batch-1 cache ``fk`` ([L, 1, KH, S, D], or ``QuantizedKV``)
    into ``slot`` of a batched cache ``kv`` ([L, B, KH, S, D]) IN PLACE and
    return ``kv`` — continuous-batching admission.  A ``QuantizedKV`` takes
    its values and scales written separately."""
    if isinstance(kv, QuantizedKV):
        update_slot(kv.q, fk.q, slot)
        update_slot(kv.scale, fk.scale, slot)
        return kv
    if fk.shape[1] != 1 or fk.shape[2:] != kv.shape[2:]:
        raise ValueError(f"a batch-1 cache of shape {tuple(fk.shape)} does "
                         f"not fit a slot of {tuple(kv.shape)}")
    kv[:, slot] = fk[:, 0]
    return kv


def compact_accepted(kv: KV, offset: Union[int, torch.Tensor],
                     indices: torch.Tensor, block_size: int, *,
                     seq_axis: int = 3) -> KV:
    """Compact accepted draft positions to the front of the draft block,
    IN PLACE, and return ``kv``.

    kv:         [L, B, KH, S, D] (seq_axis=3), or ``QuantizedKV`` (its
                values along ``seq_axis``, its scales along their last axis)
    offset:     scalar — block start (committed length before the step)
    indices:    [A] int — positions *within the block* of the accepted path
                (entries past the accept length may be clamped duplicates;
                those slots lie beyond the new committed length)
    block_size: M, the draft block width; every index is below it

    Gathers the block slots ``offset + indices`` along ``seq_axis`` and
    writes them at ``[offset, offset + A)``.  Requires
    ``offset + block_size <= S`` (the engine's loop guard); unlike JAX's
    clamped slices, an offset past that bound raises on the CPU."""
    if isinstance(kv, QuantizedKV):
        compact_accepted(kv.q, offset, indices, block_size,
                         seq_axis=seq_axis)
        compact_accepted(kv.scale, offset, indices, block_size,
                         seq_axis=kv.scale.dim() - 1)
        return kv
    dev = kv.device
    offset = torch.as_tensor(offset, dtype=torch.int64, device=dev)
    A = indices.shape[0]
    sel = kv.index_select(seq_axis, offset + indices.to(torch.int64))
    kv.index_copy_(seq_axis, offset + torch.arange(A, device=dev), sel)
    return kv


def compact_accepted_batched(kv: KV, offsets: torch.Tensor,
                             indices: torch.Tensor, block_size: int, *,
                             seq_axis: int = 3) -> KV:
    """Per-slot ``compact_accepted`` over a batched cache IN PLACE (the
    reference's vmapped form, ``samd_tpu/cache.py:111``); returns ``kv``.

    kv:      [L, B, KH, S, D] (seq_axis=3, counted with the batch axis), or
             ``QuantizedKV`` (its scales compacted along their last axis)
    offsets: [B] — each slot's block start
    indices: [B, A] — block-relative accepted positions per slot

    Slot b's block is read from ``min(offsets[b], S - block_size)`` and its
    A selected rows written at ``min(offsets[b], S - A)``: the reference's
    clamped slices, a no-op inside the engines' ``offset + M <= S``."""
    if isinstance(kv, QuantizedKV):
        compact_accepted_batched(kv.q, offsets, indices, block_size,
                                 seq_axis=seq_axis)
        compact_accepted_batched(kv.scale, offsets, indices, block_size,
                                 seq_axis=kv.scale.dim() - 1)
        return kv
    if seq_axis != 3:
        raise NotImplementedError("compact_accepted_batched needs the "
                                  "\"sd\" layout (seq_axis 3)")
    dev = kv.device
    B, A = indices.shape
    S = kv.shape[3]
    off = offsets.to(device=dev, dtype=torch.int64)
    src = torch.clamp(off, max=S - block_size)[:, None] \
        + indices.to(device=dev, dtype=torch.int64)              # [B, A]
    dst = torch.clamp(off, max=S - A)[:, None] \
        + torch.arange(A, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    kv[:, rows, :, dst] = kv[:, rows, :, src]
    return kv
