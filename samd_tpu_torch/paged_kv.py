"""Paged KV-cache pool (counterpart of ``samd_tpu/paged_kv.py``).

One pool per cache side, shared by every request slot; a host free-list
allocator hands out pages, and each request holds an ordered page table.
Layout: ``[L, n_pages + 1, KH, page, D]``, "sd" within a page, the layout
the port's paged kernel (``ops.paged_attention``) reads.  The last page is
a scratch page: writes of released or inactive slots, and of rows past a
slot's table, land there, so a step never needs a select over the pool.
An int8 pool carries one f32 scale per (page, KV head, row),
``[L, n_pages + 1, KH, page]``; the reference's singleton scale axis
served its TPU DMA only.  Writes update the pool in place.

The reference's ``paged_forward`` and ``scatter_block_t`` (used by its
``batching.py``) are this module's ``paged_write_block`` and the paged mode
of ``models.llama.forward``, which ``batching.PagedBatchedSamdEngine``
runs; its v1 gather path (``gather_request``, ``scatter_block``) has no
caller.  ``paged_compact_block`` compacts accepted tree paths on the pages
for every paged tree engine (``batching.PagedBatchedSamdEngine``,
``fused_hybrid.PagedBatchedFusedHybridEngine``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .cache import quantize_kv_block
from .models.configs import ModelConfig


class PagedAux(NamedTuple):
    """Per-call paged-mode context for ``models.llama.forward``: the page
    tables (device, -1 padded) and the scratch page's index."""

    tables: torch.Tensor     # [B, P] int32 page ids, -1 padded
    scratch_page: int


@dataclass
class PagedKV:
    """One cache side (k or v) of a page pool.

    pool:  [L, n_pages + 1, KH, page, D] — cfg.dtype, or int8
    scale: [L, n_pages + 1, KH, page] f32 per-row dequant scales (None for
           a full-precision pool).
    Indexing the leading (layer) axis gives views of both."""

    pool: torch.Tensor
    scale: Optional[torch.Tensor]

    @property
    def page_size(self) -> int:
        return self.pool.shape[-2]

    def __getitem__(self, l) -> "PagedKV":
        return PagedKV(self.pool[l],
                       None if self.scale is None else self.scale[l])


class PagedKVPool:
    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int,
                 device: Union[str, torch.device], quantized: bool = False):
        """Pools of ``n_pages`` pages of ``page_size`` rows plus the
        scratch page, zeroed, in ``cfg.dtype``; ``quantized`` stores int8
        values and f32 scales (half the page bytes of bf16)."""
        shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, page_size,
                 cfg.head_dim)
        self.scratch_page = n_pages

        def make() -> PagedKV:
            if quantized:
                return PagedKV(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
            return PagedKV(torch.zeros(shape, dtype=cfg.dtype,
                                       device=device), None)

        self.k, self.v = make(), make()
        self.page_size = page_size
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))

    # -- host-side allocator -------------------------------------------
    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted ({n} pages requested, "
                f"{len(self._free)} free)")
        out, self._free = self._free[:n], self._free[n:]
        return out

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)

    def pages_for(self, length: int) -> int:
        return -(-length // self.page_size)


class PagedRequest:
    """A request slot's ordered page table."""

    def __init__(self, pool: PagedKVPool, max_len: int):
        self.pool = pool
        self.max_pages = pool.pages_for(max_len)
        self.pages: List[int] = []

    def ensure(self, new_length: int) -> None:
        need = self.pool.pages_for(new_length)
        if need > self.max_pages:
            raise ValueError("request exceeds its max_len")
        if need > len(self.pages):
            self.pages.extend(self.pool.alloc(need - len(self.pages)))

    def ensure_upto(self, want_length: int) -> int:
        """Best-effort growth toward ``want_length`` tokens (segments
        pre-allocate their worst-case growth; a tight pool shortens the
        segment instead of failing).  Returns the token capacity."""
        want = min(self.pool.pages_for(want_length), self.max_pages)
        grab = min(want - len(self.pages), len(self.pool._free))
        if grab > 0:
            self.pages.extend(self.pool.alloc(grab))
        return len(self.pages) * self.pool.page_size

    def host_table(self) -> np.ndarray:
        t = np.full(self.max_pages, -1, np.int32)
        t[:len(self.pages)] = self.pages
        return t

    def table(self, device: Union[str, torch.device]) -> torch.Tensor:
        return torch.from_numpy(self.host_table()).to(device)

    def release(self) -> None:
        self.pool.free(self.pages)
        self.pages = []


def paged_flat_indices(tables: torch.Tensor, write_offsets: torch.Tensor,
                       T: int, page: int, scratch_page: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page ids, in-page rows), each [B*T] int64, for a block written at
    ``write_offsets`` [B] per slot through ``tables`` [B, P].  Rows whose
    table entry is -1 or whose logical position is past the table go to
    the scratch page: the reference's JAX scatter drops out-of-range
    indices, a torch scatter raises, and the remap makes both write only
    in-range rows.  Two rows can share a destination only on the scratch
    page."""
    B, P = tables.shape
    tok_pos = write_offsets.to(torch.int64)[:, None] \
        + torch.arange(T, device=tables.device)[None, :]        # [B, T]
    row = torch.div(tok_pos, page, rounding_mode="floor")
    pg = torch.gather(tables.to(torch.int64), 1, torch.clamp(row, 0, P - 1))
    pg = torch.where((pg < 0) | (row >= P), scratch_page, pg)
    return pg.reshape(-1), torch.remainder(tok_pos, page).reshape(-1)


def paged_write_block(cache: PagedKV, block: torch.Tensor,
                      flat_pages: torch.Tensor,
                      flat_slots: torch.Tensor) -> PagedKV:
    """Scatter a fresh KV block [B, KH, T, D] into one layer's pool
    ([n_pages + 1, KH, page, D]) IN PLACE and return ``cache``; an int8
    pool takes the block quantized per row (``cache.quantize_kv_block``,
    the reference's ``quantize_rows`` formula).  Flat indices from
    ``paged_flat_indices``."""
    B, KH, T, D = block.shape
    rows = block.transpose(1, 2).reshape(B * T, KH, D)
    if cache.scale is not None:
        qrows, srows = quantize_kv_block(rows)
        cache.pool[flat_pages, :, flat_slots] = qrows
        cache.scale[flat_pages, :, flat_slots] = srows
    else:
        cache.pool[flat_pages, :, flat_slots] = rows.to(cache.pool.dtype)
    return cache


def paged_compact_block(cache: PagedKV, tables: torch.Tensor,
                        offsets: torch.Tensor, path_nodes: torch.Tensor,
                        block_size: int, scratch_page: int) -> PagedKV:
    """Per-slot compaction of accepted tree-draft rows on the page pool, IN
    PLACE over every layer, and return ``cache`` (reference
    ``samd_tpu/paged_kv.py:314``; the paged form of
    ``cache.compact_accepted_batched``).

    cache:      one side's pools ``[L, n + 1, KH, page, D]`` (and int8
                scales ``[L, n + 1, KH, page]``)
    tables:     [B, P] page tables, -1 padded
    offsets:    [B] each slot's block start
    path_nodes: [B, A] block-relative accepted rows per slot (A <= M)

    Each slot's block rows ``[offset, offset + M)`` are gathered (one
    gather over all layers) and its path's rows written back at ``[offset,
    offset + A)`` (one scatter).  Rows outside a slot's table read and
    write the scratch page (``paged_flat_indices``): live slots own disjoint
    pages, so two writes meet only there, where no slot reads."""
    B, A = path_nodes.shape
    M = block_size
    dev = tables.device
    pg, sl = paged_flat_indices(tables, offsets, M, cache.page_size,
                                scratch_page)                    # [B*M]
    src = (path_nodes.long()
           + M * torch.arange(B, device=dev)[:, None]).reshape(-1)
    dst_pg = pg.reshape(B, M)[:, :A].reshape(-1)
    dst_sl = sl.reshape(B, M)[:, :A].reshape(-1)
    rows = cache.pool[:, pg, :, sl]                  # [B*M, L, KH, D]
    cache.pool[:, dst_pg, :, dst_sl] = rows[src]
    if cache.scale is not None:
        srows = cache.scale[:, pg, :, sl]            # [B*M, L, KH]
        cache.scale[:, dst_pg, :, dst_sl] = srows[src]
    return cache
