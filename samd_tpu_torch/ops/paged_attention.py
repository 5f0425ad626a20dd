"""Paged verify-block attention, K4 (counterpart of
``samd_tpu/ops/paged_attention.py``).

``paged_block_attention`` attends each slot's block of T draft rows
straight over a shared page pool, through the slot's page table: no dense
copy of a request's KV is ever made.  On a CUDA tensor it launches the
paged mode of the hand-written Hopper kernel
``samd_tpu_torch/csrc/flash_block_attention.cu`` (which replaces the TPU
kernel ``_paged_kernel``); on a CPU tensor it computes the same function
with ``paged_block_attention_ref``, the plain version.

Pool layout (one layer): ``[n_pages + 1, KH, page, D]``, "sd" within a page
(the reference's ``[n, KH, D, page]`` served its TPU DMA tiling); the last
page is the scratch page of ``paged_kv.PagedKVPool``.  int8 pools carry one
f32 scale per (page, KV head, row), ``[n_pages + 1, KH, page]``.

Logical column c of slot b lives in page ``max(tables[b, c // page], 0)``
at row ``c % page``.  The mask contract is the verify kernel's
(``ops.flash_attention``), with the mask given as a boundary window:
columns below ``kv_limits[b] - T`` are attended without a mask; columns in
``[kv_limits[b] - T, kv_limits[b])`` follow ``window[b, t, c - w0]`` with
``w0 = ((kv_limits[b] - T) // page) * page``; nothing at or past
``kv_limits[b]`` (nor past the table's ``P * page`` columns) is read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..device import refuse_grad
from . import flash_attention as fa

KERNEL_PAGE_MULTIPLE = 64     # the kernel's KV tile: a tile lies in one page


def window_pages(T: int, page: int) -> int:
    """Number of pages a boundary mask window must cover: the draft block
    [hist, hist + T) spans at most cdiv(T, page) + 1 pages."""
    return -(-T // page) + 1


def boundary_mask_window(tree_mask: torch.Tensor,
                         cache_len: Union[int, torch.Tensor],
                         page: int) -> torch.Tensor:
    """Mask for the boundary pages only: logical columns
    ``[floor(cache_len / page) * page, + W * page)`` of a draft block
    written at ``cache_len``; committed prefix columns allowed for every
    row, in-block columns per the [T, T] tree mask.  The committed pages
    below the window need no mask (the kernel treats them as all-allowed).

    tree_mask: [..., T, T] bool; cache_len: a host int or an int tensor of
    the leading shape ``[...]`` (one per slot).  Returns [..., T, W*page]."""
    T = tree_mask.shape[-1]
    W = window_pages(T, page) * page
    dev = tree_mask.device
    cl = torch.as_tensor(cache_len, device=dev).to(torch.int64)[..., None]
    c = torch.div(cl, page, rounding_mode="floor") * page \
        + torch.arange(W, device=dev)                         # [..., W]
    prefix = c < cl
    rel = torch.clamp(c - cl, 0, T - 1)
    in_block = (c >= cl) & (c < cl + T)
    idx = rel[..., None, :].expand(*tree_mask.shape[:-1], W)
    tm = torch.gather(tree_mask, -1, idx)                      # [..., T, W]
    return prefix[..., None, :] | (in_block[..., None, :] & tm)


def _check(q, k_pool, v_pool, tables, window, kv_limits, k_scale, v_scale):
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("q must be [B, T, NH, D] and the pools "
                         "[n_pages, KH, page, D]")
    B, T, NH, D = q.shape
    n, KH, page, Dk = k_pool.shape
    if Dk != D or v_pool.shape != k_pool.shape or NH % KH:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)} do not match")
    if tables.dim() != 2 or tables.shape[0] != B \
            or tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32 [{B}, P], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    Wp = window_pages(T, page) * page
    if window.shape != (B, T, Wp) or window.dtype != torch.bool:
        raise ValueError(f"window must be bool [{B}, {T}, {Wp}], got "
                         f"{window.dtype} {tuple(window.shape)}")
    if kv_limits.shape != (B,) or kv_limits.dtype != torch.int32:
        raise ValueError(f"kv_limits must be int32 [{B}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.shape != (n, KH, page) \
                    or t.dtype != torch.float32:
                raise ValueError(f"int8 pools need f32 {name} [{n}, {KH}, "
                                 f"{page}]")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"the pools must share q's type, or both be int8 "
                         f"with scales; got q {q.dtype}, k {k_pool.dtype}, "
                         f"v {v_pool.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales go with int8 pools only")
    scales = [("k_scale", k_scale), ("v_scale", v_scale)] \
        if k_scale is not None else []
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("tables", tables), ("window", window),
             ("kv_limits", kv_limits)] + scales
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical view of one pool side: [n, KH, page, ...] pages
    through tables [B, P] (-1 entries read page 0) → [B, KH, P*page, ...].
    Used by the plain version and the checks; the kernel never builds it."""
    B, P = tables.shape
    g = pool[torch.clamp(tables, min=0).long()]         # [B, P, KH, page, ...]
    g = g.transpose(1, 2)                               # [B, KH, P, page, ...]
    return g.reshape(B, g.shape[1], P * g.shape[3], *g.shape[4:])


def window_to_mask(window: torch.Tensor, kv_limits: torch.Tensor, T: int,
                   page: int, n_cols: int) -> torch.Tensor:
    """The full [B, T, n_cols] mask a window stands for under the kernel's
    contract: committed columns allowed, window columns as given, nothing
    at or past kv_limit."""
    dev = window.device
    lim = kv_limits.to(torch.int64)[:, None]                        # [B, 1]
    committed = lim - T
    w0 = torch.div(committed, page, rounding_mode="floor") * page
    col = torch.arange(n_cols, device=dev)[None]                    # [1, C]
    rel = col - w0
    in_win = (rel >= 0) & (rel < window.shape[-1])
    win = torch.gather(window, 2, torch.clamp(rel, 0, window.shape[-1] - 1)
                       [:, None, :].expand(-1, T, -1))              # [B,T,C]
    allowed = (col < committed)[:, None] | (in_win[:, None] & win)
    return allowed & (col < lim)[:, None]


def paged_block_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, tables: torch.Tensor,
                              window: torch.Tensor, kv_limits: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each slot's pages gathered into
    a dense [KH, P*page, D] view, then the verify kernel's function in f32
    with one softmax over the columns.  Arguments as
    ``paged_block_attention``."""
    B, T, NH, D = q.shape
    KH, page = k_pool.shape[1], k_pool.shape[2]
    G = NH // KH

    def kv_f32(pool, scale):
        g = gather_pages(pool, tables).float()
        if scale is not None:
            g = g * gather_pages(scale, tables)[..., None]
        return g                                             # [B,KH,C,D]

    k, v = kv_f32(k_pool, k_scale), kv_f32(v_pool, v_scale)
    C = k.shape[2]
    allowed = window_to_mask(window, kv_limits, T, page, C)  # [B, T, C]
    qh = q.float().transpose(1, 2).reshape(B, KH, G * T, D)  # r = g*T + t
    s = torch.matmul(qh, k.transpose(-1, -2)) * (D ** -0.5)  # [B,KH,R,C]
    s = torch.where(allowed.repeat(1, G, 1)[:, None], s, fa.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v) / torch.clamp(l, min=1e-30)
    o = o.reshape(B, KH, G, T, D).permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, NH * D).to(q.dtype)


def paged_block_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          window: torch.Tensor, kv_limits: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Batched verify attention over one layer's page pool.

    q: [B, T, NH, D] f32 or bf16 (T <= 128); k_pool, v_pool:
    [n_pages, KH, page, D] of q's type, or int8 with f32 ``k_scale``,
    ``v_scale`` [n_pages, KH, page]; tables: [B, P] int32 page ids (-1
    padded; -1 entries read page 0); window: [B, T, W*page] bool from
    ``boundary_mask_window`` (W = ``window_pages(T, page)``); kv_limits:
    [B] int32, each slot's committed length plus T — the kernel derives the
    window origin from it.  All contiguous, on one device.  Returns
    [B, T, NH*D] in q's type.

    A CUDA tensor launches the kernel (and counts the launch in
    ``paged_block_attention.launches``, or ``.launches_int8`` for an int8
    pool); it needs ``page % 64 == 0``.  A CPU tensor takes
    ``paged_block_attention_ref``.  Any other device raises."""
    _check(q, k_pool, v_pool, tables, window, kv_limits, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_block_attention_ref(q, k_pool, v_pool, tables, window,
                                         kv_limits, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("paged_block_attention", q, k_pool, v_pool, k_scale, v_scale)
    B, T, NH, D = q.shape
    _, KH, page, _ = k_pool.shape
    if T > fa.MAX_T:
        raise ValueError(f"T = {T} > {fa.MAX_T}")
    if D not in fa.KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel is built for "
                         f"{fa.KERNEL_HEAD_DIMS}")
    if page % KERNEL_PAGE_MULTIPLE:
        raise ValueError(f"page size {page}: the kernel needs a multiple of "
                         f"{KERNEL_PAGE_MULTIPLE}")
    int8 = k_scale is not None
    out = torch.empty((B, T, NH * D), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.samd_paged_block_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, window.data_ptr(),
            kv_limits.data_ptr(), tables.data_ptr(), out.data_ptr(), B, T,
            NH, KH, tables.shape[1], page, window.shape[2], D,
            int(q.dtype == torch.bfloat16), int(int8), stream)
    if rc != 0:
        raise RuntimeError("paged_block_attention kernel launch failed: "
                           + lib.samd_cuda_error_string(rc).decode())
    if int8:
        paged_block_attention.launches_int8 += 1
    else:
        paged_block_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = fa._lib()           # one library holds both modes
    fn = lib.samd_paged_block_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


paged_block_attention.launches = 0        # launches with pools of q's type
paged_block_attention.launches_int8 = 0   # launches over int8 pools
