"""Verify-block attention (counterpart of ``samd_tpu/ops/pallas_attention.py``).

``flash_block_attention`` attends a block of T <= 128 draft rows against
only the live prefix ``[0, kv_limit)`` of a batch-1 KV cache.  On a CUDA
tensor it launches the hand-written Hopper kernel
``samd_tpu_torch/csrc/flash_block_attention.cu`` (which replaces the TPU
kernels ``_kernel`` and ``_kernel_foldkv``); on a CPU tensor it computes
the same function with ``flash_block_attention_ref``, the plain version.

int8-KV mode: ``k`` and ``v`` int8 ``[1, KH, S, D]`` with f32 scales
``k_scale`` and ``v_scale`` ``[1, KH, S]`` (one per token and KV head, the
``cache.QuantizedKV`` layout).  A loaded value is ``float(q) * scale``, the
reference kernels' dequant (``pallas_attention.py:118-121, 240-243``); the
function is otherwise the same.  The mode is picked by the type of k/v.

Mask contract (the reference kernel's): columns below ``kv_limit - T`` are
the committed prefix and are attended without reading the mask; columns in
``[kv_limit - T, kv_limit)`` follow ``mask``; columns at or past
``kv_limit`` are never read.  Every mask the engines build
(``models.llama.prefill_mask``, ``block_decode_mask`` and the fused
engine's chain mask) satisfies it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
MAX_T = 128            # the kernel serves blocks of at most this many rows
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _check(q, k, v, mask, kv_limit, k_scale, v_scale) -> None:
    """Raise on what the kernel does not take, naming what covers it."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be [1, T, NH, D] and k, v [1, KH, S, D]")
    B, T, NH, D = q.shape
    if B != 1 or k.shape[0] != 1:
        raise NotImplementedError(
            "batch != 1: batched verify attention over a page pool is "
            "ops.paged_attention.paged_block_attention (K4, ROADMAP queue 1 "
            "items 9-10); a dense batched cache takes the plain attention "
            "in models.llama.forward")
    if T > MAX_T:
        raise ValueError(
            f"T = {T} > {MAX_T}: larger blocks take the plain attention in "
            "models.llama.forward")
    _, KH, S, Dk = k.shape
    if Dk != D and k.shape[2] == D:
        raise NotImplementedError(
            "the 'ds' [KH, D, S] cache layout served the reference's int8-KV "
            "kernel; the port keeps 'sd' [KH, S, D], in int8 too")
    if Dk != D or v.shape != k.shape or NH % KH:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if mask.shape != (1, T, S) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [1, {T}, {S}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if k.dtype == torch.int8 and v.dtype == torch.int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.shape != (1, KH, S) \
                    or t.dtype != torch.float32:
                raise ValueError(f"int8 k and v need f32 {name} [1, {KH}, "
                                 f"{S}]")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k and v must share q's type, or both be int8 "
                         f"with scales; got q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales go with int8 k and v only")
    if not torch.is_tensor(kv_limit) or kv_limit.dim() != 0 \
            or kv_limit.dtype != torch.int32:
        raise ValueError("kv_limit must be a 0-dim int32 tensor")
    scales = [("k_scale", k_scale), ("v_scale", v_scale)] \
        if k_scale is not None else []
    for name, t in [("k", k), ("v", v), ("mask", mask),
                    ("kv_limit", kv_limit)] + scales:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in [("q", q), ("k", k), ("v", v), ("mask", mask)] + scales:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kv_f32(kv: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """[1, KH, S, D] → f32 [KH, S, D]: the upcast, or int8 times its
    per-(head, column) scale in f32, as the kernel loads it."""
    if scale is None:
        return kv[0].float()
    return kv[0].float() * scale[0][..., None]


def flash_block_attention_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor,
                              kv_limit: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, in f32, with
    one softmax over all S columns.  Arguments as
    ``flash_block_attention``."""
    _, T, NH, D = q.shape
    _, KH, S, _ = k.shape
    G = NH // KH
    col = torch.arange(S, device=q.device)
    lim = kv_limit.to(torch.int64)
    allowed = (col < lim - T) | (mask[0] & (col < lim))          # [T, S]
    qh = q[0].float().transpose(0, 1).reshape(KH, G * T, D)      # r = g*T+t
    s = torch.matmul(qh, _kv_f32(k, k_scale).transpose(1, 2)) * (D ** -0.5)
    s = torch.where(allowed.repeat(G, 1)[None], s, NEG_INF)      # [KH,R,S]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, _kv_f32(v, v_scale)) / torch.clamp(l, min=1e-30)
    o = o.reshape(KH, G, T, D).permute(2, 0, 1, 3).reshape(1, T, NH * D)
    return o.to(q.dtype)


def kernel_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel - plain| given the plain version's
    output ``ref``.

    Both compute in f32 and differ only in summation order: a few f32 ulps
    on these O(1) outputs, held to 1e-4.  In bf16 each then rounds its own
    f32 result to bf16, and two results on either side of a rounding point
    differ by one bf16 ulp of the value, at most 2^-7 |ref|; a floor of two
    bf16 ulps of max |ref| covers the f32 difference near 0."""
    if ref.dtype == torch.float32:
        return torch.full_like(ref, 1e-4)
    r = ref.float().abs()
    ulp_max = 2.0 ** (torch.floor(torch.log2(r.max().clamp(min=2 ** -126)))
                      - 7)
    return 2 * ulp_max + 2.0 ** -7 * r


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_block_attention")
    fn = lib.samd_flash_block_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.samd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.samd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, kv_limit: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Verify-block attention on batch 1.

    q: [1, T, NH, D] with T <= 128; k, v: [1, KH, S, D] ("sd" layout) of
    q's type, or int8 with f32 ``k_scale``, ``v_scale`` [1, KH, S];
    mask: [1, T, S] bool; kv_limit: 0-dim int32 tensor, the committed
    length plus T, on the same device.  q in f32 or bf16; all contiguous.
    Returns [1, T, NH*D] in q's type.

    A CUDA tensor launches the kernel (and counts the launch in
    ``flash_block_attention.launches``, or ``.launches_int8`` in int8-KV
    mode); a CPU tensor takes ``flash_block_attention_ref``.  Any other
    device raises."""
    _check(q, k, v, mask, kv_limit, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_block_attention_ref(q, k, v, mask, kv_limit, k_scale,
                                         v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _, T, NH, D = q.shape
    _, KH, S, _ = k.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")
    int8 = k_scale is not None
    out = torch.empty((1, T, NH * D), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.samd_flash_block_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, mask.data_ptr(),
            kv_limit.data_ptr(), out.data_ptr(), T, NH, KH, S, D,
            int(q.dtype == torch.bfloat16), int(int8), stream)
    if rc != 0:
        raise RuntimeError("flash_block_attention kernel launch failed: "
                           + lib.samd_cuda_error_string(rc).decode())
    if int8:
        flash_block_attention.launches_int8 += 1
    else:
        flash_block_attention.launches += 1
    return out


flash_block_attention.launches = 0        # launches with k/v of q's type
flash_block_attention.launches_int8 = 0   # launches in int8-KV mode
