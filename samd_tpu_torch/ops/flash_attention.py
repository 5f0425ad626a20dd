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

from ..device import refuse_grad
from . import _build

NEG_INF = -1e30
MAX_T = 128            # the kernel serves blocks of at most this many rows
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
TILE = 64              # the kernel's KV tile, at absolute multiples of 64
LOG2_E = 1.4426950408889634  # the bf16-q kernel keeps scores in base 2
QUARTER_MAX_ROWS = 16  # R <= 16: each warp a quarter of every KV tile


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
    bf16 ulps of max |ref| covers the f32 difference near 0.

    The tensor-core body (bf16 q, ``csrc/flash_block_attention.cu``) adds
    three error terms to the f32 result, each far below half a bf16 ulp
    (2^-9 relative), so the bound is the same (u = 2^-24 below):

    - the mma's aligned truncation.  The products of bf16 values (int8 k
      and v are exact in bf16) are exact in f32; each m16n8k16 aligns its
      16 products and its accumulator to the largest exponent among them
      and truncates the bits shifted out (Fasi, Higham, Mantovani and
      Mary, 2021), less than 2u of that largest term per term.  A score,
      a chain of D/16 mmas, is then off by at most 2u (D + D/16) max_d
      |q_d k_d| D^-0.5, under 2^-13 absolute for |q|, |k| <= 4 at D = 128
      (the plain version's own f32 dot is off by ~ D u of the same): p
      changes by that fraction of itself.  A 16-column chunk of P.V is
      off by at most 2u * 33 max_c |p_c v_c|, and the l-weighted average
      of the chunks by 66u max |v|;
    - P's hi/lo split.  P_hi = bf16(p) and P_lo = bf16(p - P_hi) leave
      |p - P_hi - P_lo| <= 2^-9 * 2^-8 |p| = 2^-17 |p|, so the output, a
      p-weighted average of v over l, moves by at most 2^-17 max |v|;
    - the int8 reassociation and the base-2 scores.  The plain version
      rounds each k8 * kscale and v8 * vscale to f32 before its products;
      the kernel forms (q.k8) * kscale * log2(e) D^-0.5 and (p * vscale)
      v8, two or three f32 roundings of the same products in another
      order: a few u relative.  Its scores in base 2 (exp2 of s log2 e
      for exp of s) round s * log2(e) D^-0.5 once more, an absolute
      error of u |s log2 e| on the exponent: p moves by under 2^-18 of
      itself for |s| < 32, and an output by that fraction of max |v|.

    Together that is under 2^-15 max |v| on outputs that average v, which
    the bf16 rounding term covers wherever |ref| is within 2^8 of max |v|,
    and the two-ulp floor elsewhere while max |ref| is within 2^9 of max
    |v| (an average of random v over n columns is about n^-1/2 of it).  ``tiled_order_attention`` models
    the kernel's order, split and reassociation on the CPU; the tests hold
    it inside this bound of the plain version and of JAX's kernel."""
    if ref.dtype == torch.float32:
        return torch.full_like(ref, 1e-4)
    r = ref.float().abs()
    ulp_max = 2.0 ** (torch.floor(torch.log2(r.max().clamp(min=2 ** -126)))
                      - 7)
    return 2 * ulp_max + 2.0 ** -7 * r


def row_layout(T: int, NH: int, KH: int) -> str:
    """The bf16-q kernel's row layout, from the shapes alone: "quarters"
    (one 16-row tile, each warp a quarter of every KV tile's columns) at
    R = G * T <= 16, else "rows" (64-row tiles, each warp 16 rows)."""
    return "quarters" if (NH // KH) * T <= QUARTER_MAX_ROWS else "rows"


def _mma_chain(acc: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b summed exactly and rounded once to f32: one mma, its
    alignment truncation bounded in ``kernel_tolerance``, not modelled."""
    return (acc.double() + a.double() @ b.double()).float()


def tiled_order_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, kv_limit: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """A CPU model of the bf16-q kernel's order and rounding, for tests:
    the same function as ``flash_block_attention_ref``, computed as the
    kernel computes it.

    KV tiles of ``TILE`` columns at absolute multiples of 64 up to
    cdiv(min(kv_limit, S), 64); a score is a chain of 16-d mmas from zero,
    then ``* c`` with c = log2(e) D^-0.5 in f32, a base-2 score (int8:
    ``(s * kscale) * c``), masked to exactly -1e30; an online softmax in
    f32 with exp2 per column group (the whole tile in the "rows" layout; at
    R <= 16 four quarters of 16 columns, one per warp) with p = 0 for a
    masked score; p (int8: p * vscale) split into
    bf16 P_hi and P_lo, each 16-column chunk's P_hi.V + P_lo.V added to the
    rescaled f32 accumulator in ascending column order; the groups combined
    in order 0..3; the output acc / max(l, 1e-30) rounded to q's type.
    Not modelled: the mma's truncation, the lanes' summation order and
    exp's last bit (``kernel_tolerance`` bounds them).  Arguments as
    ``flash_block_attention``, on the CPU."""
    _, T, NH, D = q.shape
    _, KH, S, _ = k.shape
    G = NH // KH
    R = G * T
    lim = int(kv_limit)
    kv_lim = min(lim, S)
    committed = lim - T
    groups = 4 if row_layout(T, NH, KH) == "quarters" else 1
    width = TILE // groups
    qh = q[0].float().transpose(0, 1).reshape(KH, R, D)          # r = g*T+t
    t_of_row = torch.arange(R) % T
    scale = torch.tensor(LOG2_E / D ** 0.5, dtype=torch.float32)
    m = torch.full((groups, KH, R, 1), NEG_INF)
    l = torch.zeros((groups, KH, R, 1))
    acc = torch.zeros((groups, KH, R, D))
    for j0 in range(0, kv_lim, TILE):
        n = min(TILE, kv_lim - j0)
        cols = torch.arange(j0, j0 + TILE)

        def tile(x):                      # [KH, S, ...] -> [KH, TILE, ...]
            t = torch.zeros((KH, TILE) + tuple(x.shape[2:]))
            t[:, :n] = x[:, j0:j0 + n].float()
            return t

        kt, vt = tile(k[0]), tile(v[0])
        s = torch.zeros((KH, R, TILE))
        for d0 in range(0, D, 16):
            s = _mma_chain(s, qh[..., d0:d0 + 16],
                           kt[..., d0:d0 + 16].transpose(1, 2))
        if k_scale is not None:
            s = (s * tile(k_scale[0])[:, None, :]) * scale
        else:
            s = s * scale
        inblock = mask[0][t_of_row][:, torch.clamp(cols, max=S - 1)]
        allowed = (cols < kv_lim) & ((cols < committed) | inblock)
        s = torch.where(allowed[None], s, torch.tensor(NEG_INF))
        vs = tile(v_scale[0]) if v_scale is not None else None
        for w in range(groups):
            c0 = w * width
            sw = s[..., c0:c0 + width]
            m_new = torch.maximum(m[w], sw.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m[w] - m_new)
            p = torch.where(sw > NEG_INF, torch.exp2(sw - m_new),
                            torch.zeros(()))
            l[w] = l[w] * alpha + p.sum(dim=-1, keepdim=True)
            acc[w] = acc[w] * alpha
            m[w] = m_new
            if vs is not None:
                p = p * vs[:, None, c0:c0 + width]
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            for c in range(0, width, 16):
                vc = vt[:, c0 + c:c0 + c + 16]
                d = _mma_chain(torch.zeros(()), hi[..., c:c + 16], vc)
                acc[w] = acc[w] + _mma_chain(d, lo[..., c:c + 16], vc)
    mm = m.amax(dim=0)
    o = torch.zeros((KH, R, D))
    ll = torch.zeros((KH, R, 1))
    for w in range(groups):
        f = torch.exp2(m[w] - mm)
        o = o + acc[w] * f
        ll = ll + l[w] * f
    o = o / torch.clamp(ll, min=1e-30)
    o = o.reshape(KH, G, T, D).permute(2, 0, 1, 3).reshape(1, T, NH * D)
    return o.to(q.dtype)


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
    refuse_grad("flash_block_attention", q, k, v, k_scale, v_scale)
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
