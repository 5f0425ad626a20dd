"""Int4 weight-streaming matmul, K3 (counterpart of
``samd_tpu/ops/int4_matmul.py:int4_matmul``).

``int4_matmul(x, packed, scale, layer)`` computes ``x @ dequant(W)`` for
halves-packed int4 weights (``ops.quant.Int4Tensor``).  On a CUDA tensor it
launches the hand-written Hopper kernel ``samd_tpu_torch/csrc/int4_matmul.cu``
(which replaces the TPU kernel ``_int4_matmul_stacked``); on a CPU tensor it
computes the same function with ``int4_matmul_ref``, the plain version.  A
stacked ``[L, in, out/2]`` weight is passed whole with a layer index: the
kernel offsets into it, and nothing copies the layer.

A bf16 ``x`` runs on the tensor cores (``mma.sync``, the int4 unpacked in
registers), its k range split across ``k_splits(in, out/2)`` CTAs whose
f32 partials a second pass adds in order; an f32 ``x`` on the CUDA cores.
Either sums each output over ``in`` in one fixed order, whatever the
number of rows and whatever row it falls in, so a row's result does not
depend on the rows beside it (``csrc/int4_matmul.cu`` says how).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .quant import unpack4

F32_EPS = 2.0 ** -24      # unit roundoff of f32
BF16_ULP = 2.0 ** -7      # bf16 ulp relative to the leading power of two
LAMBDA = 8.0              # standard deviations in kernel_tolerance
# The tensor-core kernel's cut of the k range (csrc/int4_matmul.cu):
COL_BYTES = 32            # packed columns per CTA
WARP_SLICES = 8           # k slices per CTA, one per warp
MIN_STEPS = 8             # k16 steps per warp slice at the least
SMS = 132                 # the H100 SXM's SMs: at most one CTA each at R <= 16


def _layer(packed: torch.Tensor, scale: torch.Tensor,
           layer: Optional[int]):
    """(packed [L, in, out/2], scale [L, out], layer index) for a 2-D or a
    stacked weight; raises on shapes the kernel does not take."""
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"packed must be uint8 and scale f32, got "
                         f"{packed.dtype} and {scale.dtype}")
    if packed.dim() == 2:
        if layer is not None:
            raise ValueError("a layer index needs a stacked [L, in, out/2] "
                             "weight")
        packed, scale, layer = packed[None], scale[None], 0
    if packed.dim() != 3 or layer is None:
        raise ValueError("packed must be [in, out/2], or [L, in, out/2] "
                         "with a layer index")
    L, _, OUTH = packed.shape
    if scale.shape != (L, 2 * OUTH):
        raise ValueError(f"scale {tuple(scale.shape)} does not match packed "
                         f"{tuple(packed.shape)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    return packed, scale, int(layer)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, layer: Optional[int] = None, *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: unpack, subtract 8, one f32
    product, scale, one rounding to ``out_dtype``.  Arguments as
    ``int4_matmul``."""
    packed, scale, layer = _layer(packed, scale, layer)
    q = unpack4(packed[layer]).float()                       # [in, out]
    y = (x.reshape(-1, q.shape[0]).float() @ q) * scale[layer]
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], q.shape[1])


def kernel_tolerance(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, layer: Optional[int],
                     ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain| given the plain version's
    output ``ref`` (same arguments as ``int4_matmul``), for an ``x`` of
    independent zero-mean entries, as the card checks draw it.

    Each side sums the n = ``in`` products ``t_k = x[r,k]·(q[k,c]−8)`` in
    f32 in its own order, with an error ``Σ_j δ_j p_j`` over its partial
    sums p_j, |δ_j| ≤ u = 2^-24.  With the δ_j independent and zero-mean
    (the probabilistic model of Higham and Mary, 2019), that error is within
    ``λ u sqrt(Σ_j p_j²)`` but for odds of 2 exp(−λ²/2); each p_j sums a
    subset of the t_k, so for such x, Σ_j p_j² is about at most n Σ_k t_k².
    With λ = 8 (odds 2.5e-14 per element) and one rounding of the scale
    multiply per side, two f32 results differ by at most
    ``e = 2λ u √n ‖t‖₂ |scale| + 2u |ref|``, where ‖t‖₂ = sqrt(x² @
    (q−8)²).  This grows as √n·‖t‖₂, as the rounding error of a fixed-order
    sum does; a sum that drops a term per k slice, or rounds a slice's
    partial sum to bf16, lands outside it at llama_7b's lengths.  A bf16
    output then rounds each to bf16, half a bf16 ulp (2^-8 of the value)
    apiece: ``e + 2^-7 (1.01 |ref| + e)``.

    The tensor-core kernel (bf16 x) sums each 16 consecutive products in
    one mma from a zero accumulator.  The products t_k are exact; the mma
    aligns them to the exponent of the largest, truncates the bits shifted
    out, and normalizes the sum to f32 (Fasi, Higham, Mantovani and Mary,
    2021).  With f32's 24 bits kept below the largest product's leading
    bit, each truncation takes less than 2u·max_{k∈i}|t_k| off a product,
    against its sign, and the normalization less than 2u|c_i| off the sum
    c_i, against c_i's sign.  For such x those signs are independent and
    zero mean, so the model above holds with 16 terms of size ≤
    2u·max_{k∈i}|t_k| and one of size ≤ 2u|c_i| per chunk i.  As
    max_{k∈i} t_k² ≤ Σ_{k∈i} t_k² and c_i² ≤ 16 Σ_{k∈i} t_k², each group
    adds at most λ·8u‖t‖₂: 16λu‖t‖₂ in all, against the kernel's half of
    the bound, λu√n‖t‖₂ (64λu‖t‖₂ at in = 4096), of which the f32 chain
    over the n/16 chunk sums takes at most λu√(n/16)‖t‖₂.
    ``mma_order_sum`` models that order with the truncation."""
    packed, scale, layer = _layer(packed, scale, layer)
    q = unpack4(packed[layer]).float()
    n = q.shape[0]
    norm = (x.reshape(-1, n).float().square() @ q.square()).sqrt()
    e = (2 * LAMBDA * F32_EPS * n ** 0.5 * norm * scale[layer].abs())
    e = e.reshape(ref.shape) + 2 * F32_EPS * ref.float().abs()
    if ref.dtype == torch.float32:
        return e
    return e + BF16_ULP * (1.01 * ref.float().abs() + e)


def k_splits(IN: int, OUTH: int) -> int:
    """How many CTAs of the tensor-core kernel share one 32-byte column
    strip's k range, by the weight's shape alone (never by R, so a row's
    sum runs in one order at every R): the most that keep a call of R ≤ 16
    within one CTA per SM (``SMS``), and no warp slice under
    ``MIN_STEPS`` k16 steps."""
    strips = -(-OUTH // COL_BYTES)
    most = max(1, IN // 16 // (WARP_SLICES * MIN_STEPS))
    return max(1, min(SMS // strips, most))


def mma_order_sum(x: torch.Tensor, q: torch.Tensor, splits: int, *,
                  skip_first: bool = False, round_partials: bool = False,
                  extra_bits: int = 0, cols: int = 512) -> torch.Tensor:
    """``x @ q`` (f32 [R, in] by [in, out], bf16-exact x, small-integer q)
    summed as the tensor-core kernel cuts it, with a model of the mma's
    rounding: each 16 k's products are truncated toward zero onto the
    grid 2^(e − 23 − ``extra_bits``), e the exponent of the largest of the
    16, summed exactly and truncated toward zero to f32; those sums are
    added in f32 in ascending k within each of ``WARP_SLICES * splits``
    slices; each CTA adds its ``WARP_SLICES`` slices in order, then the
    CTAs' sums are added in order.  Planted faults: ``skip_first`` drops
    each slice's first k, ``round_partials`` rounds each slice's partial to
    bf16.  Works over ``cols`` output columns at a time."""
    R, n = x.shape
    steps = n // 16
    per = -(-steps // (WARP_SLICES * splits))
    xs = x.double().reshape(R, steps, 16).clone()
    if skip_first:
        xs[:, ::per, 0] = 0
    out = []
    for c0 in range(0, q.shape[1], cols):
        qs = q[:, c0:c0 + cols].double().reshape(steps, 16, -1)
        t = xs[..., None] * qs[None]                       # [R, s, 16, c]
        _, e = torch.frexp(t.abs().amax(dim=2, keepdim=True))
        grid = torch.ldexp(torch.ones_like(t[:, :, :1]),
                           e - 24 - extra_bits)
        exact = (torch.trunc(t / grid) * grid).sum(dim=2)  # [R, s, c]
        chunk = exact.float()
        chunk = torch.where(chunk.double().abs() > exact.abs(),
                            torch.nextafter(chunk, torch.zeros_like(chunk)),
                            chunk)
        total = torch.zeros((R, chunk.shape[2]), device=x.device)
        for z in range(splits):
            cta = torch.zeros_like(total)
            for w in range(WARP_SLICES):
                a = (z * WARP_SLICES + w) * per
                part = torch.zeros_like(total)
                for s in range(a, min(a + per, steps)):
                    part = part + chunk[:, s]
                if round_partials:
                    part = part.to(torch.bfloat16).float()
                cta = cta + part
            total = total + cta
        out.append(total)
    return torch.cat(out, dim=1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int4_matmul")
    fn = lib.samd_int4_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.samd_int4_error_string.argtypes = [ctypes.c_int]
    lib.samd_int4_error_string.restype = ctypes.c_char_p
    return lib


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                layer: Optional[int] = None, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(W)`` for halves-packed int4 ``W``.

    x: [..., in] f32 or bf16, contiguous; packed: [in, out/2] uint8, or
    stacked [L, in, out/2] with ``layer`` (a host int) picking the layer;
    scale: [out] f32, or [L, out]; out_dtype: f32 or bf16 (default x's).
    Returns [..., out].

    A CUDA tensor launches the kernel (and counts the launch in
    ``int4_matmul.launches``); a CPU tensor takes ``int4_matmul_ref``.  Any
    other device raises."""
    packed, scale, layer = _layer(packed, scale, layer)
    L, IN, OUTH = packed.shape
    out_dtype = out_dtype or x.dtype
    if x.shape[-1] != IN:
        raise ValueError(f"x has {x.shape[-1]} features, the weight's "
                         f"contraction length is {IN}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x and the output must be f32 or bf16, got "
                         f"{x.dtype} and {out_dtype}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cpu":
        return int4_matmul_ref(x, packed, scale, layer, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if OUTH % 4 or packed.data_ptr() % 4:
        raise ValueError(f"the kernel reads 4 packed bytes at a time: out/2 "
                         f"= {OUTH} must be a multiple of 4 and packed "
                         "4-byte aligned")
    if x.dtype == torch.bfloat16 and (
            IN % 16 or OUTH % 16 or packed.data_ptr() % 16
            or x.data_ptr() % 16):
        raise ValueError(f"the tensor-core kernel copies 16 bytes at a time "
                         f"and steps 16 k per product: in = {IN} and out/2 "
                         f"= {OUTH} must be multiples of 16 and x and "
                         "packed 16-byte aligned")
    R = x.numel() // IN
    y = torch.empty((*x.shape[:-1], 2 * OUTH), dtype=out_dtype,
                    device=x.device)
    if R == 0:
        return y
    splits = k_splits(IN, OUTH) if x.dtype == torch.bfloat16 else 1
    partial = None if splits == 1 else torch.empty(
        (splits, R, 2 * OUTH), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.samd_int4_matmul(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(), R, IN, OUTH,
            layer, splits, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("int4_matmul kernel launch failed: "
                           + lib.samd_int4_error_string(rc).decode())
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0
