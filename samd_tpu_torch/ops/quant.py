"""Weight-only quantization (counterpart of ``samd_tpu/ops/quant.py``).

Two weight types stand in for a ``[..., in, out]`` weight tensor:

  * ``QuantizedTensor``: int8 (or fp8) values of the weight's shape and one
    f32 scale per output channel, ``[..., out]``;
  * ``Int4Tensor``: packed int4, ``uint8 [..., in, out/2]`` in the halves
    layout — byte ``[..., i, j]`` holds output column ``j`` in its low
    nibble and ``j + out/2`` in its high nibble, each unsigned with zero
    point 8 — and f32 scales ``[..., out]``.

Their bytes equal the reference's for the same input, so the bridge carries
JAX trees across unchanged.  The model's matmul helper dispatches on the
type: ``Int4Tensor`` under ``int4_impl="kernel"`` goes to
``ops.int4_matmul.int4_matmul`` (the K3 kernel on a CUDA tensor), everything
else to ``qmatmul``, the pre-dequant form.  Layers of a stacked tensor are
taken with ``layer(l)``, which returns views.

``quantize_eagle_params`` quantizes the EAGLE draft net's matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Union

import numpy as np
import torch

INT4 = "int4"          # the ``dtype`` argument that selects packed int4
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
FP8_TYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


@dataclass
class QuantizedTensor:
    """int8/fp8 values + per-output-channel f32 scales."""

    q: torch.Tensor       # int8 or fp8, the weight's shape
    scale: torch.Tensor   # f32, the weight's shape minus the in axis

    @property
    def shape(self):
        return self.q.shape

    def layer(self, l: int) -> "QuantizedTensor":
        return QuantizedTensor(self.q[l], self.scale[l])


@dataclass
class Int4Tensor:
    """Halves-packed int4 values + per-output-channel f32 scales."""

    packed: torch.Tensor  # uint8 [..., in, out/2]
    scale: torch.Tensor   # f32   [..., out]

    @property
    def shape(self):
        return self.packed.shape[:-1] + (self.packed.shape[-1] * 2,)

    def layer(self, l: int) -> "Int4Tensor":
        return Int4Tensor(self.packed[l], self.scale[l])


Weight = Union[torch.Tensor, QuantizedTensor, Int4Tensor]


def quantize_weight(w: torch.Tensor, *, axis: int = -2,
                    dtype=torch.int8) -> QuantizedTensor:
    """Symmetric per-channel quantization; ``axis`` is the contraction axis
    reduced for the scales.  ``dtype``: ``torch.int8``, or fp8
    (``torch.float8_e4m3fn`` / ``torch.float8_e5m2``), whose cast rounds to
    nearest even as the reference's does."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    if dtype == torch.int8:
        scale = amax / 127.0
        q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)),
                        -127, 127).to(torch.int8)
    elif dtype in FP8_TYPES:
        fp8_max = float(torch.finfo(dtype).max)
        scale = amax / fp8_max
        q = torch.clamp(wf / torch.clamp(scale, min=1e-12), -fp8_max,
                        fp8_max).to(dtype)
    else:
        raise ValueError(f"quantize_weight takes int8 or fp8, got {dtype}")
    return QuantizedTensor(q=q, scale=scale.squeeze(axis))


def _pack_halves(q: torch.Tensor) -> torch.Tensor:
    """int values in [-7, 7], [..., out] → uint8 [..., out/2], halves
    layout, zero point 8."""
    half = q.shape[-1] // 2
    lo = (q[..., :half] + 8) & 0xF
    hi = (q[..., half:] + 8) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def quantize_weight4(w: torch.Tensor, *, axis: int = -2) -> Int4Tensor:
    """Symmetric per-output-channel int4 ([-7, 7], scale amax/7), packed in
    the halves layout along the output (last) axis."""
    if axis not in (-2, w.dim() - 2):
        raise ValueError("int4 packs along the output (-1) axis; the "
                         "contraction axis must be -2")
    if w.shape[-1] % 2:
        raise ValueError("the output dim must be even for nibble packing")
    wf = w.float()
    scale = wf.abs().amax(dim=axis, keepdim=True) / 7.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -7, 7
                    ).to(torch.int32)
    return Int4Tensor(packed=_pack_halves(q), scale=scale.squeeze(axis))


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., out/2] → int8 [..., out] signed values (nibble − 8),
    halves layout."""
    pi = packed.to(torch.int32)
    return torch.cat([(pi & 15) - 8, (pi >> 4) - 8], dim=-1).to(torch.int8)


def _deq4(w: Int4Tensor, dtype) -> torch.Tensor:
    """Pre-dequant form of an ``Int4Tensor``: ``(nibble − 8) · scale`` in
    ``dtype`` (the product rounds in ``dtype``, as the reference's).

    The values and the one rounding are ``unpack4``'s, but each half is
    unpacked in uint8 (``nibble − 8`` mod 256 read as int8) and multiplied
    by its scales straight into its half of the output, with no int32
    intermediate.  Mixtral's expert stacks are dequantized on every
    forward, and this form takes a third of the int32 form's time there
    (``PERF.md`` §6)."""
    half = w.packed.shape[-1]
    out = torch.empty(w.packed.shape[:-1] + (2 * half,), dtype=dtype,
                      device=w.packed.device)
    scale = w.scale.to(dtype)[..., None, :]
    for j, nibble in enumerate((w.packed & 15, w.packed >> 4)):
        cols = slice(j * half, (j + 1) * half)
        torch.mul(nibble.sub_(8).view(torch.int8), scale[..., cols],
                  out=out[..., cols])
    return out


def qmatmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x @ w`` with the weight dequantized to ``x``'s type first, as the
    reference's ``qmatmul``."""
    if isinstance(w, QuantizedTensor):
        return x @ (w.q.to(x.dtype) * w.scale.to(x.dtype))
    if isinstance(w, Int4Tensor):
        return x @ _deq4(w, x.dtype)
    return x @ w


def dequant(w: Weight, dtype) -> torch.Tensor:
    """``q · scale`` with the contraction axis re-expanded; plain tensors
    pass through."""
    if isinstance(w, QuantizedTensor):
        return w.q.to(dtype) * w.scale[..., None, :].to(dtype)
    if isinstance(w, Int4Tensor):
        return _deq4(w, dtype)
    return w


def quantize_llama_params(params: Dict, *, dtype=torch.int8) -> Dict:
    """Quantize the projections and ``lm_head`` of a Llama parameter dict
    (stacked ``[L, in, out]`` layers; scales become ``[L, out]``); embed,
    norms and biases stay as they are.  A Mixtral dict's expert stacks
    ``[L, E, in, out]`` quantize along the same -2 axis (scales ``[L, E,
    out]``) and its router stays as it is (``samd_tpu/ops/quant.py:
    184-191``).  ``dtype``: int8, an fp8 type, or ``INT4``."""
    def quant(w):
        if dtype == INT4:
            return quantize_weight4(w, axis=-2)
        return quantize_weight(w, axis=-2, dtype=dtype)

    out = dict(params)
    layers = dict(params["layers"])
    for name in PROJECTIONS:
        layers[name] = quant(layers[name])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    return out


def init_quantized_llama_params(cfg, generator: torch.Generator, *,
                                scale: float = 0.02, dtype=torch.int8,
                                device: Union[str, torch.device] = "cuda"
                                ) -> Dict:
    """Random parameters drawn directly in quantized form from
    ``generator`` (which lives on ``device``), never as a wide float tree.

    ``dtype=torch.int8``: projections uniform in [-127, 127] with a constant
    per-channel scale ``scale·√3/127`` (dequantized std ≈ ``scale``).
    ``dtype=INT4``: uniform packed bytes (two uniform nibbles) with scale
    ``scale / √((16²−1)/12)``.  Embed is ``randn · scale`` in ``cfg.dtype``,
    norms are ones.  torch cannot replay the reference's threefry draws, so
    the numbers differ from JAX's; tests carry JAX's trees across with the
    bridge instead."""
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if dtype == torch.int8:
        s = scale * np.sqrt(3.0) / 127.0

        def qrand(shape):
            q = torch.randint(-127, 128, shape, generator=generator,
                              dtype=torch.int8, device=device)
            return QuantizedTensor(q, torch.full(shape[:-2] + shape[-1:], s,
                                                 dtype=torch.float32,
                                                 device=device))
    elif dtype == INT4:
        s = scale / float(np.sqrt((16 ** 2 - 1) / 12.0))

        def qrand(shape):
            packed = torch.randint(0, 256, shape[:-1] + (shape[-1] // 2,),
                                   generator=generator, dtype=torch.uint8,
                                   device=device)
            return Int4Tensor(packed, torch.full(shape[:-2] + shape[-1:], s,
                                                 dtype=torch.float32,
                                                 device=device))
    else:
        raise ValueError(f"init_quantized_llama_params draws int8 or {INT4!r}"
                         f", got {dtype}")

    def norm(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params = {
        "embed": norm(cfg.vocab_size, H),
        "layers": {
            "attn_norm": ones(L, H),
            "wq": qrand((L, H, NH * D)),
            "wk": qrand((L, H, KH * D)),
            "wv": qrand((L, H, KH * D)),
            "wo": qrand((L, NH * D, H)),
            "mlp_norm": ones(L, H),
            "w_gate": qrand((L, H, I)),
            "w_up": qrand((L, H, I)),
            "w_down": qrand((L, I, H)),
        },
        "final_norm": ones(H),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qrand((H, cfg.vocab_size))
    return params


def _requant4(t: QuantizedTensor) -> Int4Tensor:
    """One int8 tensor → packed int4 by the reference's requant formula
    (``samd_tpu/ops/quant.py:341-348``): dequantize in f32, scale
    ``max(amax/7, 1e-12)`` per output channel, round, clip to [-7, 7],
    pack.  The reference runs it under ``jit``, where XLA turns ``amax /
    7.0`` into a product with the f32 reciprocal of 7; the port computes
    that product, so the scales agree to the bit.  One layer at a time, so
    the f32 temporaries stay one slice."""
    if t.q.dtype != torch.int8:
        raise ValueError(f"int4_from_int8_params needs int8 weights, got "
                         f"{t.q.dtype}")
    q8 = t.q.reshape((-1,) + t.q.shape[-2:])
    s8 = t.scale.reshape(-1, t.q.shape[-1])
    IN, OUT = q8.shape[1:]
    packed = torch.empty((q8.shape[0], IN, OUT // 2), dtype=torch.uint8,
                         device=q8.device)
    scale = torch.empty((q8.shape[0], OUT), dtype=torch.float32,
                        device=q8.device)
    inv7 = torch.tensor(1.0 / 7.0, dtype=torch.float32, device=q8.device)
    for l in range(q8.shape[0]):
        w = q8[l].float() * s8[l]
        sc = torch.clamp(w.abs().amax(dim=0) * inv7, min=1e-12)
        q4 = torch.clamp(torch.round(w / sc), -7, 7).to(torch.int32)
        packed[l] = _pack_halves(q4)
        scale[l] = sc
    return Int4Tensor(packed.reshape(t.q.shape[:-1] + (OUT // 2,)),
                      scale.reshape(t.scale.shape))


def int4_from_int8_params(params: Dict) -> Dict:
    """Packed-int4 parameters requantized from an int8 tree held in memory
    (the port's form of the reference's ``int4_requant_from_int8_init``,
    which replays its threefry draws of the int8 base; the port takes the
    int8 tree itself).  Every projection and ``lm_head`` must be an int8
    ``QuantizedTensor``; the other leaves are shared, not copied."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in PROJECTIONS:
        layers[name] = _requant4(layers[name])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = _requant4(params["lm_head"])
    return out


def quantize_eagle_params(params: Dict, *, dtype=torch.int8) -> Dict:
    """Quantize an EAGLE draft-net parameter dict
    (``drafters.eagle.net``): its eight matrices, per output channel, to
    int8, fp8 or (``dtype=INT4``) packed int4; ``fc_b`` and ``mlp_norm``
    keep their type.  The expansion runs the net ``depth`` times a step,
    so its weight bytes are paid depth-fold (reference
    ``samd_tpu/ops/quant.py:408-419``)."""
    out = dict(params)
    for name in ("fc_w", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        out[name] = (quantize_weight4(params[name]) if dtype == INT4
                     else quantize_weight(params[name], dtype=dtype))
    return out


def tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a parameter tree, quantized leaves' parts included."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, Int4Tensor):
        yield tree.packed
        yield tree.scale
    else:
        yield tree


def quantized_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(params))
