"""Per-request uniform noise on the device: a counter-based Philox stream
per request (the port's counterpart of the reference's per-slot
``jax.random`` keys, ``samd_tpu/fused_sam.py:682-688``, ``:806-813``).

``request_uniforms(seeds, draws, n)`` gives ``[B, n]`` f32 uniforms in
[0, 1): row b is draw ``draws[b]`` of the stream of seed ``seeds[b]``.
Element j is word ``j & 3`` of Philox4x32-10 with counter ``(j >> 2,
draws[b], 0, 0)`` and key ``(s & 0xffffffff, s >> 32)`` for the seed s
taken mod 2^64, and the uniform is ``(w >> 8) * 2^-24``.  A request's
noise is so a pure function of (seed, draw index, element): every slot of
a batch can draw in every step of a captured CUDA graph, and the engines
advance a slot's draw counter, on the device, only on its live sampled
steps.

On a CUDA tensor the wrapper launches the hand-written kernel
``samd_tpu_torch/csrc/request_noise.cu`` (which replaces no Pallas kernel:
the reference draws inside XLA); on a CPU tensor it computes the same
bits with ``request_uniforms_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Union

import torch

from . import _build

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)     # the round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)     # the key's Weyl increments
PHILOX_ROUNDS = 10


def seed_tensor(seeds: Sequence[int],
                device: Union[str, torch.device]) -> torch.Tensor:
    """``[B]`` int64 of each seed taken mod 2^64 (in two's complement), the
    form ``request_uniforms`` reads."""
    return torch.tensor([seed_word(s) for s in seeds], dtype=torch.int64,
                        device=device)


def seed_word(seed: int) -> int:
    """``seed`` mod 2^64 as the int64 of the same bits."""
    s = int(seed) % (1 << 64)
    return s - (1 << 64) if s >= 1 << 63 else s


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of ``a * b`` for a constant ``a`` and int64
    ``b`` holding 32-bit values, from 16-bit halves so that no product
    leaves int64's positive range."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (a_hi * b_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)) & MASK32
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 over int64 tensors holding 32-bit words: ``counter``
    four broadcastable words, ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check(seeds, draws, n, mask):
    if seeds.dtype != torch.int64 or draws.dtype != torch.int32:
        raise ValueError(f"seeds must be int64 and draws int32, got "
                         f"{seeds.dtype} and {draws.dtype}")
    if seeds.dim() != 1 or draws.shape != seeds.shape:
        raise ValueError(f"seeds and draws must be [B], got "
                         f"{tuple(seeds.shape)} and {tuple(draws.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != seeds.shape):
        raise ValueError(f"mask must be bool [B], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, t in (("draws", draws), ("mask", mask)):
        if t is not None and t.device != seeds.device:
            raise ValueError(f"{name} is on {t.device}, seeds on "
                             f"{seeds.device}")
    if int(n) < 1:
        raise ValueError(f"n must be at least 1, got {n}")


def request_uniforms_plain(seeds: torch.Tensor, draws: torch.Tensor, n: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in int64 arithmetic on 32-bit
    words: the same bits.  Arguments as ``request_uniforms``."""
    _check(seeds, draws, n, mask)
    dev = seeds.device
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64,
                          device=dev)[None, :]
    s = seeds.to(torch.int64)[:, None]
    key = (s & MASK32, (s >> 32) & MASK32)
    d = (draws.to(torch.int64) & MASK32)[:, None]
    zero = torch.zeros_like(d)
    words = philox4x32_10((blocks, d, zero, zero), key)
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)   # [B, nb, 4]
    u = ((w >> 8).to(torch.float32) * 2.0 ** -24).reshape(
        seeds.shape[0], 4 * blocks.shape[1])[:, :n]
    if mask is not None:
        u = torch.where(mask[:, None], u, 0.0)
    return u.contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("request_noise")
    fn = lib.samd_request_uniforms
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.samd_request_noise_error_string.argtypes = [ctypes.c_int]
    lib.samd_request_noise_error_string.restype = ctypes.c_char_p
    return lib


def request_uniforms(seeds: torch.Tensor, draws: torch.Tensor, n: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, n]`` f32 uniforms in [0, 1): row b is draw ``draws[b]`` of the
    stream of ``seeds[b]`` (the module docstring defines it); a row whose
    ``mask`` entry is False is zeros.

    seeds: [B] int64 (each seed mod 2^64, ``seed_tensor``); draws: [B]
    int32; mask: [B] bool or None (every row draws); all on one device.
    A CUDA tensor launches the kernel (and counts the launch in
    ``request_uniforms.launches``); a CPU tensor takes
    ``request_uniforms_plain``.  Any other device raises."""
    _check(seeds, draws, n, mask)
    if seeds.device.type == "cpu":
        return request_uniforms_plain(seeds, draws, n, mask)
    if seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {seeds.device}")
    for name, t in (("seeds", seeds), ("draws", draws), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n = seeds.shape[0], int(n)
    out = torch.empty((B, n), dtype=torch.float32, device=seeds.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        rc = lib.samd_request_uniforms(
            seeds.data_ptr(), draws.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), B, n,
            int(n % 4 == 0 and out.data_ptr() % 16 == 0), stream)
    if rc != 0:
        raise RuntimeError("request_uniforms kernel launch failed: "
                           + lib.samd_request_noise_error_string(rc).decode())
    request_uniforms.launches += 1
    return out


request_uniforms.launches = 0
