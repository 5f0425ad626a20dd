"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    A CUDA device that this process cannot see raises: the port never falls
    back to the CPU on its own; the caller asks for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_full_f32(device: torch.device) -> None:
    """Raise if f32 matmuls on ``device`` may run in TF32.  The logits are
    f32 products, as in the reference, and TF32 would round their operands
    to 10 mantissa bits; the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are on; set torch.backends.cuda.matmul.allow_tf32 "
            "= False so the port's f32 products run in full f32")


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise if grad mode is on and an input requires grad.  The kernels
    launch through ctypes and have no backward, so their outputs carry no
    ``grad_fn``: a training forward through one would leave every
    parameter before it without a gradient, and the optimizer would skip
    them without a word.  Each kernel wrapper calls this on the card; on
    the CPU the plain version runs, and autograd sees through it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel}: an input requires grad while grad mode is on, and "
            "the kernel has no backward; train with "
            "attention_impl='xla' and plain weights, or run under "
            "torch.no_grad()")
