"""Training: next-token LM pretraining and EAGLE draft-net distillation
(counterpart of ``samd_tpu/training.py``).

Without a trained checkpoint every accept number would come from random
weights.  This module trains a small target LM and an EAGLE draft net on a
synthetic but learnable corpus, so the drafters' accept lengths can be
measured on weights that predict something (``evaluation.accept_demo``).

The training forward is the serving forward (``models.llama.forward``),
with ``attention_impl="xla"`` set explicitly on the trained config: the
kernels have no backward, and their wrappers refuse an input that requires
grad on the card.  The trained parameters then serve with the caller's
config, through the kernels.  Losses are f32 whatever the parameters'
type.  The optimizer is ``torch.optim.AdamW`` (weight decay 1e-4) over
one parameter group, under a ``LambdaLR`` that follows optax's
``warmup_cosine_decay_schedule(0, lr, max(steps // 20, 10), steps,
lr * 0.1)`` step for step (``lr_schedule``).  Batches are windows of the
corpus drawn by ``np.random.default_rng(seed)`` as in the reference, so the
two packages see the same batches.

EAGLE distillation: the net sees (embedding of token t + 1, target hidden
at t) and predicts the target's hidden at t + 1; its loss is a Huber
regression on the hidden state plus a soft cross-entropy against the
frozen target head's distribution.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .cache import init_kv_cache
from .device import require_full_f32, resolve_device
from .models.configs import ModelConfig
from .models.llama import Params, forward, init_params, prefill_mask
from .ops.quant import dequant

# ----------------------------------------------------------------------
# Synthetic but learnable corpora
# ----------------------------------------------------------------------


def markov_corpus(vocab_size: int, length: int, *, peak: float = 0.9,
                  branch: int = 2, order: int = 2, seed: int = 0,
                  reserved: int = 3) -> np.ndarray:
    """Sample a peaked order-``order`` Markov chain over the vocabulary.

    Each context (a tuple of ``order`` tokens) has ``branch`` plausible
    successors: the first drawn with probability ``peak``, the rest sharing
    the remainder.  Tokens below ``reserved`` are never emitted (0 stays
    free for EOS and corpus separators).  The successor sets come from
    ``hash((ctx, seed))``, which for a tuple of integers does not depend on
    ``PYTHONHASHSEED``, so the corpus equals the reference's token for
    token."""
    rng = np.random.default_rng(seed)
    usable = vocab_size - reserved

    def successors(ctx: Tuple[int, ...]) -> np.ndarray:
        # deterministic per-context successor set from a hashed sub-seed
        h = hash((ctx, seed)) & 0xFFFFFFFF
        r = np.random.default_rng(h)
        return r.choice(usable, size=branch, replace=False) + reserved

    probs = np.full(branch, (1.0 - peak) / max(branch - 1, 1))
    probs[0] = peak if branch > 1 else 1.0
    out = list(rng.integers(reserved, vocab_size, size=order))
    for _ in range(length - order):
        succ = successors(tuple(out[-order:]))
        out.append(int(rng.choice(succ, p=probs)))
    return np.asarray(out, np.int32)


# ----------------------------------------------------------------------
# Optimizer and schedule
# ----------------------------------------------------------------------

def lr_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0, lr, max(steps // 20, 10),
    steps, lr * 0.1)``: the learning rate of update ``count`` (0 first)."""
    warmup = max(steps // 20, 10)
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"{steps} steps: the schedule needs more than its "
                         f"{warmup} warmup steps")
    end = lr * 0.1

    def at(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        c = min(count - warmup, decay)
        return (lr - end) * 0.5 * (1 + math.cos(math.pi * c / decay)) + end

    return at


def _optimizer(leaves, lr: float, steps: int):
    """AdamW under the schedule; LambdaLR's factor at construction is the
    schedule at 0, so the first update takes lr 0 as optax's does."""
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    at = lr_schedule(lr, steps)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: at(c) / lr)
    return opt, sched


def _trainable(tree: Params) -> Tuple[Params, list]:
    """A copy of a tree of plain tensors whose leaves require grad, and its
    leaves in order."""
    leaves = []

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"training takes plain tensors, not "
                            f"{type(node).__name__}")
        t = node.detach().clone().requires_grad_(True)
        leaves.append(t)
        return t

    return copy(tree), leaves


def _frozen(leaves) -> None:
    for t in leaves:
        t.requires_grad_(False)


def _batches(corpus: np.ndarray, steps: int, batch: int, seq_len: int,
             seed: int, device: torch.device):
    """The reference's batches: ``batch`` random windows per step."""
    rng = np.random.default_rng(seed)
    max_start = len(corpus) - seq_len - 1
    for _ in range(steps):
        starts = rng.integers(0, max_start, size=batch)
        toks = np.stack([corpus[s:s + seq_len] for s in starts])
        yield torch.from_numpy(toks.astype(np.int64)).to(device)


class _LayerCaches(list):
    """A training forward's KV: one tensor per layer.  The forward writes
    each layer's block in place and its attention keeps what it read for
    the backward pass; layers that shared one ``[L, ...]`` tensor would
    share its version counter, and a later layer's write would invalidate
    an earlier layer's saved read."""

    @property
    def device(self) -> torch.device:
        return self[0].device


def _train_kv(cfg: ModelConfig, batch: int, length: int, dev):
    shape = (batch, cfg.num_kv_heads, length, cfg.head_dim)
    return tuple(_LayerCaches(torch.zeros(shape, dtype=cfg.dtype, device=dev)
                              for _ in range(cfg.num_layers))
                 for _ in range(2))


# ----------------------------------------------------------------------
# LM pretraining
# ----------------------------------------------------------------------

def lm_loss(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over a [B, T] batch (f32)."""
    B, T = tokens.shape
    dev = tokens.device
    kv_k, kv_v = _train_kv(cfg, B, T, dev)
    pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    logits, _ = forward(params, cfg, tokens, pos, kv_k, kv_v, 0,
                        prefill_mask(B, T, T, dev))
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def train_lm(cfg: ModelConfig, corpus: np.ndarray, *, steps: int = 500,
             batch: int = 16, seq_len: int = 64, lr: float = 3e-3,
             seed: int = 0, params: Optional[Params] = None,
             log_every: int = 0,
             device: Union[str, torch.device] = "cuda"
             ) -> Tuple[Params, list]:
    """Train a Llama LM on a flat token array; returns (params, losses).

    ``params=None`` draws them from a ``torch.Generator`` seeded ``seed``
    on ``device``; given params are copied, not changed.  ``losses`` holds
    every ``log_every``-th step's loss and the last's, or without
    ``log_every`` the last five."""
    dev = resolve_device(device)
    require_full_f32(dev)
    train_cfg = replace(cfg, attention_impl="xla")
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device=dev)
    params, leaves = _trainable(params)
    opt, sched = _optimizer(leaves, lr, steps)
    losses = []
    for i, toks in enumerate(_batches(corpus, steps, batch, seq_len, seed,
                                      dev)):
        loss = lm_loss(params, train_cfg, toks)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            losses.append(loss.item())
        elif not log_every and i >= steps - 5:
            losses.append(loss.item())
    _frozen(leaves)
    return params, losses


# ----------------------------------------------------------------------
# EAGLE draft-net distillation
# ----------------------------------------------------------------------

def eagle_distill_loss(net_params: Params, net_cfg, target_cfg: ModelConfig,
                       target_params: Params, tokens: torch.Tensor, *,
                       w_reg: float = 1.0,
                       w_cls: float = 0.5) -> torch.Tensor:
    """The EAGLE objective on a [B, T] batch.

    Teacher pass (no gradient, where the kernels may serve it): the
    target's hiddens h_0..h_{T-1} and its head's distributions.  Student:
    for i in [0, T-2], from (embed(token_{i+1}), h_i) predict ĥ_{i+1};
    loss = w_reg · Huber(ĥ, h) + w_cls · soft-CE(head(ĥ), head(h)).  The
    student's logits are f32 products of the upcast operands (TF32 off),
    as the reference's ``preferred_element_type=f32`` product."""
    from .drafters.eagle.net import eagle_forward, init_eagle_kv

    B, T = tokens.shape
    dev = tokens.device
    require_full_f32(dev)
    pos = torch.arange(T, device=dev)[None, :].expand(B, T)
    with torch.no_grad():
        kv_k, kv_v = init_kv_cache(target_cfg, B, T, dev)
        t_logits, t_hidden = forward(target_params, target_cfg, tokens, pos,
                                     kv_k, kv_v, 0,
                                     prefill_mask(B, T, T, dev))
        embeds = target_params["embed"][tokens[:, 1:]]
        head = dequant(target_params["embed"].T if target_cfg.tie_embeddings
                       else target_params["lm_head"], torch.float32).float()
        t_prob = torch.softmax(t_logits[:, 1:].float(), dim=-1)
    prev_h = t_hidden[:, :-1]                                # [B, T-1, H]
    nk, nv = init_eagle_kv(net_cfg, B, T - 1, dev)
    pred = eagle_forward(net_params, net_cfg, embeds, prev_h, pos[:, :-1],
                         nk, nv, torch.zeros(B, dtype=torch.int64,
                                             device=dev),
                         prefill_mask(B, T - 1, T - 1, dev))  # [B, T-1, H]

    diff = pred.float() - t_hidden[:, 1:].float()
    huber = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                        diff.abs() - 0.5)
    reg = huber.mean()
    s_logp = F.log_softmax(pred.float() @ head, dim=-1)
    cls = -(t_prob * s_logp).sum(-1).mean()
    return w_reg * reg + w_cls * cls


def train_eagle(target_cfg: ModelConfig, target_params: Params,
                corpus: np.ndarray, *, steps: int = 500, batch: int = 16,
                seq_len: int = 64, lr: float = 3e-3, seed: int = 0,
                net_params: Optional[Params] = None,
                device: Union[str, torch.device] = "cuda",
                on_step: Optional[Callable[[int, float, list], None]] = None
                ) -> Tuple[Dict, list]:
    """Distill an EAGLE draft net against a frozen target; returns
    (net params, the last five losses).  ``net_params=None`` draws them
    from a ``torch.Generator`` seeded ``seed + 1``.  ``on_step(i, loss,
    leaves)``, when given, is called after each backward pass and before
    the update, with the net's parameters and their gradients (one host
    sync a step)."""
    from .drafters.eagle.net import EagleNetConfig, init_eagle_params

    dev = resolve_device(device)
    net_cfg = EagleNetConfig.from_target(target_cfg)
    if net_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        net_params = init_eagle_params(net_cfg, gen, device=dev)
    net_params, leaves = _trainable(net_params)
    opt, sched = _optimizer(leaves, lr, steps)
    losses = []
    for i, toks in enumerate(_batches(corpus, steps, batch, seq_len, seed,
                                      dev)):
        loss = eagle_distill_loss(net_params, net_cfg, target_cfg,
                                  target_params, toks)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if on_step is not None:
            on_step(i, loss.item(), leaves)
        opt.step()
        sched.step()
        if i >= steps - 5:
            losses.append(loss.item())
    _frozen(leaves)
    return net_params, losses
