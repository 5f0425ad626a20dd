"""Functional Llama forward (counterpart of ``samd_tpu/models/llama.py``).

Plain functions over a parameter dict whose layer weights are stacked on a
leading ``[L, ...]`` axis, as in the reference, so the bridge carries JAX
weights across unchanged.  One forward serves prefill, decode and draft
verification; callers vary positions and the mask.

Numerics follow the reference: weights and activations in ``cfg.dtype``,
RMS statistics and the attention softmax in f32, logits as f32 products of
the (exactly upcast) hidden state and head.  The KV cache is written in
place, the counterpart of JAX's donated buffers.

Quantized weights (``ops.quant``): ``Int4Tensor`` projections under
``int4_impl="kernel"`` go through ``ops.int4_matmul.int4_matmul`` with the
whole stacked tensor and a layer index (the K3 kernel on a CUDA tensor);
``QuantizedTensor`` (int8, fp8), and ``Int4Tensor`` under ``"xla"``, take
the reference's pre-dequant ``qmatmul``.  An int8 ``QuantizedKV`` cache
(``cfg.kv_quant``) is written through ``cache.quantize_kv_block``; the flash
route reads it in the verify kernel's int8 mode, the plain route through
the reference's bf16 pre-dequant.

Batched serving: a ``[B]`` write offset writes each slot's block at its
own offset and attends with the plain ``_attention`` over the whole cache,
as the reference does; with ``paged=PagedAux(...)`` the cache is a pair of
``paged_kv.PagedKV`` pools, the block is scattered into pages and the
attention reads the pool through the page tables (``ops.paged_attention``,
the K4 kernel on a CUDA pool).

Mixtral (``cfg.num_experts``): the MLP is ``_moe_mlp``, the reference's
dense-over-experts form; its expert stacks ``[L, E, in, out]`` stay off the
int4 kernel, as in JAX, which serves the attention projections and the
head only.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import cache as kvcache
from ..device import require_full_f32
from ..ops.flash_attention import MAX_T as FLASH_MAX_T
from ..ops.flash_attention import flash_block_attention
from ..ops.int4_matmul import int4_matmul
from ..ops.paged_attention import paged_block_attention
from ..ops.quant import (Int4Tensor, QuantizedTensor, Weight, dequant,
                         qmatmul, tensors)
from .configs import ModelConfig, check_supported

if TYPE_CHECKING:
    from ..paged_kv import PagedAux
    from ..parallel.sharding import Mesh

Params = Dict[str, object]

NEG_INF = -1e30


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                scale: float = 0.02,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random-normal parameters drawn from ``generator`` (which must live
    on ``device``).  torch cannot replay JAX's threefry draws, so tests
    carry JAX's weights across with ``bridge.params_from_jax`` instead."""
    check_supported(cfg)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def norm(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    E = cfg.num_experts
    layers = {
        "attn_norm": ones(L, H),
        "wq": norm(L, H, NH * D),
        "wk": norm(L, H, KH * D),
        "wv": norm(L, H, KH * D),
        "wo": norm(L, NH * D, H),
        "mlp_norm": ones(L, H),
    }
    if E:       # the reference's MoE leaves (samd_tpu/models/llama.py:47-52)
        layers.update(router=norm(L, H, E), w_gate=norm(L, E, H, I),
                      w_up=norm(L, E, H, I), w_down=norm(L, E, I, H))
    else:
        layers.update(w_gate=norm(L, H, I), w_up=norm(L, H, I),
                      w_down=norm(L, I, H))
    if cfg.attn_bias:
        layers["bq"] = norm(L, NH * D)
        layers["bk"] = norm(L, KH * D)
        layers["bv"] = norm(L, KH * D)
    params: Params = {"embed": norm(cfg.vocab_size, H), "layers": layers,
                      "final_norm": ones(H)}
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(H, cfg.vocab_size)
    return params


def param_count(params: Params) -> int:
    """The elements of every tensor in the tree: a quantized weight counts
    its values and its scales, as the reference counts its leaves."""
    return sum(t.numel() for t in tensors(params) if t is not None)


# ----------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return weight * normed.to(x.dtype)


def rope_tables(position_ids: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, T, head_dim] (half-split convention), f32."""
    dev = position_ids.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32, device=dev)
                                / head_dim))
    angles = position_ids[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, heads, head_dim]; cos/sin: [B, T, head_dim]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain attention over the columns it is given.  q: [B,T,NH,D]; k,v:
    [B,KH,S,D]; mask: [B,T,S] bool → [B,T,NH*D].  Products of the working
    type accumulate in f32 (operands upcast, which is exact); the
    probabilities are cast to ``v``'s type before the second product, as in
    the reference."""
    B, T = q.shape[0], q.shape[1]
    KH, G, D = cfg.num_kv_heads, cfg.kv_groups, cfg.head_dim
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4)    # [B,KH,G,T,D]
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    scores = scores * (D ** -0.5)                             # [B,KH,G,T,S]
    bias = torch.where(mask[:, None, None], 0.0, NEG_INF)
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()[:, :, None])
    out = out.to(q.dtype)                                     # [B,KH,G,T,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, KH * G * D)


def _mm(x: torch.Tensor, w: Weight, l: int, cfg: ModelConfig
        ) -> torch.Tensor:
    """``x @ w[l]`` for a stacked weight of any of the port's types (the
    reference's ``mm``/``qmatmul`` dispatch, ``samd_tpu/models/llama.py:
    279-308``).  Layers are views: nothing copies a stacked weight."""
    if isinstance(w, Int4Tensor):
        if cfg.int4_impl == "kernel":
            return int4_matmul(x, w.packed, w.scale, l)
        return qmatmul(x, w.layer(l))
    if isinstance(w, QuantizedTensor):
        return qmatmul(x, w.layer(l))
    return x @ w[l]


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int
              ) -> torch.Tensor:
    """Mixtral routing weights [B, T, E] in f32: f32 router logits of the
    f32 ``x`` [B, T, H], a softmax over all experts, the top ``k``,
    renormalized (HF's semantics, the reference's ``_moe_mlp``).  The top
    k come from a stable descending sort, so among equal probabilities the
    lower expert index wins, as under ``jax.lax.top_k``; ``torch.topk``
    leaves that order unspecified."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, topi, topv)


def _expert_stack(w: Weight, l: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer ``l`` of an ``[L, E, in, out]`` expert stack, dequantized to
    ``dtype`` (a view when the stack is plain)."""
    if isinstance(w, (Int4Tensor, QuantizedTensor)):
        return dequant(w.layer(l), dtype)
    return w[l]


def _moe_mlp(x: torch.Tensor, layers: Params, l: int, cfg: ModelConfig,
             sh: Optional["_Shards"] = None) -> torch.Tensor:
    """Layer ``l``'s Mixtral MoE MLP on x [B, T, H], computed densely over
    the expert axis as the reference does (``samd_tpu/models/llama.py:
    143-175``): every expert's gate, up and down products over every row,
    against the layer's dequantized stacks, then the combine over experts
    with the routing weights in x's type.  The expert products are plain
    matmuls, as in JAX, where they run outside the Pallas kernels; one
    stack is dequantized at a time, so the transient is one layer's
    ``[E, in, out]`` in x's type.  Under a mesh the rank computes its own
    experts' SwiGLU blocks and the f32 combine is summed over "ep" and
    "tp"."""
    B, T, H = x.shape
    wts = moe_route(x, layers["router"][l], cfg.num_experts_per_tok)
    if sh is None:
        def stack(name):
            return _expert_stack(layers[name], l, x.dtype)
    else:
        wts = sh.own_experts(wts)

        def stack(name):
            return sh.experts(layers[name], l, x.dtype, name)
    xs = x.reshape(1, B * T, H)
    g = xs @ stack("w_gate")                                  # [E, BT, I]
    u = xs @ stack("w_up")
    d = (F.silu(g) * u) @ stack("w_down")
    del g, u
    # [E, BT, H] x [BT, E] -> [BT, H], summed over e in f32, rounded once
    out = torch.einsum("eth,te->th", d.float(),
                       wts.reshape(B * T, -1).to(x.dtype).float())
    if sh is not None:
        out = sh.comm.sum_(sh.comm.sum_(out, sh.ep), sh.tp)
    return out.to(x.dtype).reshape(B, T, H)


def _head(h: torch.Tensor, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits: the int4 head through ``int4_matmul`` under
    ``int4_impl="kernel"``; otherwise the (pre-dequantized) head in h's
    type, upcast exactly, times the upcast h in f32."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, Int4Tensor) and cfg.int4_impl == "kernel":
        return int4_matmul(h, head.packed, head.scale,
                           out_dtype=torch.float32)
    return h.float() @ dequant(head, h.dtype).float()


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            position_ids: torch.Tensor, kv_k, kv_v,
            write_offset: Union[int, torch.Tensor],
            attn_mask: torch.Tensor, *,
            paged: Optional["PagedAux"] = None,
            mesh: Optional["Mesh"] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward pass that writes the block's KV into the cache.

    Args:
      tokens:       [B, T] int
      position_ids: [B, T] int (RoPE positions)
      kv_k, kv_v:   [L, B, KH, S, D] cache, or ``cache.QuantizedKV``, or in
                    paged mode ``paged_kv.PagedKV`` pools; updated IN PLACE
      write_offset: a scalar (a Python int or a 0-dim integer tensor on the
                    cache's device): the block goes to [offset, offset + T)
                    of every row, and the caller keeps offset + T <= S; or
                    a [B] integer tensor, one offset per slot (batched
                    serving; a slot past S - T writes its last T columns,
                    as the reference's clamped update does)
      attn_mask:    [B, T, S] bool, True where attention is allowed; no
                    column at or past offset + T is allowed.  In paged mode
                    the [B, T, W*page] boundary windows of
                    ``ops.paged_attention.boundary_mask_window``.
      paged:        ``paged_kv.PagedAux(tables, scratch_page)``: the pools'
                    page tables; needs a [B] offset
      mesh:         a ``parallel.sharding.Mesh``: ``params`` and the cache
                    are this rank's shards (``shard_params``,
                    ``shard_kv``), every other argument is the whole
                    batch's, and the result is the whole batch's on every
                    rank (``_forward_mesh``)

    Returns (logits [B,T,V] f32, hidden [B,T,H]).

    With a scalar offset, ``attention_impl="flash"`` (the default), B == 1
    and T <= 128 the attention goes through
    ``ops.flash_attention.flash_block_attention`` (the CUDA kernel on a
    CUDA cache); larger blocks take the plain ``_attention``.  When the
    offset is a Python int (a prefill), the plain route reads only the
    columns ``[0, write_offset + T)`` a row can see, P columns instead of
    the cache's S.  A [B] offset takes the plain ``_attention`` over all S
    columns (the reference's flash route is batch-1 only); paged mode
    takes ``ops.paged_attention.paged_block_attention``.  On CUDA it raises
    while TF32 matmuls are on.
    """
    check_supported(cfg)
    if mesh is not None:
        if paged is not None:
            raise ValueError("paged mode takes no mesh")
        return _forward_mesh(params, cfg, tokens, position_ids, kv_k, kv_v,
                             write_offset, attn_mask, mesh)
    write, attend = _cache_ops(cfg, tokens.shape, kv_k, kv_v, write_offset,
                               attn_mask, paged)
    h = F.embedding(tokens.long(), params["embed"])       # [B,T,H]
    cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.num_layers):
        h = _layer(h, params["layers"], l, kv_k, kv_v, cfg, cos, sin, write,
                   attend)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _head(h, params, cfg), h


def _cache_ops(cfg: ModelConfig, block_shape, kv_k, kv_v,
               write_offset: Union[int, torch.Tensor],
               attn_mask: torch.Tensor, paged: Optional["PagedAux"]):
    """``forward``'s cache side for a [B, T] block: ``write(cache,
    block)`` puts a layer's [B, T, KH, D] block into its cache and
    ``attend(q, k_cache, v_cache)`` reads it, by the routes ``forward``'s
    docstring names.  ``cfg``'s heads are the cache's (a rank's own under
    a mesh)."""
    from ..paged_kv import PagedKV, paged_flat_indices, paged_write_block

    B, T = block_shape
    per_slot = torch.is_tensor(write_offset) and write_offset.dim() == 1
    if torch.is_tensor(write_offset) and write_offset.dim() > 1:
        raise ValueError("write_offset must be a scalar or a [B] tensor")
    if paged is not None and not (per_slot and isinstance(kv_k, PagedKV)
                                  and isinstance(kv_v, PagedKV)):
        raise ValueError("paged mode needs a [B] write offset and PagedKV "
                         "pools")
    dev = kv_k.pool.device if paged is not None else kv_k.device
    require_full_f32(dev)
    quantized = isinstance(kv_k, kvcache.QuantizedKV)
    use_flash = cfg.attention_impl == "flash" and B == 1 \
        and T <= FLASH_MAX_T and not per_slot
    if paged is not None:
        flat_pg, flat_sl = paged_flat_indices(
            paged.tables, write_offset, T, kv_k.page_size,
            paged.scratch_page)
        kv_limits = (write_offset + T).to(torch.int32)
    elif per_slot:
        # [B, T] columns; a start clamps to S - T as JAX's update does
        starts = torch.clamp(write_offset.to(torch.int64),
                             max=kv_k.shape[3] - T)
        cols = starts[:, None] + torch.arange(T, device=dev)[None, :]
        rows = torch.arange(B, device=dev)[:, None]
    else:
        offset = torch.as_tensor(write_offset, dtype=torch.int64, device=dev)
        slots = offset + torch.arange(T, device=dev)
        kv_limit = (offset + T).to(torch.int32) if use_flash else None
        # columns the plain route reads: the live prefix when it is known
        # on the host (a prefill reads P columns, not S), else the whole
        # cache
        live = write_offset + T if isinstance(write_offset, int) \
            else kv_k.shape[3]

    def write(cache, block):
        """block [B, T, KH, D] into one layer's cache."""
        if paged is not None:
            paged_write_block(cache, block.transpose(1, 2), flat_pg, flat_sl)
        elif per_slot:          # cache[b, :, cols[b, t]] = block[b, t]
            if quantized:
                qb, sc = kvcache.quantize_kv_block(block)   # per row
                cache.q[rows, :, cols] = qb
                cache.scale[rows, :, cols] = sc
            else:
                cache[rows, :, cols] = block
        else:
            block = block.transpose(1, 2)                 # [B,KH,T,D]
            if quantized:
                qb, sc = kvcache.quantize_kv_block(block)
                cache.q.index_copy_(2, slots, qb)
                cache.scale.index_copy_(2, slots, sc)
            else:
                cache.index_copy_(2, slots, block)

    def attend(q, k_cache, v_cache):
        if paged is not None:
            return paged_block_attention(
                q, k_cache.pool, v_cache.pool, paged.tables, attn_mask,
                kv_limits, k_cache.scale, v_cache.scale)
        if per_slot:
            return _attention(q, kvcache.dequantize_kv(k_cache, q.dtype),
                              kvcache.dequantize_kv(v_cache, q.dtype),
                              attn_mask, cfg)
        if use_flash and quantized:
            return flash_block_attention(q, k_cache.q, v_cache.q, attn_mask,
                                         kv_limit, k_cache.scale,
                                         v_cache.scale)
        if use_flash:
            return flash_block_attention(q, k_cache, v_cache, attn_mask,
                                         kv_limit)
        return _attention(
            q, kvcache.dequantize_kv(k_cache[:, :, :live], q.dtype),
            kvcache.dequantize_kv(v_cache[:, :, :live], q.dtype),
            attn_mask[..., :live], cfg)

    return write, attend


def _layer(h: torch.Tensor, layers: Params, l: int, kv_k, kv_v,
           cfg: ModelConfig, cos, sin, write, attend,
           sh: Optional["_Shards"] = None) -> torch.Tensor:
    """Decoder layer ``l`` on h [B, T, H]: attention through ``write`` and
    ``attend`` (``_cache_ops``), then the MLP.  Under a mesh, ``sh`` is
    this rank's view of it and ``cfg`` holds the rank's own heads."""
    B, T = h.shape[0], h.shape[1]
    D, NH, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    x = rms_norm(h, layers["attn_norm"][l], cfg.rms_eps)
    q = _col(x, layers["wq"], l, cfg, sh)
    k = _col(x, layers["wk"], l, cfg, sh)
    v = _col(x, layers["wv"], l, cfg, sh)
    if cfg.attn_bias:
        q, k, v = q + layers["bq"][l], k + layers["bk"][l], \
            v + layers["bv"][l]
    q = apply_rope(q.reshape(B, T, NH, D), cos, sin)
    k = apply_rope(k.reshape(B, T, KH, D), cos, sin)
    v = v.reshape(B, T, KH, D)
    k_cache, v_cache = kv_k[l], kv_v[l]               # per-layer views
    write(k_cache, k)
    write(v_cache, v)
    ctx = attend(q, k_cache, v_cache)
    h = h + _row(ctx, layers["wo"], l, cfg, sh)
    x = rms_norm(h, layers["mlp_norm"][l], cfg.rms_eps)
    if cfg.num_experts:
        return h + _moe_mlp(x, layers, l, cfg, sh)
    if all(isinstance(layers[n], Int4Tensor)
           for n in ("w_gate", "w_up", "w_down")):
        sh = None       # whole on every rank: the MLP runs whole, uncut
    gated = F.silu(_col(x, layers["w_gate"], l, cfg, sh)) \
        * _col(x, layers["w_up"], l, cfg, sh)
    return h + _row(gated, layers["w_down"], l, cfg, sh)


# ----------------------------------------------------------------------
# The sharded forward
# ----------------------------------------------------------------------

def _col(x: torch.Tensor, w: Weight, l: int, cfg: ModelConfig,
         sh: Optional["_Shards"]) -> torch.Tensor:
    """A column-parallel product: the rank's own columns.  A packed int4
    weight lies whole on every rank, so its product is taken whole and
    cut."""
    y = _mm(x, w, l, cfg)
    if sh is not None and isinstance(w, Int4Tensor):
        return sh.own_columns(y)
    return y


def _row(x: torch.Tensor, w: Weight, l: int, cfg: ModelConfig,
         sh: Optional["_Shards"]) -> torch.Tensor:
    """A row-parallel product: the rank's partial sum over its rows,
    summed over "tp".  A whole int4 weight takes the whole input instead,
    gathered over "tp", and sums nothing across ranks."""
    if sh is None:
        return _mm(x, w, l, cfg)
    if isinstance(w, Int4Tensor):
        return _mm(sh.gather_tp(x), w, l, cfg)
    return sh.comm.sum_(_mm(x, w, l, cfg), sh.tp)


class _Shards:
    """One rank's view of a mesh inside a forward: its axes, the model
    config with its own heads (NH/tp, KH/tp), and the cuts and collectives
    that GSPMD makes in the reference."""

    def __init__(self, mesh: "Mesh", cfg: ModelConfig):
        from ..parallel import comm

        self.comm = comm
        self.dp, self.pp, self.ep, self.tp = (
            mesh.axis(a) for a in ("dp", "pp", "ep", "tp"))
        n = self.tp.size
        self.cfg = replace(cfg, num_heads=cfg.num_heads // n,
                           num_kv_heads=cfg.num_kv_heads // n)

    @staticmethod
    def _block(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        n = t.shape[dim] // axis.size
        return t.narrow(dim, axis.index * n, n)

    def own_columns(self, y: torch.Tensor) -> torch.Tensor:
        return self._block(y, self.tp, y.dim() - 1)

    def own_experts(self, wts: torch.Tensor) -> torch.Tensor:
        """The rank's experts' routing weights of [B, T, E]."""
        return self._block(wts, self.ep, wts.dim() - 1)

    def gather_tp(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gather(x, self.tp, -1)

    def embed(self, tokens: torch.Tensor, table: torch.Tensor
              ) -> torch.Tensor:
        """The vocabulary-sharded lookup: the rank's rows where a token
        falls in its block, -0.0 elsewhere, summed over "tp" (exact)."""
        if self.tp.size == 1:
            return F.embedding(tokens.long(), table)
        V = table.shape[0]
        local = tokens.long() - self.tp.index * V
        inside = (local >= 0) & (local < V)
        e = F.embedding(torch.where(inside, local, 0), table)
        e = torch.where(inside[..., None], e, -0.0)
        return self.comm.sum_(e, self.tp)

    def head(self, h: torch.Tensor, params: Params, cfg: ModelConfig
             ) -> torch.Tensor:
        """Full f32 logits on every rank: the rank's vocabulary columns
        gathered over "tp", or a whole int4 head's product."""
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        logits = _head(h, params, cfg)
        if isinstance(head, Int4Tensor):
            return logits
        return self.comm.gather(logits, self.tp, -1)

    def experts(self, w: Weight, l: int, dtype: torch.dtype, name: str
                ) -> torch.Tensor:
        """Layer ``l``'s stack of the rank's experts and SwiGLU block:
        [E/ep, in, I/tp] (gate, up) or [E/ep, I/tp, H] (down).  A whole
        int4 stack is dequantized whole and cut."""
        stack = _expert_stack(w, l, dtype)
        if isinstance(w, Int4Tensor):
            stack = self._block(stack, self.ep, 0)
            stack = self._block(stack, self.tp, 1 if name == "w_down" else 2)
        return stack


def _forward_mesh(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  position_ids: torch.Tensor, kv_k, kv_v,
                  write_offset: Union[int, torch.Tensor],
                  attn_mask: torch.Tensor, mesh: "Mesh"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` on one rank of ``mesh`` (``parallel.sharding``'s
    layout).  The rank takes its dp block of the batch; the embedding and
    head are vocabulary-sharded over "tp"; each layer runs on the rank's
    heads and MLP columns, with one sum over "tp" after each row-parallel
    product (a whole int4 weight gathers its input instead, and an MLP of
    whole int4 weights runs whole); the MoE MLP
    computes the rank's experts and sums over "ep" and "tp".  Pipeline
    stages run their blocks of L/pp layers in turn, each handing h on to
    every stage; the logits and hidden states are gathered over "dp".
    Every rank returns the same tensors."""
    sh = _Shards(mesh, cfg)
    comm = sh.comm
    B, T = tokens.shape
    if B % sh.dp.size:
        raise ValueError(f"batch {B} does not divide by dp={sh.dp.size}")
    b = B // sh.dp.size
    rows = slice(sh.dp.index * b, (sh.dp.index + 1) * b)
    tokens, position_ids = tokens[rows], position_ids[rows]
    attn_mask = attn_mask[rows]
    if torch.is_tensor(write_offset) and write_offset.dim() == 1:
        write_offset = write_offset[rows]
    write, attend = _cache_ops(sh.cfg, (b, T), kv_k, kv_v, write_offset,
                               attn_mask, None)
    h = sh.embed(tokens, params["embed"])
    cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
    for stage in range(sh.pp.size):
        if stage == sh.pp.index:
            for l in range(cfg.num_layers // sh.pp.size):
                h = _layer(h, params["layers"], l, kv_k, kv_v, sh.cfg, cos,
                           sin, write, attend, sh)
        h = comm.broadcast(h, sh.pp, stage)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = sh.head(h, params, cfg)
    return comm.gather(logits, sh.dp, 0), comm.gather(h, sh.dp, 0)


# ----------------------------------------------------------------------
# Attention-mask builders (shared by prefill / AR / verify)
# ----------------------------------------------------------------------

def prefill_mask(batch: int, seq_len: int, cache_size: int,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> torch.Tensor:
    """Causal mask for a block written at offset 0: [B, T, S]."""
    q = torch.arange(seq_len, device=device)[:, None]
    s = torch.arange(cache_size, device=device)[None, :]
    return (s <= q).expand(batch, seq_len, cache_size)


def block_decode_mask(tree_mask: torch.Tensor,
                      cache_len: Union[int, torch.Tensor], cache_size: int,
                      batch: int = 1) -> torch.Tensor:
    """Mask for a draft block of M tokens written at ``cache_len``: every
    query sees the committed prefix [0, cache_len) plus its tree ancestors
    inside the block.  tree_mask: [M, M] bool with a scalar cache_len →
    [batch, M, S]; or one tree per slot, [B, M, M] with cache_len [B] →
    [B, M, S].

    This satisfies the verify kernel's mask contract: columns below
    ``cache_len`` are all True, and no column at or past
    ``cache_len + M`` is."""
    M = tree_mask.shape[-1]
    dev = tree_mask.device
    cache_len = torch.as_tensor(cache_len, device=dev)[..., None]  # [..,1]
    s = torch.arange(cache_size, device=dev)                       # [S]
    prefix = s < cache_len
    rel = torch.clamp(s - cache_len, 0, M - 1)
    in_block = (s >= cache_len) & (s < cache_len + M)
    idx = rel[..., None, :].expand(*tree_mask.shape[:-1], cache_size)
    tm = torch.gather(tree_mask, -1, idx)                          # [..,M,S]
    allowed = prefix[..., None, :] | (in_block[..., None, :] & tm)
    return allowed.expand(batch, M, cache_size) if allowed.dim() == 2 \
        else allowed
