"""Plain reference of the Llama family as these configurations serve it:
Llama, Qwen2 (q/k/v biases) and Mixtral (top-k of E experts).

It follows the published architecture: RMSNorm, RoPE (half-split, the
config's theta), grouped-query causal attention, a SwiGLU MLP or the
Mixtral MoE (softmax over all experts, the top k by a stable sort,
renormalized), a final norm and an untied head with f32 logits.  It
computes in the precision the configuration states (``torch_dtype``): each
operation in float32 (TF32 off), its result rounded to that type where a
served model in that type keeps one: the norms' outputs, every product's
output, each residual add, RoPE's products and sum, the attention's
probabilities and output.  For bf16 this is the served numerics; for a
float32 configuration nothing is rounded.

What the configuration states about weights and cache it works out itself,
from the same seeded bf16 draws the program was given (``harness.draws``):

- int4 weight-only projections and head: symmetric, one scale per output
  channel, ``amax / 7`` over the input axis, values rounded and clipped to
  [-7, 7] (the published scheme of ``quantize_llama_params(dtype=INT4)``).
  A dense weight's product accumulates ``x @ q`` in f32 and scales after
  (a weight-only int4 GEMM); an expert stack is dequantized to the
  activation type first, as a stack the program serves densely is.
- int8 KV pages: symmetric, one scale per (token, KV head), ``amax / 127``
  over the head dimension, read back as ``q * scale`` in the activation
  type.  A prompt is prefilled over its unquantized K and V and handed to
  the pages after, so prompt rows attend to those, and every decode row to
  int8 K and V of every column, its own block's included.

``control=True`` also computes the control: the same forward with every
weight product's input rounded per row to fp8 e4m3 (scale ``amax / 448``),
the step below bf16 that a later change might take.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..harness import draws

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def int4_q(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int4 form of a bf16 ``[..., in, out]`` weight: f32 values in
    [-7, 7] and f32 scales ``[..., 1, out]``."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / 7.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -7, 7)
    return q, scale


def int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] as int8 values and one f32 scale per row."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True)
                        * torch.tensor(1.0 / 127.0), min=1e-12)
    return torch.clamp(torch.round(x / scale), -127, 127), scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] through fp8 e4m3 with one scale per row, back in f32."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 448.0,
                        min=1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: Dict, seed: int, device, control: bool = False):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.s = draws.sizes(cfg)
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.dt = DTYPES[cfg.get("torch_dtype", "bfloat16")]
        self.control = control

    # -- the configuration's rounding -------------------------------------
    def r(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dt == torch.float32 else x.to(self.dt).float()

    def norm(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        n = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True)
                            + self.eps)
        return self.r(w * self.r(n))

    def mm(self, x: torch.Tensor, w) -> torch.Tensor:
        """A dense int4 weight (q, scale): f32 x @ q, scaled, rounded."""
        q, scale = w
        return self.r((x @ q) * scale[..., 0, :])

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(
            0, D, 2, dtype=torch.float32, device=x.device) / D))
        ang = pos[:, None].float() * inv
        ang = torch.cat([ang, ang], dim=-1)[:, None, :]
        half = D // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return self.r(self.r(x * self.r(torch.cos(ang)))
                      + self.r(rot * self.r(torch.sin(ang))))

    def attention(self, q, k, v, rows: slice) -> torch.Tensor:
        """Causal GQA attention of query rows ``rows`` over every column
        up to each row.  q [N, NH, D]; k, v [N, KH, D] -> [n, NH * D]."""
        N, NH, D = q.shape
        G = NH // k.shape[1]
        qr = q[rows].transpose(0, 1)                          # [NH, n, D]
        kk = k.repeat_interleave(G, dim=1).transpose(0, 1)    # [NH, N, D]
        vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
        s = (qr @ kk.transpose(1, 2)) * D ** -0.5             # [NH, n, N]
        r = torch.arange(N, device=q.device)[rows]
        mask = torch.arange(N, device=q.device)[None, :] <= r[:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out = self.r(self.r(torch.softmax(s, dim=-1)) @ vv)
        return out.transpose(0, 1).reshape(out.shape[1], NH * D)

    def kv8(self, x: torch.Tensor) -> torch.Tensor:
        q, scale = int8_rows(x)
        return self.r(q * self.r(scale))

    # -- weights, worked out again from the draws ---------------------------
    def _weights(self, layer: int) -> Dict:
        out = {}
        for name, shape, kind in draws.layer_leaves(self.cfg):
            w = draws.leaf(self.cfg, self.seed, name, layer, shape, kind,
                           self.device)
            out[name] = int4_q(w) if name in PROJECTIONS else w.float()
        return out

    def _block(self, h, w, pos, P, act) -> torch.Tensor:
        s, r = self.s, self.r
        N = h.shape[0]
        x = act(self.norm(h, w["attn_norm"]))
        q, k, v = self.mm(x, w["wq"]), self.mm(x, w["wk"]), \
            self.mm(x, w["wv"])
        if s["bias"]:
            q, k, v = r(q + w["bq"]), r(k + w["bk"]), r(v + w["bv"])
        q = self.rope(q.reshape(N, s["NH"], s["D"]), pos)
        k = self.rope(k.reshape(N, s["KH"], s["D"]), pos)
        v = v.reshape(N, s["KH"], s["D"])
        ctx = torch.cat([self.attention(q, k, v, slice(0, P)),
                         self.attention(q, self.kv8(k), self.kv8(v),
                                        slice(P, N))])
        h = r(h + self.mm(act(ctx), w["wo"]))
        x = act(self.norm(h, w["mlp_norm"]))
        if not s["E"]:
            g, u = self.mm(x, w["w_gate"]), self.mm(x, w["w_up"])
            return r(h + self.mm(act(r(r(F.silu(g)) * u)), w["w_down"]))
        probs = torch.softmax(x @ w["router"], dim=-1)
        top_v, top_i = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_v, top_i = top_v[:, :s["K"]], top_i[:, :s["K"]]
        top_v = r(top_v / top_v.sum(dim=-1, keepdim=True))
        out = torch.zeros_like(h)
        for e in range(s["E"]):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            g, u, d = (r(w[n][0][e] * w[n][1][e])
                       for n in ("w_gate", "w_up", "w_down"))
            a = act(r(r(F.silu(r(xe @ g))) * r(xe @ u)))
            out.index_add_(0, rows, r(a @ d) * top_v[rows, slot][:, None])
        return r(h + r(out))

    @torch.no_grad()
    def gaps(self, seqs: Sequence[Tuple[List[int], List[int]]]
             ) -> List[Dict[str, Optional[torch.Tensor]]]:
        """For each (prompt, served tokens): the gap by which each served
        token's logit lies below the reference's best at its position,
        and with ``control`` the same gap of the token the control puts
        first there."""
        mm_tf32 = torch.backends.cuda.matmul.allow_tf32
        dnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._gaps(seqs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm_tf32
            torch.backends.cudnn.allow_tf32 = dnn_tf32

    def _gaps(self, seqs):
        dev = self.device
        toks = [torch.tensor(list(p) + list(o), dtype=torch.long, device=dev)
                for p, o in seqs]
        P = [len(p) for p, _ in seqs]
        pos = [torch.arange(len(t), device=dev) for t in toks]
        emb = draws.embed(self.cfg, self.seed, dev)
        hs = [emb[t].float() for t in toks]
        del emb
        ident = (lambda x: x)
        sides = [("ref", ident)]
        if self.control:
            sides.append(("control", lambda x: self.r(fp8_rows(x))))
        state = {name: list(hs) for name, _ in sides}
        for layer in range(self.s["L"]):
            w = self._weights(layer)
            for name, act in sides:
                state[name] = [self._block(h, w, p, n, act) for h, p, n
                               in zip(state[name], pos, P)]
            del w
        q, scale = int4_q(draws.lm_head(self.cfg, self.seed, dev))
        ones = torch.ones(self.s["H"], device=dev)
        out = []
        for i, (_, served) in enumerate(seqs):
            rows = slice(P[i] - 1, P[i] - 1 + len(served))
            served_t = torch.tensor(list(served), dtype=torch.long,
                                    device=dev)
            logits = {name: (act(self.norm(state[name][i][rows], ones))
                             @ q) * scale[0] for name, act in sides}
            ref = logits["ref"]
            best = ref.max(dim=-1).values
            res = {"served": (best - ref.gather(1, served_t[:, None])[:, 0]
                              ).cpu(), "control": None}
            if "control" in logits:
                first = logits["control"].argmax(dim=-1)
                res["control"] = (best - ref.gather(1, first[:, None])[:, 0]
                                  ).cpu()
            out.append(res)
        return out
