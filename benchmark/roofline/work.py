"""Operations and bytes of the work that served forwards need, from the
configuration's sizes and what the spans saw.

Counting rules (each input byte read once, each output written once; only
the work the requests need):

- A decode step is one ``[B, M]`` forward.  Only live slots count: each
  live slot's M rows.  A slot is live for the first ``live`` steps of a
  segment (a slot that stops stays stopped), and its committed length
  grows from ``hist0`` to ``hist1`` over them, taken as even steps.
- A prefill counts the prompt's rows, not its bucket's padding, and the
  head at one row: a request needs the next token after its prompt only.
- ``int4`` products: each dense int4 weight product (``[in, out]``
  packed bytes and f32 scales) at the forward's row count: all seven
  projections of a dense layer and the head; a Mixtral layer's four
  attention projections and the head (its expert stacks are counted by
  ``model_flops`` only).  Bytes: packed weights + scales + bf16 rows in +
  rows out (bf16, f32 for the head).  Operations: 2 * rows * in * out.
- Decode attention over int8 pages (K4): per layer, per live slot, its
  live columns c = committed length + M of int8 K and V and their f32
  scales per (column, KV head), q in and the output out (bf16), the
  boundary mask window (M x window columns, one byte each), the page
  table row and the limit.  Operations: 4 * NH * M * D * c.
- Model operations (``mfu``): 2 x the weight parameters a row touches
  (Mixtral: its routed top-k experts only, not the eight computed
  densely; the router counts; the embedding lookup does not), plus
  attention: 4 * NH * D per causal column per layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

from .peaks import PEAK_FLOPS, bound_s


@dataclass(frozen=True)
class Shapes:
    H: int
    I: int
    L: int
    NH: int
    KH: int
    D: int
    V: int
    E: int = 0
    K: int = 0

    @classmethod
    def of(cls, cfg: Dict) -> "Shapes":
        return cls(H=cfg["hidden_size"], I=cfg["intermediate_size"],
                   L=cfg["num_hidden_layers"],
                   NH=cfg["num_attention_heads"],
                   KH=cfg["num_key_value_heads"], D=cfg["head_dim"],
                   V=cfg["vocab_size"], E=cfg.get("num_local_experts", 0),
                   K=cfg.get("num_experts_per_tok", 0))

    def int4_products(self) -> List[Tuple[int, int, int, int]]:
        """(in, out, output bytes, count per forward) of each dense int4
        product."""
        H, I, NH, KH, D, L = self.H, self.I, self.NH, self.KH, self.D, self.L
        prods = [(H, NH * D, 2, L), (H, KH * D, 2, 2 * L),
                 (NH * D, H, 2, L)]
        if not self.E:
            prods += [(H, I, 2, 2 * L), (I, H, 2, L)]
        return prods + [(H, self.V, 4, 1)]

    def params_per_row(self) -> int:
        H, I, NH, KH, D = self.H, self.I, self.NH, self.KH, self.D
        attn = H * NH * D + 2 * H * KH * D + NH * D * H
        mlp = (H * self.E + self.K * 3 * H * I) if self.E else 3 * H * I
        return self.L * (attn + mlp) + H * self.V

    def attention_flops(self, causal_cols: float) -> float:
        return 4.0 * self.NH * self.D * causal_cols * self.L


def int4_product(R: int, IN: int, OUT: int, out_bytes: int
                 ) -> Tuple[float, float]:
    """(bytes, operations) of one int4 product at R rows."""
    nbytes = IN * OUT / 2 + OUT * 4 + R * IN * 2 + R * OUT * out_bytes
    return nbytes, 2.0 * R * IN * OUT


def int4_forward_bound_s(s: Shapes, R: int, head_rows: int = None
                         ) -> float:
    """The least time of a forward's int4 products at R rows, the head
    (the last product) at ``head_rows`` rows (default R)."""
    *body, (IN, OUT, ob, n) = s.int4_products()
    head = R if head_rows is None else head_rows
    return sum(k * bound_s(*int4_product(R, i, o, b))
               for i, o, b, k in body) \
        + n * bound_s(*int4_product(head, IN, OUT, ob))


def paged_attention_bound_s(s: Shapes, M: int, page: int, table_cols: int,
                            lives_cols: Iterable[float]) -> float:
    """The least time of one decode step's K4 launches (one per layer)
    over the live slots' columns ``lives_cols``."""
    wcols = (-(-M // page) + 1) * page
    nbytes = flops = 0.0
    for c in lives_cols:
        nbytes += (2 * c * s.KH * (s.D + 4) + 2 * M * s.NH * s.D * 2
                   + M * wcols + table_cols * 4 + 4)
        flops += 4.0 * s.NH * M * s.D * c
    return s.L * bound_s(nbytes, flops)


@dataclass
class Work:
    """Totals over a set of forwards."""
    int4_bound_s: float = 0.0
    paged_attention_bound_s: float = 0.0
    model_flops: float = 0.0
    decode_steps: int = 0

    def mfu(self, seconds: float) -> float:
        return self.model_flops / (seconds * PEAK_FLOPS["bfloat16"])


def add_segment(w: Work, s: Shapes, M: int, page: int, table_cols: int,
                span) -> None:
    """One segment span's decode steps (``harness.spans.SegmentSpan``)."""
    slots = [i for i in range(len(span.actives))
             if span.actives[i] and span.live[i] > 0]
    for t in range(span.steps):
        cols = []
        for i in slots:
            n = int(span.live[i])
            if t < n:
                cols.append(span.hist0[i] + (span.hist1[i] - span.hist0[i])
                            * t / n)
        if not cols:
            continue
        R = M * len(cols)
        w.int4_bound_s += int4_forward_bound_s(s, R)
        w.paged_attention_bound_s += paged_attention_bound_s(
            s, M, page, table_cols, [h + M for h in cols])
        # block row j of a slot at h attends h + j + 1 columns
        causal = sum(M * h + M * (M + 1) / 2 for h in cols)
        w.model_flops += 2.0 * s.params_per_row() * R \
            + s.attention_flops(causal)
        w.decode_steps += 1


def add_prefill(w: Work, s: Shapes, n: int) -> None:
    """One prompt of n rows; the head at its last row only."""
    head = s.H * s.V
    w.int4_bound_s += int4_forward_bound_s(s, n, head_rows=1)
    w.model_flops += 2.0 * (s.params_per_row() - head) * n + 2.0 * head \
        + s.attention_flops(n * (n + 1) / 2)
