"""Near-tie audit of a tree engine's greedy misses (counterpart of
``samd_tpu/evaluation/neartie.py``).

A tree draft's ancestors sit at non-canonical cache columns during the
verify, so its sums run in another order than the oracle's, and an argmax
whose top two logits lie within rounding of each other can flip
(docs/EXACTNESS.md).  When an engine's output diverges from its block-AR
oracle, the auditor re-runs the shared prefix on CANONICAL columns (a plain
prefill through ``models.llama.forward``) and measures, at the divergent
position:

  * ``gap``: logit[oracle token] - logit[engine token].  A near-tie flip
    has |gap| within rounding of the logits' size; a real fault shows a
    large gap;
  * ``canonical_argmax`` and the canonical top-2 gap, as evidence only:
    on random weights three tokens can lie within rounding, so a third
    token winning the canonical forward is itself near-tie noise.

A miss is a near-tie when |gap| <= tau (0.08 by default: bf16 keeps about
8 significant bits, so one rounding through the matmuls and the softmax at
logits of 5-15 is 0.03-0.06).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..cache import init_kv_cache
from ..engine import top_k
from ..models.llama import forward, prefill_mask
from ..ops.quant import tensors


def first_divergence(a: Sequence[int], b: Sequence[int]) -> int:
    """Index of the first differing token; -1 if equal up to the shorter
    length."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return -1


class NearTieAuditor:
    """Canonical-column logit probe over ``params`` (on their device)."""

    def __init__(self, model_cfg, params, *, max_cache_len: int):
        self.cfg = model_cfg
        self.params = params
        self.S = max_cache_len
        self.device = next(iter(tensors(params))).device

    @torch.no_grad()
    def logits_at(self, prefix: Sequence[int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical-column logits for the token after ``prefix`` (f32
        [V]), and their top two values and ids (ties to the lower id)."""
        P = min(1 << max(5, (len(prefix) - 1).bit_length()), self.S)
        dev = self.device
        padded = torch.zeros((1, P), dtype=torch.int64)
        padded[0, :len(prefix)] = torch.tensor(list(prefix))
        kv_k, kv_v = init_kv_cache(self.cfg, 1, P, dev)
        logits, _ = forward(self.params, self.cfg, padded.to(dev),
                            torch.arange(P, device=dev)[None, :], kv_k, kv_v,
                            0, prefill_mask(1, P, P, dev))
        last = logits[0, len(prefix) - 1]
        top2v, top2i = top_k(last, 2)
        return (last.cpu().numpy(), top2v.cpu().numpy(),
                top2i.cpu().numpy())

    def audit_pair(self, oracle_ids: Sequence[int],
                   engine_ids: Sequence[int], *, tau: float = 0.08) -> Dict:
        """Audit one (oracle, engine) output pair; ``{"diverged": False}``
        when they are equal."""
        i = first_divergence(oracle_ids, engine_ids)
        if i < 0:
            return {"diverged": False}
        o_tok, e_tok = int(oracle_ids[i]), int(engine_ids[i])
        last, top2v, top2i = self.logits_at(list(oracle_ids[:i]))
        gap = float(last[o_tok] - last[e_tok])
        return {
            "diverged": True, "pos": i, "oracle_tok": o_tok,
            "engine_tok": e_tok, "gap": round(gap, 5),
            "canonical_argmax": int(top2i[0]),
            "canonical_top2_gap": round(float(top2v[0] - top2v[1]), 5),
            "near_tie": bool(abs(gap) <= tau),
        }

    def audit(self, oracle_outs: Sequence[Sequence[int]],
              engine_outs: Sequence[Sequence[int]], *,
              tau: float = 0.08) -> Dict:
        """Audit every pair: {misses, near_tie_confirmed, details};
        ``near_tie_confirmed`` holds when every divergence is a measured
        near-tie (and when there is none)."""
        details: List[Dict] = []
        for o, e in zip(oracle_outs, engine_outs):
            r = self.audit_pair(o, e, tau=tau)
            if r["diverged"]:
                details.append(r)
        return {
            "misses": len(details),
            "near_tie_confirmed": all(d["near_tie"] for d in details),
            "details": details,
        }
