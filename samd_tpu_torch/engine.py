"""SamdEngine — the greedy speculative-decoding loop (counterpart of
``samd_tpu/engine.py:49-330, 401-453``).

One decode step runs the verify forward over an M-wide draft block,
greedy acceptance and KV compaction on the device, and brings back one
packed ``[2 + D]`` int32 vector (accept length, bonus token, accepted path).
The KV cache is updated in place.

``ArBaseline(block_size=M)`` runs vanilla AR decoding through the same
M-wide step (one real token + padding).  Row position inside a block does
not change a row's arithmetic, so its greedy output is bitwise comparable
with a speculative engine's: it is the equality oracle.

Not ported yet: sampling (its tree accept rules, ROADMAP queue 1 item 12;
the fused engines sample), the tree drafters' harvest and hidden-state
feedback (items 12-13), meshes (item 16), the profiler and
``stream_generate`` (item 15).
"""

from __future__ import annotations

from collections import namedtuple
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .cache import compact_accepted, init_kv_cache
from .config import GenerationConfig, SamdConfig, require_greedy
from .device import resolve_device
from .drafters.base import Draft
from .models.configs import ModelConfig, check_supported
from .models.llama import Params, block_decode_mask, forward, prefill_mask
from .ops.quant import tensors
from .ops.treeops import pack_draft_host, unpack_draft
from .verify import greedy_accept

Outputs = namedtuple(
    "Outputs",
    ["output_ids", "decode_tokens", "decode_steps", "accept_length_per_step"])

PREFILL_BUCKETS = (128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def check_params_device(params: Params, device: torch.device) -> None:
    """Raise unless every tensor of ``params`` (quantized leaves' values
    and scales included) lies on ``device``'s type."""
    for t in tensors(params):
        if t.device.type != device.type:
            raise ValueError(f"params have a tensor on {t.device}, the "
                             f"engine runs on {device}")


class SamdEngine:
    """Greedy verify loop over a host drafter (``lookup``/``observe_*``)."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 samd_cfg: SamdConfig, drafter, *,
                 max_cache_len: int = 2048,
                 eos_token_id: int = 2,
                 stop_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 device: Union[str, torch.device] = "cuda"):
        check_supported(model_cfg)
        if getattr(drafter, "wants_harvest", False) \
                or getattr(drafter, "wants_hidden", False):
            raise NotImplementedError(
                "harvest/hidden-state drafters are ROADMAP queue 1 items "
                "12-13")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.model_cfg = model_cfg
        self.params = params
        self.samd_cfg = samd_cfg
        self.drafter = drafter
        self.max_cache_len = max_cache_len
        self.eos_token_id = eos_token_id
        self.stop_token_id = stop_token_id
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= max_cache_len)
        self.kv_k, self.kv_v = init_kv_cache(model_cfg, 1, max_cache_len,
                                             self.device)

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------
    def _prefill(self, input_ids: List[int]) -> torch.Tensor:
        """Forward the bucket-padded prompt at offset 0; returns the greedy
        next token (0-dim int32 on the device)."""
        P = _bucket(len(input_ids), self.prefill_buckets)
        dev, S = self.device, self.max_cache_len
        padded = torch.zeros((1, P), dtype=torch.int32)
        padded[0, :len(input_ids)] = torch.tensor(input_ids,
                                                  dtype=torch.int32)
        logits, _ = forward(
            self.params, self.model_cfg, padded.to(dev),
            torch.arange(P, device=dev)[None, :], self.kv_k, self.kv_v, 0,
            prefill_mask(1, P, S, dev))
        return torch.argmax(logits[0, len(input_ids) - 1]).to(torch.int32)

    def _verify_core(self, cache_len: torch.Tensor, draft: np.ndarray):
        """Draft buffers, mask and the verify forward.  The draft comes from
        the host, so its tree buffers are derived there and uploaded."""
        cfg, S, dev = self.model_cfg, self.max_cache_len, self.device
        D = self.samd_cfg.max_tree_depth
        tokens, tree_mask, depths, paths = (
            t.to(dev) for t in unpack_draft(torch.from_numpy(draft), D))
        mask = block_decode_mask(tree_mask, cache_len, S)
        logits, hidden = forward(
            self.params, cfg, tokens[None], depths[None, :] + cache_len,
            self.kv_k, self.kv_v, cache_len, mask)
        return logits, hidden, tokens, paths

    def _decode_step(self, cache_len: torch.Tensor,
                     draft: np.ndarray) -> torch.Tensor:
        M = self.samd_cfg.max_predicts
        logits, _, tokens, paths = self._verify_core(cache_len, draft)
        res = greedy_accept(logits[0], tokens, paths)
        compact_accepted(self.kv_k, cache_len, res.path_nodes, M)
        compact_accepted(self.kv_v, cache_len, res.path_nodes, M)
        # one-transfer result: [accept_len, next_token, path tokens...]
        return torch.cat([res.accept_len[None], res.next_token[None],
                          res.accepted_tokens]).to(torch.int32)

    # ------------------------------------------------------------------
    # Generation loop
    # ------------------------------------------------------------------
    def _truncate_at_stop(self, accepted: List[int]):
        for stop in (self.eos_token_id, self.stop_token_id):
            if stop is not None and stop in accepted:
                return accepted[:accepted.index(stop) + 1], True
        return accepted, False

    def generate(self, input_ids: Sequence[int],
                 gen_config: Optional[GenerationConfig] = None) -> Outputs:
        gen = gen_config or GenerationConfig()
        require_greedy(gen)
        input_ids = list(input_ids)
        if not input_ids:
            raise ValueError("generate() requires a non-empty prompt")
        M = self.samd_cfg.max_predicts
        S = min(self.max_cache_len, gen.max_cache_len)

        self.drafter.reset()
        start_token = int(self._prefill(input_ids))
        self.drafter.observe_prompt(input_ids, None)

        cache_len = len(input_ids)
        output = list(input_ids)
        decode_tokens = 0
        decode_steps = 0
        accept_lens: List[int] = []
        for _ in range(gen.max_steps):
            if cache_len + M > S:
                break
            draft = self.drafter.lookup(start_token)
            offset = torch.tensor(cache_len, dtype=torch.int32,
                                  device=self.device)
            pack = self._decode_step(offset, draft.packed).cpu().numpy()
            accept_len = int(pack[0])
            next_start = int(pack[1])
            accepted = pack[2:2 + accept_len].tolist()

            accepted, eos_hit = self._truncate_at_stop(accepted)
            self.drafter.observe_accepted(accepted)

            output.extend(accepted)
            cache_len += accept_len  # cache holds the full accepted path
            decode_steps += 1
            decode_tokens += len(accepted)
            accept_lens.append(len(accepted))
            start_token = next_start
            if eos_hit or decode_tokens >= gen.max_new_tokens:
                break

        output = output[:len(input_ids) + gen.max_new_tokens]
        return Outputs(output, decode_tokens, decode_steps, accept_lens)


# ----------------------------------------------------------------------
# Autoregressive baseline (speedup denominator + equality oracle)
# ----------------------------------------------------------------------

class _SingleTokenDrafter:
    """Draft = just the start token (padded to the block size): every step
    verifies one token, which is always accepted — vanilla AR decoding."""

    wants_harvest = False

    def __init__(self, block_size: int = 1):
        self.block_size = block_size

    def reset(self):
        pass

    def observe_prompt(self, tokens, topk=None):
        pass

    def observe_accepted(self, tokens):
        pass

    def lookup(self, start_token: int) -> Draft:
        packed = pack_draft_host([start_token], [-1], self.block_size)
        return Draft(packed=packed, num_nodes=1, source="ar")


class ArBaseline:
    """Plain autoregressive decoding through the same forward/cache code.

    ``block_size=1`` is the speed baseline; ``block_size=M`` runs AR
    through the same M-wide step as a speculative engine with
    ``max_predicts=M`` — the bitwise greedy-equality oracle."""

    def __init__(self, model_cfg: ModelConfig, params: Params, *,
                 max_cache_len: int = 2048, eos_token_id: int = 2,
                 stop_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 block_size: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        samd_cfg = SamdConfig(max_predicts=block_size,
                              max_tree_depth=block_size)
        self.cfg = model_cfg
        self._engine = SamdEngine(
            model_cfg, params, samd_cfg, _SingleTokenDrafter(block_size),
            max_cache_len=max_cache_len, eos_token_id=eos_token_id,
            stop_token_id=stop_token_id, prefill_buckets=prefill_buckets,
            device=device)

    def generate(self, input_ids, gen_config=None) -> Outputs:
        return self._engine.generate(input_ids, gen_config)
