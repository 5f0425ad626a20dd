"""The EAGLE-2 drafter for the host-automaton engines (counterpart of
``samd_tpu/drafters/eagle/drafter.py``).

Each draft is a dynamic tree from the one-layer draft net, built on the
device by ``eagle_fused.make_eagle_expand`` (the fused engines' expansion,
one slot): beam expansion of depth x top-K candidates scored by cumulative
log-probability, the best ``total_tokens`` nodes kept, packed as the
engine's ``[2, M]`` draft.  The draft stays on the device (a ``Draft`` whose
``packed`` is a tensor), where ``engine.SamdEngine`` unpacks it.  The draft
net's stable KV extends with the target's hidden states of the prompt and
of each step's accepted path, which the engine hands over on the device
(``observe_prompt_hidden``, ``observe_step_hidden``).  The stable KV carries
room past ``max_draft_cache`` for the tree scratch, so no write clamps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...models.configs import ModelConfig
from ..base import Draft
from .net import EagleNetConfig, eagle_forward, init_eagle_kv, \
    init_eagle_params


class EagleStableKV:
    """The draft net's stable KV over the committed stream, extended from
    the target's hidden states: the state both EAGLE drafters share."""

    wants_harvest = False
    wants_hidden = True

    def _init_stable(self, net_params: Dict, net_cfg: EagleNetConfig,
                     model_cfg: ModelConfig, params: Dict, max_nodes: int,
                     max_draft_cache: int, room: int) -> None:
        self.net_params, self.cfg = net_params, net_cfg
        self.model_cfg, self.params = model_cfg, params
        self.max_nodes = max_nodes
        self.S = max_draft_cache
        self.device = params["embed"].device
        self.kv_k, self.kv_v = init_eagle_kv(net_cfg, 1,
                                             max_draft_cache + room,
                                             self.device)
        self.reset()

    def reset(self) -> None:
        self.stable_len = 0
        self.last_hidden = torch.zeros((self.cfg.hidden_size,),
                                       dtype=self.cfg.dtype,
                                       device=self.device)

    def _extend(self, tokens: Sequence[int], prev_hidden: torch.Tensor,
                n: int) -> None:
        """Feed ``n`` (token, previous hidden) pairs into the stable KV."""
        dev = self.device
        pos = self.stable_len + torch.arange(n, device=dev)
        cols = torch.arange(self.kv_k.shape[2], device=dev)
        ids = torch.tensor(list(tokens[:n]), dtype=torch.int64, device=dev)
        eagle_forward(self.net_params, self.cfg,
                      F.embedding(ids[None], self.params["embed"]),
                      prev_hidden[None, :n], pos[None], self.kv_k,
                      self.kv_v, pos[:1], (cols[None] <= pos[:, None])[None])
        self.stable_len += n

    # -- engine hooks ---------------------------------------------------
    def observe_prompt(self, tokens: Sequence[int],
                       topk: Optional[np.ndarray] = None) -> None:
        pass   # observe_prompt_hidden does the work

    def observe_prompt_hidden(self, tokens: List[int],
                              hidden: torch.Tensor) -> None:
        """hidden: [P_pad, H] target hidden states of the prompt."""
        P = len(tokens)
        if P >= 2:
            self._extend(tokens[1:], hidden[:P - 1], P - 1)
        self.last_hidden = hidden[P - 1]

    def observe_accepted(self, tokens: Sequence[int]) -> None:
        pass

    def observe_step_hidden(self, accepted: List[int],
                            path_hidden: torch.Tensor,
                            accept_len: int) -> None:
        """path_hidden: [D, H] target hidden states of the accepted path's
        nodes."""
        prev = torch.cat([self.last_hidden[None].to(path_hidden.dtype),
                          path_hidden[:-1]])
        self._extend(accepted, prev, accept_len)
        self.last_hidden = path_hidden[accept_len - 1]

    def observe_verify(self, block_tokens, block_topk, num_nodes) -> None:
        pass


class Eagle2Drafter(EagleStableKV):
    def __init__(self, net_params: Dict, net_cfg: EagleNetConfig,
                 model_cfg: ModelConfig, params: Dict, *, max_nodes: int,
                 depth: int = 5, topk: int = 8, total_tokens: int = 63,
                 max_draft_cache: int = 2048):
        from ...eagle_fused import make_eagle_expand

        if total_tokens + 1 > max_nodes:
            raise ValueError(
                f"total_tokens+1={total_tokens + 1} exceeds verify block "
                f"max_nodes={max_nodes}")
        self.depth, self.topk, self.total = depth, topk, total_tokens
        self._expand, tree_slots = make_eagle_expand(
            net_cfg, model_cfg, depth=depth, topk=topk, total=total_tokens,
            M=max_nodes)
        self._init_stable(net_params, net_cfg, model_cfg, params, max_nodes,
                          max_draft_cache, tree_slots)

    def lookup(self, start_token: int) -> Draft:
        dev = self.device
        packed = self._expand(
            self.net_params, self.params, self.kv_k, self.kv_v,
            torch.tensor([self.stable_len], device=dev),
            self.last_hidden[None],
            torch.tensor([start_token], dtype=torch.int64, device=dev))[0]
        return Draft(packed=packed, num_nodes=self.total + 1,
                     source="eagle2", depth=self.depth)


def random_net(model_cfg: ModelConfig, params: Dict,
               generator: Optional[torch.Generator]) -> Dict:
    """A random draft net on the target's device, from ``generator`` or
    one seeded 7."""
    dev = params["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(7)
    return init_eagle_params(EagleNetConfig.from_target(model_cfg),
                             generator, device=dev)


def make_eagle2(model_cfg: ModelConfig, params: Dict, samd_cfg, *,
                net_params: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> Eagle2Drafter:
    """An ``Eagle2Drafter`` bound to the target's embedding and head.
    ``net_params=None`` draws a random net (tests, benchmarks); a
    checkpoint loads through ``net.convert_eagle_state_dict``."""
    if net_params is None:
        net_params = random_net(model_cfg, params, generator)
    return Eagle2Drafter(
        net_params, EagleNetConfig.from_target(model_cfg), model_cfg, params,
        max_nodes=samd_cfg.max_predicts, depth=samd_cfg.eagle_depth,
        topk=samd_cfg.eagle_topk, total_tokens=samd_cfg.eagle_total_tokens)
