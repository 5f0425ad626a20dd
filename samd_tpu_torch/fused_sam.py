"""Fused device-resident SAM-style retrieval decoding (counterpart of
``samd_tpu/fused_sam.py:48-439, 446-1069``).

Each decode step drafts by longest-suffix match over the request's own
history and a static corpus (a scan, or with ``FusedSamConfig.indexed`` an
n-gram index probe, ``ops.ngram_index``), verifies the chain draft with one
forward over an M-token block, accepts a prefix of it and commits it — all
on the device.  The reference runs up to ``steps_per_call`` steps inside
one ``lax.while_loop``; here the host runs segments of steps
(``device_loop``): on the card each segment replays the step's CUDA graph
k times, then reads one packed control vector (``fused_base.pack_ctrl``),
the segment's only host sync.  k is the number of steps the requests that
decide the segment's end are certain to stay live for
(``device_loop.segment_length``), so a segment runs past a stop only when
an EOS ends a request inside it; a step that is not live (the reference's
loop condition) is a no-op.  The KV cache, the history and the control
scalars are engine buffers updated in place.  Greedy requests take the
graphs in every engine here; a sampled one-stream request too, with its
generator registered to the graph; a sampled batched segment runs one
eager step and one read per step (a slot draws noise only on its own live
steps, which a fixed graph cannot express).

``FusedSamEngine`` serves one request at a time; ``BatchedFusedSamEngine``
steps B request slots together over a dense batched cache, with a slot
scheduler and continuous admission at segment ends;
``PagedBatchedFusedSamEngine`` keeps the slots' KV in a shared page pool
read by the paged kernel (K4).  Each batched step is one ``[B, M]``
forward of every slot, live or not, so the shape never changes.

Greedy requests accept the longest prefix that matches the argmax: their
output equals ``engine.ArBaseline(block_size=M)``'s exactly, and a batched
engine's equals the same engine's with ``alpha=0`` (block-M AR through the
same ``[B, M]`` forward).  Sampled requests (``GenerationConfig(greedy=
False)``) accept by the chain rules of the request's ``accept_mode``:
rejection sampling (``chain_sampling_accept``, which keeps the target
distribution), or the typical and nucleus posterior rules
(``chain_posterior_accept``).  The rules are pure functions of the logits
and of explicit noise (``ChainNoise``), computed over ``[..., M, V]`` at
once.  Each sampled request owns one ``torch.Generator`` on the engine's
device, seeded with ``GenerationConfig.seed`` (a one-stream engine reseeds
its one generator per request): it draws the first token after the
prefill (from ``last_logits / temperature``, with no top-p or top-k, as
the reference does) and then one fixed-size block of noise per step in
which the request is live (a one-stream segment's no-op steps draw too,
after the request's last token).  So a request's sampled stream depends
only on its seed, its prompt, the weights and its own steps — not on its
slot, the other requests in the batch, or where segments end.  In a
batched engine greedy slots keep the argmax path exactly; the slots that
sample at once must share one sampling signature (``run`` raises
``ValueError`` otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .cache import init_kv_cache, update_slot
from .config import GenerationConfig
from .device import resolve_device
from .device_loop import LoopStats, StepGraphs, segment_length
from .engine import (PREFILL_BUCKETS, Outputs, _bucket, check_params_device,
                     check_request)
from .models.configs import ModelConfig, check_supported
from .models.llama import Params, block_decode_mask, forward, prefill_mask
from .ops.paged_attention import boundary_mask_window
from .paged_kv import (PagedAux, PagedKVPool, PagedRequest,
                       paged_flat_indices, paged_write_block)
from .streaming import ProgressStreamMixin
from .verify import (_process_logits, draw_first_token, draw_uniforms,
                     gumbel_from_uniform, take)


@dataclass(frozen=True)
class FusedSamConfig:
    max_ngram: int = 8        # match-window size Q
    ext: int = 56             # backward extension for full-window hits
    n_predicts: int = 59      # max draft continuation (block = +1)
    alpha: float = 4.0
    len_bias: int = 0
    # the most steps of one segment (``device_loop``): between two host
    # reads of one stream, between two admission points of a batch
    steps_per_call: int = 256
    corpus_capacity: int = 1 << 15  # static corpus buffer size
    # n-gram hash index (ops.ngram_index): an O(bucket) corpus probe in
    # place of the O(corpus) scan, for corpora of millions of tokens.  Every
    # gram size 1..max_ngram is indexed, so an exact match of length m is
    # served by the m-gram bucket; sizes past max_ngram (up to max_ngram +
    # ext) hash over the tail too and separate repetitions that overflow an
    # 8-gram bucket
    indexed: bool = False
    index_grams: Tuple[int, ...] = (32, 16, 8, 7, 6, 5, 4, 3, 2, 1)
    index_bucket_cap: int = 8
    # per-bucket extra table of the LATEST positions (dual probe); 0 = off
    index_keep_latest: int = 0
    # per-request KV-cache sizes (ascending): a request's cache is the
    # smallest bucket >= prompt + budget + block; () = max_cache_len
    cache_buckets: Tuple[int, ...] = ()

    @property
    def block(self) -> int:
        return self.n_predicts + 1


def suffix_match(buffer: torch.Tensor, buf_len: torch.Tensor,
                 query: torch.Tensor, tail: torch.Tensor,
                 tail_len: torch.Tensor, *, max_ngram: int,
                 ext: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longest-suffix match of each ``query`` (the [Q] trailing window, -1
    padded on the left) in its ``buffer[:buf_len]``.

    Batched over a leading slot axis: query [B, Q], tail [B, ext] (the
    tokens *preceding* the query window, newest last, -1 padded, for
    backward extension of full-window hits), tail_len [B]; buffer [B, L]
    with buf_len [B], or one buffer [1, L] with a 0-dim buf_len shared by
    all B queries (the corpus).  Unbatched 1-D arguments give 0-dim
    results.  Returns (match_len, end_pos), int32 [B]: end_pos is the first
    (earliest) end index of a longest match; match_len == 0 when nothing
    matches."""
    if query.dim() == 1:
        m, e = suffix_match(buffer[None], buf_len, query[None], tail[None],
                            tail_len.reshape(1), max_ngram=max_ngram,
                            ext=ext)
        return m[0], e[0]
    Bq, L = query.shape[0], buffer.shape[-1]
    Q = max_ngram
    dev = buffer.device
    idx = torch.arange(L, device=dev)
    run = torch.zeros((Bq, L), dtype=torch.int32, device=dev)
    alive = torch.ones((Bq, L), dtype=torch.bool, device=dev)
    for j in range(Q - 1, -1, -1):
        # window position j aligns with buffer index i - (Q-1) + j
        shift = Q - 1 - j
        shifted = torch.roll(buffer, shift, dims=-1)
        qj = query[:, j:j + 1]
        ok = (shifted == qj) & (qj >= 0) & (idx >= shift)
        alive = alive & ok
        run = run + alive.to(torch.int32)
    valid = idx < buf_len.reshape(-1, 1)
    run = torch.where(valid, torch.minimum(run, (idx + 1).to(torch.int32)),
                      0)
    best_len = run.amax(dim=1)                                   # [B]
    # first (earliest) end position among the longest matches
    is_best = (run == best_len[:, None]) & (best_len[:, None] > 0)
    end = torch.argmax(is_best.to(torch.int32), dim=1).to(torch.int32)
    # backward extension for full-window matches
    full = best_len >= torch.clamp(end + 1, max=Q)
    ar = torch.arange(ext, device=dev)
    eidx = end[:, None] - Q - ar                                 # [B, ext]
    ecand = torch.gather(buffer.expand(Bq, L), 1,
                         torch.clamp(eidx, 0, L - 1).long())
    etail = torch.flip(tail, (1,))                          # newest-first
    eok = (ecand == etail) & (eidx >= 0) & (etail >= 0) \
        & (ar < tail_len[:, None])
    extra = torch.cumprod(eok.to(torch.int32), dim=1).sum(dim=1)
    match = torch.where(
        best_len > 0,
        best_len + torch.where(full & (best_len == Q), extra, 0), 0)
    return match.to(torch.int32), end


def chain_tree_mask(dlens: torch.Tensor, M: int) -> torch.Tensor:
    """[..., M, M] in-block masks of chain drafts of length ``dlens`` [...]:
    row t sees block columns up to t below its slot's draft length, and
    always its own column (rows past the draft only feed the accept rule's
    bonus position)."""
    dev = dlens.device
    r = torch.arange(M, device=dev)
    tri = r[None, :] <= r[:, None]
    return (tri & (r[None, :] < dlens[..., None, None])) \
        | torch.eye(M, dtype=torch.bool, device=dev)


# ----------------------------------------------------------------------
# Chain sampling: accept rules over [..., M, V], with explicit noise
# ----------------------------------------------------------------------

class ChainNoise(NamedTuple):
    """One step's randomness for the chain accept rules."""
    uniform: torch.Tensor   # [..., M] in [0, 1): rejection's accept tests
    gumbel: torch.Tensor    # [..., G, V] Gumbel(0, 1); the last row draws
                            # the bonus, nucleus's rows 0..M-1 its samples


def chain_noise_rows(sig: tuple, M: int) -> int:
    """G, the Gumbel rows a step of signature ``sig`` reads: M + 1 for the
    nucleus rule (one sample per position and the bonus), else 1."""
    return M + 1 if sig[3] == "nucleus" else 1


def draw_chain_noise(generators: Sequence[Optional[torch.Generator]],
                     sig: tuple, M: int, V: int,
                     device: Union[str, torch.device]) -> ChainNoise:
    """One step's noise for B slots (``verify.draw_uniforms``, ``M + G *
    V`` per slot): ``[B, M]`` uniforms and ``[B, G, V]`` Gumbel noise."""
    G = chain_noise_rows(sig, M)
    u = draw_uniforms(generators, M + G * V, device)
    return ChainNoise(u[:, :M],
                      gumbel_from_uniform(u[:, M:]).reshape(-1, G, V))


def _flat_chain(logits, draft_tokens, draft_len, noise):
    """Leading axes flattened: ([N, M, V], [N, M] long, [N], [N, M],
    [N, G, V])."""
    M, V = logits.shape[-2:]
    return (logits.reshape(-1, M, V), draft_tokens.reshape(-1, M).long(),
            draft_len.reshape(-1), noise.uniform.reshape(-1, M),
            noise.gumbel.reshape(-1, noise.gumbel.shape[-2], V))


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[n, i[n]]`` for x [N, M, V] and i [N]: [N, V]."""
    return torch.gather(x, 1, i.long()[:, None, None].expand(
        -1, 1, x.shape[2]))[:, 0]


def chain_sampling_accept(warped: torch.Tensor, draft_tokens: torch.Tensor,
                          draft_len: torch.Tensor, noise: ChainNoise
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling along chain drafts (a deterministic
    proposal, q = 1), for every leading index at once: draft token i is
    accepted while ``uniform_i <= p_{i-1}(token_i)`` over the live
    positions ``i < draft_len``; at the first rejection the bonus is drawn
    from p_{i-1} with the rejected token removed and renormalized, and when
    all are accepted from the last accepted position's p.  The emitted
    tokens keep the target distribution exactly (reference
    ``samd_tpu/fused_sam.py:134-170``).

    warped [..., M, V] processed logits; draft_tokens [..., M];
    draft_len [...]; returns (accept_len, bonus), int32 [...]."""
    lead = warped.shape[:-2]
    w, d, dl, u, g = _flat_chain(warped, draft_tokens, draft_len, noise)
    M, V = w.shape[1:]
    p = torch.softmax(w, dim=-1)                                  # [N,M,V]
    tok = torch.clamp(d, 0, V - 1)
    p_tok = torch.gather(p[:, :-1], 2, tok[:, 1:, None])[..., 0]  # [N,M-1]
    i = torch.arange(1, M, device=w.device)
    ok = (u[:, 1:] <= p_tok) & (i[None, :] < dl[:, None])
    alen = 1 + torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    last = _row(p, alen - 1)                                      # [N, V]
    rejected = alen < dl
    rej_tok = torch.gather(tok, 1, torch.clamp(alen, max=M - 1).long()
                           [:, None])
    res = last.scatter(1, rej_tok, 0.0)
    res = res / torch.clamp(res.sum(dim=1, keepdim=True), min=1e-20)
    final = torch.where(rejected[:, None], res, last)
    bonus = torch.argmax(torch.log(torch.clamp(final, min=1e-20))
                         + g[:, -1], dim=1)
    return (alen.to(torch.int32).reshape(lead),
            bonus.to(torch.int32).reshape(lead))


def chain_posterior_accept(logits: torch.Tensor, draft_tokens: torch.Tensor,
                           draft_len: torch.Tensor, noise: ChainNoise, *,
                           temperature: float, mode: str,
                           posterior_threshold: float = 0.3,
                           posterior_alpha: float = 0.09,
                           top_p: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Typical or nucleus posterior acceptance along chain drafts
    (reference ``samd_tpu/fused_sam.py:173-208``).  ``typical``: token i
    is accepted while its probability under position i-1 exceeds
    ``min(posterior_threshold, exp(-entropy_{i-1}) * posterior_alpha)``;
    ``nucleus``: while it equals position i-1's top-p sample.  The bonus is
    drawn from the last accepted position's (warped) distribution.

    logits [..., M, V] raw f32; returns (accept_len, bonus), int32
    [...]."""
    lead = logits.shape[:-2]
    w, d, dl, _, g = _flat_chain(logits, draft_tokens, draft_len, noise)
    M, V = w.shape[1:]
    dev = w.device
    w = w / max(temperature, 1e-5)
    if mode == "nucleus":
        w = _process_logits(w, 1.0, top_p, 0)
    probs = torch.softmax(w, dim=-1)
    pos = torch.arange(M, device=dev)
    parent = torch.clamp(pos - 1, min=0)
    if mode == "typical":
        entropy = -(probs * torch.log(probs + 1e-5)).sum(dim=-1)  # [N, M]
        thresh = torch.clamp(torch.exp(-entropy) * posterior_alpha,
                             max=posterior_threshold)
        cand_p = torch.gather(probs[:, parent], 2,
                              torch.clamp(d, 0, V - 1)[:, :, None])[..., 0]
        ok = cand_p > thresh[:, parent]
    else:
        sampled = torch.argmax(w + g[:, :M], dim=-1)              # [N, M]
        ok = d == sampled[:, parent]
    ok = ok & (pos[None, :] < dl[:, None])
    alen = torch.cumprod(ok[:, 1:].to(torch.int32), dim=1).sum(dim=1) + 1
    bonus = torch.argmax(_row(w, alen - 1) + g[:, -1], dim=-1)
    return (alen.to(torch.int32).reshape(lead),
            bonus.to(torch.int32).reshape(lead))


AcceptFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, ChainNoise],
                    Tuple[torch.Tensor, torch.Tensor]]


def make_chain_accept_fn(sig: tuple) -> AcceptFn:
    """``(logits [..., M, V], draft_tokens, draft_len, noise) ->
    (accept_len, bonus)`` for a ``GenerationConfig.sampling_signature``."""
    temperature, top_p, top_k, mode, pthr, palpha = sig
    if mode in ("typical", "nucleus"):
        def posterior(logits, draft_tokens, draft_len, noise):
            return chain_posterior_accept(
                logits, draft_tokens, draft_len, noise,
                temperature=temperature, mode=mode, posterior_threshold=pthr,
                posterior_alpha=palpha, top_p=top_p)
        return posterior

    def rejection(logits, draft_tokens, draft_len, noise):
        warped = _process_logits(logits, temperature, top_p, top_k)
        return chain_sampling_accept(warped, draft_tokens, draft_len, noise)

    return rejection


class _DraftRules:
    """The hooks by which an engine's drafter meets the shared loops: the
    sampled accept rule and its noise (chain rules here; the tree engines
    of ``fused_hybrid`` take the tree rules), and what the drafter learns
    from a prefill (nothing here)."""

    def _accept_rule(self, sig: tuple):
        return make_chain_accept_fn(sig)

    def _draw_noise(self, generators, sig: tuple):
        return draw_chain_noise(generators, sig, self.cfg.block,
                                self.model_cfg.vocab_size, self.device)

    def _observe_prompt(self, slot: int, tokens: torch.Tensor, true_len: int,
                        logits: torch.Tensor, hidden: torch.Tensor) -> None:
        """The prefill's bucket-padded tokens [P], logits [P, V] and hidden
        states [P, H] for ``slot`` (0 for one stream); rows from
        ``true_len`` are padding."""

    def _last_start(self, W: int) -> int:
        """The longest committed length a step may start from in a cache
        of W slots: its block must fit."""
        return W - self.cfg.block

    def _max_accept(self) -> int:
        """The most tokens one step commits: the whole block (a chain's
        length; a tree engine may name its depth + 1)."""
        return self.cfg.block


class SingleStreamEngine(_DraftRules):
    """The request loop of the one-stream fused engines (``FusedSamEngine``
    and its hybrid subclass, ``pld.PldEngine``,
    ``token_recycle_fused.FusedTokenRecycleEngine``,
    ``eagle_fused.FusedEagle2Engine``): a prefill into a batch-1 cache (its
    logits shown to ``_observe_prompt``), then ``_step`` until the request
    is done.  ``cfg.block`` is the verify block M; the cache holds
    ``max_cache_len`` slots, or per request the smallest of
    ``cache_buckets`` that covers prompt + budget + M.  One KV buffer per
    bucket stays allocated, and the history and control scalars are
    engine buffers written in place, so a captured step never points at
    freed memory.

    Routes (``segmented``, a class attribute): ``True`` runs segments of
    ``device_loop.segment_length`` steps, on the card as replays of the
    step's CUDA graph (one per cache bucket and sampling signature, in
    ``graphs``), with one host read of the packed control vector per
    segment; a sampled request rides the graph with its generator
    registered to it.  ``False`` (set on an instance, by a caller that
    reads every step) runs one eager step and one read per step.
    ``loop_stats`` holds the last request's ``device_loop.LoopStats``.

    Subclasses implement ``_step`` (the contract of
    ``FusedSamEngine._step``); a greedy-only drafter refuses sampled
    requests in ``_accept_rule``, before the prefill."""

    segmented = True

    def __init__(self, model_cfg: ModelConfig, params: Params, cfg, *,
                 cache_buckets: Sequence[int] = (),
                 max_cache_len: int = 2048, eos_token_id: int = 2,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 device: Union[str, torch.device] = "cuda"):
        check_supported(model_cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.model_cfg = model_cfg
        self.params = params
        self.S = max_cache_len
        self.cache_buckets = tuple(sorted(cache_buckets))
        self.eos_token_id = eos_token_id
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= max_cache_len)
        dev = self.device
        # one KV buffer per cache bucket, kept for the engine's life
        self._kv = {max_cache_len: init_kv_cache(model_cfg, 1,
                                                 max_cache_len, dev)}
        self.kv_k, self.kv_v = self._kv[max_cache_len]
        self._chain_pos = torch.arange(cfg.block, dtype=torch.int32,
                                       device=dev)
        # the loop's state: the history, its length, the start token, the
        # budget left, the stop flag and the live steps run
        self._history = torch.zeros((max_cache_len,), dtype=torch.int32,
                                    device=dev)

        def scalar(dtype=torch.int32):
            return torch.zeros((), dtype=dtype, device=dev)

        self._hist_len, self._start, self._budget = (scalar() for _ in
                                                      range(3))
        self._done = scalar(torch.bool)
        self._live_steps = scalar()
        self._eos = torch.tensor(eos_token_id, dtype=torch.int32, device=dev)
        self._rng: Optional[torch.Generator] = None
        self.graphs = StepGraphs(dev)
        self.loop_stats = LoopStats()

    def _prefill(self, input_ids, P: int, W: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bucket's (zeroed) cache of W slots, prompt forward at offset
        0; returns the greedy next token (0-dim int32 on the device) and
        the last prompt row's logits [V]."""
        dev = self.device
        if W not in self._kv:
            self._kv[W] = init_kv_cache(self.model_cfg, 1, W, dev)
        self.kv_k, self.kv_v = self._kv[W]
        self.kv_k.zero_()
        self.kv_v.zero_()
        padded = torch.zeros((1, P), dtype=torch.int32)
        padded[0, :len(input_ids)] = torch.tensor(input_ids,
                                                  dtype=torch.int32)
        padded = padded.to(dev)
        logits, hidden = forward(
            self.params, self.model_cfg, padded,
            torch.arange(P, device=dev)[None, :], self.kv_k, self.kv_v, 0,
            prefill_mask(1, P, W, dev))
        self._observe_prompt(0, padded[0], len(input_ids), logits[0],
                             hidden[0])
        last = logits[0, len(input_ids) - 1]
        return torch.argmax(last).to(torch.int32), last

    def _commit(self, history: torch.Tensor, hist_len: torch.Tensor,
                start: torch.Tensor, budget: torch.Tensor,
                done: torch.Tensor, live: torch.Tensor,
                tokens: torch.Tensor, alen: torch.Tensor,
                any_eos: torch.Tensor, bonus: torch.Tensor):
        """A step's shared end: write the block's ``tokens`` [D] at
        ``hist_len`` and commit ``alen`` of them (EOS-trimmed; ``any_eos``
        says the trim hit one), ``bonus`` the next start token.  A step
        that is not ``live`` commits nothing and writes its history slots'
        own values back.  Returns (hist_len, start, budget, done)."""
        alen = torch.where(live, alen, 0)
        idx = torch.clamp(hist_len + self._chain_pos[:tokens.shape[0]],
                          max=history.shape[0] - 1).long()
        history.index_copy_(0, idx, torch.where(live, tokens, history[idx]))
        budget = budget - alen
        return (hist_len + alen, torch.where(live, bonus, start), budget,
                done | (live & (any_eos | (budget <= 0))))

    def _loop_step(self, W: int, accept: Optional[AcceptFn],
                   sig: Optional[tuple]) -> Callable[[], None]:
        """One step over the engine's buffers: live under the reference's
        loop condition (not done, budget left, ``hist_len <= last_start``),
        and a no-op otherwise."""
        hist_len, start, budget, done = (self._hist_len, self._start,
                                         self._budget, self._done)
        last_start = self._last_start(W)
        rng = self._rng

        def step():
            live = ~done & (budget > 0) & (hist_len <= last_start)
            noise = None if accept is None else self._draw_noise([rng], sig)
            out = self._step(W, self._history, hist_len, start, budget, done,
                             live, self._eos, accept, noise)
            for dst, src in zip((hist_len, start, budget, done), out):
                dst.copy_(src)
            self._live_steps.add_(live.to(torch.int32))

        return step

    def generate(self, input_ids: Sequence[int],
                 gen_config: Optional[GenerationConfig] = None) -> Outputs:
        from .fused_base import finalize_generation, init_history, pack_ctrl

        gen = gen_config or GenerationConfig()
        input_ids = list(input_ids)
        if not input_ids:
            raise ValueError("generate() requires a non-empty prompt")
        check_request(input_ids, gen, self.model_cfg.vocab_size)
        accept = sig = None
        if not gen.greedy:
            sig = gen.sampling_signature
            accept = self._accept_rule(sig)
        dev, M = self.device, self.cfg.block
        P = _bucket(len(input_ids), self.prefill_buckets)
        # cache bucket: the smallest configured size covering this
        # request's reachable length (prompt + budget + block)
        W = self.S
        need = max(len(input_ids) + gen.max_new_tokens + M, P)
        for w in self.cache_buckets:
            if need <= w < self.S:
                W = w
                break
        history = init_history(input_ids, self.S, "cpu")
        start, last = self._prefill(input_ids, P, W)
        if accept is not None:
            # one generator per engine, reseeded per request: the graphs
            # hold it registered
            if self._rng is None:
                self._rng = torch.Generator(device=dev)
            self._rng.manual_seed(gen.seed)
            start = draw_first_token(self._rng, last, gen.temperature)
        self._history.copy_(history)
        self._hist_len.fill_(len(input_ids))
        self._start.copy_(start)
        self._budget.fill_(gen.max_new_tokens)
        self._done.fill_(False)
        self._live_steps.zero_()

        step = self._loop_step(W, accept, sig)
        last_start = self._last_start(W)
        stats = LoopStats()
        hl, left, done, live_steps = len(input_ids), gen.max_new_tokens, \
            False, 0
        while not done and left > 0 and hl <= last_start:
            if self.segmented:
                k = segment_length([hl], [left], [last_start + M], M,
                                   self._max_accept(),
                                   self.cfg.steps_per_call)
                stats.replays += self.graphs.run(
                    (W, sig), step, k, None if accept is None else self._rng)
            else:
                k = 1
                step()
            stats.steps += k
            stats.segments += 1
            # the segment's one host read
            hl, left, done_i, live_steps = pack_ctrl(
                self._hist_len, self._budget, self._done,
                self._live_steps).cpu().tolist()
            done = bool(done_i)
        stats.noop_steps = stats.steps - live_steps
        self.loop_stats = stats
        output = finalize_generation(self._history, hl, len(input_ids),
                                     self.eos_token_id, gen.max_new_tokens)
        return Outputs(output, len(output) - len(input_ids), live_steps,
                       [])


class FusedSamEngine(SingleStreamEngine):
    """Fused retrieval decoding over one batch-1 KV cache: greedy, or
    sampled by the request's accept rule.  Keyword arguments are
    ``SingleStreamEngine``'s."""

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 fs_cfg: Optional[FusedSamConfig] = None, *,
                 corpus: Optional[Sequence[int]] = None, **kwargs):
        from .fused_base import (_retrieval_draft_argform,
                                 build_optional_index, load_corpus_buffer)

        fs_cfg = fs_cfg or FusedSamConfig()
        super().__init__(model_cfg, params, fs_cfg,
                         cache_buckets=fs_cfg.cache_buckets, **kwargs)
        # retrieval state (the corpus and its optional index) is an
        # explicit argument of every draft call
        self.corpus, self.corpus_len = load_corpus_buffer(
            corpus, self.cfg.corpus_capacity, self.device)
        self.corpus_index = build_optional_index(corpus, self.cfg,
                                                 self.device)
        self._draft = _retrieval_draft_argform(
            S=self.S, max_ngram=self.cfg.max_ngram, ext=self.cfg.ext,
            len_bias=self.cfg.len_bias, block=self.cfg.block)

    def _step(self, W: int, history: torch.Tensor, hist_len: torch.Tensor,
              start: torch.Tensor, budget: torch.Tensor, done: torch.Tensor,
              live: torch.Tensor, eos: torch.Tensor,
              accept: Optional[AcceptFn] = None,
              noise: Optional[ChainNoise] = None):
        """One draft → verify → accept → commit step, on the device; greedy
        without ``accept``, else that chain rule with this step's
        ``noise`` (leading slot axis of 1).  Writes the block into the
        history and the KV cache in place and returns (hist_len, start,
        budget, done) as 0-dim tensors.  A step that is not ``live`` (the
        caller's flag: not done, budget left, the block fits) is a no-op:
        it commits nothing, keeps hist_len, budget and start, and writes
        its block at ``min(hist_len, W - M)``, inside the cache."""
        fc, M = self.cfg, self.cfg.block
        chain_pos = self._chain_pos
        match, _, draft_tokens, cont_avail = (t[0] for t in self._draft(
            self.corpus, self.corpus_len, history[None], hist_len[None],
            start[None], self.corpus_index))
        # adaptive draft length n = 1 + match * alpha (sam_only policy)
        n = torch.clamp(1 + (match.float() * fc.alpha).to(torch.int32),
                        max=fc.n_predicts + 1)
        draft_len = torch.where(match > 0, torch.minimum(n, 1 + cont_avail),
                                1).to(torch.int32)
        off = torch.clamp(hist_len, max=W - M)     # hist_len when live
        mask = block_decode_mask(chain_tree_mask(draft_len, M), off, W)
        logits, _ = forward(
            self.params, self.model_cfg,
            torch.clamp(draft_tokens, min=0)[None],
            (chain_pos + off)[None], self.kv_k, self.kv_v, off, mask)
        if accept is not None:
            alen, bonus = (t[0] for t in accept(
                logits, draft_tokens[None], draft_len[None], noise))
        else:
            argmax_tok = torch.argmax(logits[0], dim=-1).to(torch.int32)
            in_draft = chain_pos < draft_len
            hit = (draft_tokens[1:] == argmax_tok[:-1]) & in_draft[1:]
            alen = torch.cumprod(hit.to(torch.int32), dim=0).sum() + 1
        is_eos = (draft_tokens == eos) & (chain_pos < alen)
        any_eos = torch.any(is_eos)
        alen = torch.where(any_eos,
                           torch.argmax(is_eos.to(torch.int32)) + 1,
                           alen).to(torch.int32)
        if accept is None:
            bonus = take(argmax_tok, alen - 1)
        return self._commit(history, hist_len, start, budget, done, live,
                            draft_tokens, alen, any_eos, bonus)


# ----------------------------------------------------------------------
# Batched fused serving: continuous batching x device-resident retrieval
# ----------------------------------------------------------------------

# finished requests whose loop statistics a batched engine keeps
LOOP_STATS_KEPT = 4096


class BatchedFusedSamEngine(_DraftRules, ProgressStreamMixin):
    """B request slots stepped together (reference
    ``samd_tpu/fused_sam.py:446-887``).

    Per segment (at most ``steps_per_call`` steps) every slot drafts from
    its own history and the shared corpus, and one ``[B, M]`` forward
    verifies all B slots, live or not; accept, EOS, budget and commit run
    per slot on the device.  Each step reads one packed ``[6, B]`` int32
    control matrix (committed lengths, start tokens, budgets, live flags,
    live steps, live steps drafted from the corpus) — the counterpart of
    the reference's ``while_loop`` and its single transfer.  When requests
    wait in the queue, a segment ends as soon as a slot frees, so it can be
    refilled.  Host work per segment: admit and finish slots.  Per-request
    progress streaming through ``progress_listeners``
    (``streaming.ProgressStreamMixin``).

    Sampled requests: each slot keeps its request's generator and draws
    its noise only in steps where it is live; when any slot samples, the
    step computes the signature's accept rule over all ``[B, M, V]`` and
    takes its result in the sampled slots only (``samp_flags``), so greedy
    slots keep the argmax path exactly.  Slots sampling at once share one
    signature; ``run`` raises ``ValueError`` otherwise.

    ``inline_prefill``: a greedy request is admitted without a prefill
    forward; its prompt streams through the decode steps as a forced-accept
    chain, M tokens per step.  A sampled request is prefilled, to draw its
    first token.

    ``segmented`` (a class attribute) picks the route of greedy segments:
    ``True`` runs them as replays of the step's CUDA graph (``graphs``)
    with one host read each (``_segment``); ``False`` (set on an
    instance, by a caller that reads every step) one eager step and one
    read per step.  ``loop_stats`` maps the ids of the latest
    ``LOOP_STATS_KEPT`` finished requests to their
    ``device_loop.LoopStats``.
    """

    segmented = True

    def __init__(self, model_cfg: ModelConfig, params: Params,
                 fs_cfg: Optional[FusedSamConfig] = None, *,
                 corpus: Optional[Sequence[int]] = None,
                 batch_size: int = 4, max_cache_len: int = 2048,
                 eos_token_id: int = 2,
                 prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
                 inline_prefill: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        from .fused_base import (_retrieval_draft_argform,
                                 build_optional_index, load_corpus_buffer)

        check_supported(model_cfg)
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.model_cfg = model_cfg
        self.params = params
        # short segments by default: steps_per_call is the admission
        # granularity of continuous batching
        self.cfg = fs_cfg or FusedSamConfig(steps_per_call=16)
        self.B = batch_size
        self.S = max_cache_len
        self.eos_token_id = eos_token_id
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= max_cache_len)
        self.inline_prefill = inline_prefill
        self._init_kv()
        self.corpus, self.corpus_len = load_corpus_buffer(
            corpus, self.cfg.corpus_capacity, self.device)
        self.corpus_index = build_optional_index(corpus, self.cfg,
                                                 self.device)
        M = self.cfg.block
        self._draft = _retrieval_draft_argform(
            S=self.S, max_ngram=self.cfg.max_ngram, ext=self.cfg.ext,
            len_bias=self.cfg.len_bias, block=M)
        # M columns past S: a slot stepped with the batch after it stopped
        # writes its draft beyond its committed tokens, never over them
        # (the reference's clamped update would overwrite them at S)
        self.histories = torch.zeros((batch_size, self.S + M),
                                     dtype=torch.int32, device=self.device)
        dev = self.device
        self._chain_pos = torch.arange(M, dtype=torch.int32, device=dev)
        self._eos = torch.tensor(eos_token_id, dtype=torch.int32, device=dev)
        # host-side slot bookkeeping
        self._slot_req: List[Optional[int]] = [None] * batch_size
        self._slot_prompt = [0] * batch_size
        self._slot_max_new = [0] * batch_size
        self._slot_steps = [0] * batch_size
        # a sampled request's generator, held by its slot
        self._slot_gen: List[Optional[torch.Generator]] = [None] * batch_size
        self.queue = []
        self.results = {}
        # the finished requests' device_loop.LoopStats, by request id (the
        # latest LOOP_STATS_KEPT)
        self.loop_stats = {}
        self._slot_loop = [LoopStats() for _ in range(batch_size)]
        self._next_id = 0
        # the segment's buffers, uploaded once and read once a segment:
        # rows committed lengths, start tokens, budgets, live flags (read
        # side), decode steps, corpus steps, live steps, prompt lengths
        # (inline prefill), capacity limits; the live flags themselves
        self._seg = torch.zeros((9, batch_size), dtype=torch.int32,
                                device=dev)
        self._lives = torch.zeros((batch_size,), dtype=torch.bool,
                                  device=dev)
        self.graphs = StepGraphs(dev)
        self.steps_run = 0      # [B, M] decode forwards, over all runs
        # live slot-steps, and those whose draft came from the corpus
        self.stats_live_steps = 0
        self.stats_corpus_steps = 0

    # -- subclass hooks (the paged variant swaps the KV backend) ---------
    def _init_kv(self):
        self.kv_k, self.kv_v = init_kv_cache(self.model_cfg, self.B, self.S,
                                             self.device)

    def _prefill_slot(self, slot: int, ids
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Admit one request's prompt into ``slot``: a batch-1 prefill into
        a fresh cache, written into the slot; returns the greedy next token
        and the last prompt row's logits."""
        P = _bucket(len(ids), self.prefill_buckets)
        fk, fv = init_kv_cache(self.model_cfg, 1, self.S, self.device)
        first = self._prefill_forward(slot, ids, P, fk, fv, self.S)
        update_slot(self.kv_k, fk, slot)
        update_slot(self.kv_v, fv, slot)
        self._seed_history(slot, ids)
        return first

    def _alloc_limits(self) -> np.ndarray:
        """Per-slot KV capacity for the next segment (paged: the pages
        allocated)."""
        return np.full((self.B,), self.S, np.int32)

    def _paged_aux(self) -> Optional[PagedAux]:
        return None

    def _pre_segment(self, hist_lens, actives) -> None:
        """Called before each segment (paged: grow page tables)."""

    def _release_slot(self, slot: int) -> None:
        """Called when a request finishes (paged: free its pages)."""

    def _should_retry_slot(self, slot: int, hist_len: int,
                           budget: int) -> bool:
        """A slot ended the segment not live but unfinished for a reason
        that can clear (paged: pool capacity) → keep it active."""
        return False

    def _post_segment(self, stepped: int) -> None:
        """Called with the segment's total live steps (paged: stall
        guard)."""

    def _can_admit(self, ids) -> bool:
        """Whether the next queued prompt can be admitted now (paged: the
        pool must have pages for its prefill bucket)."""
        return True

    def _check_fits(self, ids, gen: GenerationConfig) -> None:
        """Raise ValueError unless the prompt can ever be admitted: within
        the largest prefill bucket, or for an inline greedy prompt, with a
        block of room in the cache."""
        if self.inline_prefill and gen.greedy:
            if len(ids) + self.cfg.block > self.S:
                raise ValueError(f"prompt length {len(ids)} leaves no block "
                                 f"of room in a cache of {self.S}")
            return
        if not self.prefill_buckets or len(ids) > self.prefill_buckets[-1]:
            raise ValueError(f"prompt length {len(ids)} exceeds the largest "
                             f"prefill bucket {self.prefill_buckets[-1:]}")

    def _admit_inline(self, slot: int) -> None:
        """Inline-prefill admission bookkeeping (paged: free the previous
        occupant's pages; growth happens per segment)."""

    # -- device pieces ---------------------------------------------------
    def _prefill_forward(self, slot: int, ids, P: int, fk, fv, W: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bucket-padded prompt's forward at offset 0 into a batch-1
        cache of W slots, shown to the drafter of ``slot``; returns the
        greedy next token (0-dim, on the device) and the last prompt row's
        logits [V]."""
        dev = self.device
        padded = torch.zeros((1, P), dtype=torch.int32)
        padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        padded = padded.to(dev)
        logits, hidden = forward(self.params, self.model_cfg, padded,
                                 torch.arange(P, device=dev)[None, :], fk,
                                 fv, 0, prefill_mask(1, P, W, dev))
        self._observe_prompt(slot, padded[0], len(ids), logits[0],
                             hidden[0])
        last = logits[0, len(ids) - 1]
        return torch.argmax(last).to(torch.int32), last

    def _seed_history(self, slot: int, ids) -> None:
        """The slot's history row: the prompt, zeros after it."""
        row = torch.zeros((self.histories.shape[1],), dtype=torch.int32)
        row[:len(ids)] = torch.tensor(ids, dtype=torch.int32)
        self.histories[slot] = row.to(self.device)

    def _masks(self, hist_lens: torch.Tensor, dlens: torch.Tensor,
               paged: Optional[PagedAux]) -> torch.Tensor:
        """Each slot's chain mask: the committed prefix, then the draft
        prefix up to its length, and every row's own column.  Dense [B, M,
        S]; paged, the [B, M, W*page] boundary windows."""
        tm = chain_tree_mask(dlens, self.cfg.block)            # [B, M, M]
        if paged is not None:
            return boundary_mask_window(tm, hist_lens, self.kv_k.page_size)
        return block_decode_mask(tm, hist_lens, self.S)

    def _step(self, hist_lens, starts, budgets, lives, slot_steps,
              corpus_steps, prompt_lens, alloc_limits, paged, samp=None,
              accept: Optional[AcceptFn] = None,
              noise: Optional[ChainNoise] = None):
        """One draft → verify → accept → commit step of all B slots, on the
        device (reference body, ``samd_tpu/fused_sam.py:649-732``).  With
        ``accept``, the slots flagged in ``samp`` [B] take that chain rule's
        result under this step's ``noise``.  Writes the KV and the history
        in place; returns the new (hist_lens, starts, budgets, lives,
        slot_steps, corpus_steps)."""
        fc, M, S = self.cfg, self.cfg.block, self.S
        chain_pos = self._chain_pos
        hist = self.histories
        match, use_dyn, drafts, cont_avail = self._draft(
            self.corpus, self.corpus_len, hist[:, :S], hist_lens, starts,
            self.corpus_index)
        n = torch.clamp(1 + (match.float() * fc.alpha).to(torch.int32),
                        max=fc.n_predicts + 1)
        dlens = torch.where(match > 0, torch.minimum(n, 1 + cont_avail),
                            1).to(torch.int32)
        from_corpus = (match > 0) & ~use_dyn
        pos = hist_lens[:, None] + chain_pos[None, :]             # [B, M]
        if self.inline_prefill:
            # a slot still inside its prompt drafts the NEXT M prompt
            # tokens as a forced-accept chain
            pf_rest = prompt_lens - hist_lens
            in_pf = pf_rest > 0
            forced = torch.clamp(pf_rest, max=M).to(torch.int32)
            drafts = torch.where(in_pf[:, None],
                                 torch.gather(hist, 1, pos.long()), drafts)
            dlens = torch.where(in_pf, forced, dlens)
        logits, _ = forward(
            self.params, self.model_cfg, torch.clamp(drafts, min=0), pos,
            self.kv_k, self.kv_v, hist_lens,
            self._masks(hist_lens, dlens, paged), paged=paged)
        argmax_tok = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, M]

        def at(col):               # argmax_tok[b, max(col[b], 0)]
            return torch.gather(argmax_tok, 1, torch.clamp(
                col, min=0).long()[:, None])[:, 0]

        in_draft = chain_pos[None, :] < dlens[:, None]
        hit = (drafts[:, 1:] == argmax_tok[:, :-1]) & in_draft[:, 1:]
        alens = (torch.cumprod(hit.to(torch.int32), dim=1).sum(dim=1)
                 + 1).to(torch.int32)
        bonus = at(alens - 1)
        if accept is not None:
            alens_s, bonus_s = accept(logits, drafts, dlens, noise)
            alens = torch.where(samp, alens_s, alens)
            bonus = torch.where(samp, bonus_s, bonus)
        if self.inline_prefill:
            # prompt rows are accepted as forced; the boundary block's bonus
            # is the first generated token, mid-prompt the next start is the
            # next prompt token; EOS and budget do not apply to the prompt
            alens = torch.where(in_pf, forced, alens)
            bonus = torch.where(in_pf, at(forced - 1), bonus)
            nxt_prompt = torch.gather(hist, 1, torch.clamp(
                hist_lens + M, max=S - 1).long()[:, None])[:, 0]
            bonus = torch.where(in_pf & (pf_rest > M), nxt_prompt, bonus)
        is_eos = (drafts == self._eos) & (chain_pos[None, :] < alens[:, None])
        if self.inline_prefill:
            is_eos = is_eos & ~in_pf[:, None]
        any_eos = is_eos.any(dim=1)
        alens = torch.where(
            any_eos, torch.argmax(is_eos.to(torch.int32), dim=1) + 1,
            alens).to(torch.int32)
        alens = torch.where(lives, alens, 0)
        bonus = torch.where(any_eos, at(alens - 1), bonus)
        hist.scatter_(1, pos.long(), torch.clamp(drafts, min=0))
        hist_lens = hist_lens + alens
        counted = lives
        if self.inline_prefill:   # prompt tokens consume no budget
            budgets = budgets - torch.where(in_pf, 0, alens)
            counted = counted & ~in_pf
        else:
            budgets = budgets - alens
        slot_steps = slot_steps + counted.to(torch.int32)
        corpus_steps = corpus_steps + (counted & from_corpus).to(torch.int32)
        starts = torch.where(lives, bonus, starts)
        lives = lives & ~any_eos & (budgets > 0) \
            & (hist_lens + M <= alloc_limits)
        return hist_lens, starts, budgets, lives, slot_steps, corpus_steps

    def _segment_step(self, paged: Optional[PagedAux], samp=None,
                      accept: Optional[AcceptFn] = None
                      ) -> Callable[..., None]:
        """One step of every slot over the segment buffers (``_seg``'s
        rows and ``_lives``), in place; ``step(noise)`` for a sampled
        segment."""
        seg, lives = self._seg, self._lives
        state = (seg[0], seg[1], seg[2], lives, seg[4], seg[5])

        def step(noise: Optional[ChainNoise] = None):
            seg[6].add_(lives.to(torch.int32))         # live steps, prompt too
            out = self._step(*state, seg[7], seg[8], paged, samp, accept,
                             noise)
            for dst, src in zip(state, out):
                dst.copy_(src)

        return step

    def _read_segment(self) -> np.ndarray:
        """The one host read: the [7, B] control matrix (rows as ``_seg``'s
        first seven)."""
        self._seg[3].copy_(self._lives)
        return self._seg[:7].cpu().numpy()

    def _segment(self, hist_lens, starts, budgets, actives, prompt_lens,
                 refill: bool, samp: np.ndarray,
                 sig: Optional[tuple]) -> Tuple[np.ndarray, int, int]:
        """One segment; returns the last control matrix [7, B] on the host
        (committed lengths, start tokens, budgets, live flags, decode
        steps, corpus steps, live steps with prompt steps), the steps run
        and how many of them were graph replays.  ``samp`` [B] flags the
        slots that sample under ``sig``.

        Greedy segments on the ``segmented`` route run
        ``device_loop.segment_length`` steps (the minimum over the live
        slots with ``refill``, else the maximum), replayed as the step's
        CUDA graph on the card, with one host read.  A sampled segment, or
        any on the per-step route, runs eager steps with one read each, up
        to ``steps_per_call``, and ends early when no slot is live or, with
        ``refill``, when a slot frees."""
        M, dev, B = self.cfg.block, self.device, self.B
        limits = self._alloc_limits()
        init_lives = actives & (budgets > 0) & (hist_lens + M <= limits)
        zeros = np.zeros_like(hist_lens)
        host = np.stack([hist_lens, starts, budgets,
                         init_lives.astype(np.int32), zeros, zeros, zeros,
                         prompt_lens, limits]).astype(np.int32)
        if not init_lives.any():
            return host[:7], 0, 0
        self._seg.copy_(torch.from_numpy(host))
        self._lives.copy_(self._seg[3])
        paged = self._paged_aux()
        if self.segmented and not (sig is not None and samp.any()):
            live = init_lives
            k = segment_length(
                hist_lens[live], budgets[live], limits[live], M,
                self._max_accept(), self.cfg.steps_per_call, refill,
                (prompt_lens - hist_lens)[live] if self.inline_prefill
                else None)
            replays = self.graphs.run("step", self._segment_step(paged), k)
            self.steps_run += k
            return self._read_segment(), k, replays
        accept = samp_t = None
        if sig is not None and samp.any():
            accept = self._accept_rule(sig)
            samp_t = torch.from_numpy(samp).to(dev)
        step = self._segment_step(paged, samp_t, accept)
        ctrl, lives, steps = host[:7], init_lives, 0
        while lives.any() and steps < self.cfg.steps_per_call \
                and not (refill and (init_lives & ~lives).any()):
            noise = None
            if accept is not None:
                # only the live sampled slots draw: a slot's stream advances
                # with its own steps alone
                noise = self._draw_noise(
                    [self._slot_gen[i] if samp[i] and lives[i] else None
                     for i in range(B)], sig)
            step(noise)
            self.steps_run += 1
            ctrl = self._read_segment()     # the step's one host read
            lives = ctrl[3].astype(bool)
            steps += 1
        return ctrl, steps, 0

    # -- scheduler -------------------------------------------------------
    def add_request(self, input_ids: Sequence[int],
                    gen_config: Optional[GenerationConfig] = None) -> int:
        gen = gen_config or GenerationConfig()
        ids = list(input_ids)
        if not ids:
            raise ValueError("add_request() requires a non-empty prompt")
        # rejected here, before the queue: a request the engine cannot serve
        # would otherwise fail (or stall) the whole batch in run()
        check_request(ids, gen, self.model_cfg.vocab_size)
        self._check_fits(ids, gen)
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, ids, gen))
        return rid

    def run(self):
        """Serve every queued request; returns {request id: Outputs}.  A
        failure releases every slot (and its pages) before it propagates."""
        try:
            return self._run()
        except BaseException:
            for i in range(self.B):
                if self._slot_req[i] is not None:
                    self._stream_done(self._slot_req[i])
                    self._slot_req[i] = None
                    self._slot_gen[i] = None
                    self._release_slot(i)
            raise

    def _run(self):
        B = self.B
        hist_lens = np.zeros(B, np.int32)
        starts = np.zeros(B, np.int32)
        budgets = np.zeros(B, np.int32)
        actives = np.zeros(B, bool)
        prompt_lens = np.zeros(B, np.int32)
        samp = np.zeros(B, bool)
        slot_sigs: List[Optional[tuple]] = [None] * B

        while self.queue or actives.any():
            # admit
            for i in range(B):
                if actives[i] or not self.queue:
                    continue
                if not self._can_admit(self.queue[0][1]):
                    break  # paged: no pages for a prompt yet; retry later
                rid, ids, gen = self.queue.pop(0)
                self._slot_req[i] = rid
                if self.inline_prefill and gen.greedy:
                    self._admit_inline(i)
                    self._seed_history(i, ids)
                    nt = ids[0]          # host-known; no fetch
                    hist_lens[i] = 0
                    prompt_lens[i] = len(ids)
                else:
                    first, last = self._prefill_slot(i, ids)
                    hist_lens[i] = len(ids)
                    prompt_lens[i] = 0
                    if not gen.greedy:
                        g = torch.Generator(device=self.device)
                        g.manual_seed(gen.seed)
                        first = draw_first_token(g, last, gen.temperature)
                        self._slot_gen[i] = g
                    nt = int(first)
                slot_sigs[i] = None if gen.greedy else gen.sampling_signature
                samp[i] = not gen.greedy
                self._slot_prompt[i] = len(ids)
                self._slot_max_new[i] = gen.max_new_tokens
                self._slot_steps[i] = 0
                self._slot_loop[i] = LoopStats()
                starts[i] = nt
                budgets[i] = gen.max_new_tokens
                actives[i] = True
            if not actives.any():
                break
            sigs = {sg for sg in slot_sigs if sg is not None}
            if len(sigs) > 1:
                raise ValueError(
                    "concurrent sampling requests must share one sampling "
                    f"signature; got {sigs}")
            self._pre_segment(hist_lens, actives)
            ctrl, seg_steps, seg_replays = self._segment(
                hist_lens, starts, budgets, actives, prompt_lens,
                bool(self.queue), samp, next(iter(sigs)) if sigs else None)
            hist_lens = ctrl[0].copy()
            starts = ctrl[1].copy()
            budgets = ctrl[2].copy()
            lives = ctrl[3].astype(bool)
            steps_arr = ctrl[4]
            self.stats_live_steps += int(steps_arr[actives].sum())
            self.stats_corpus_steps += int(ctrl[5][actives].sum())
            self._post_segment(int(steps_arr[actives].sum())
                               if actives.any() else 0)
            self._emit_stream_progress(actives, hist_lens)
            hist_np = None
            for i in range(B):
                if not actives[i]:
                    continue
                self._slot_steps[i] += int(steps_arr[i])
                st = self._slot_loop[i]
                if seg_steps:
                    st.segments += 1
                    st.steps += seg_steps
                    st.replays += seg_replays
                    st.noop_steps += seg_steps - int(ctrl[6][i])
                if lives[i] or self._should_retry_slot(
                        i, int(hist_lens[i]), int(budgets[i])):
                    continue        # still going, or a transient stall
                # finished: extract output
                if hist_np is None:
                    hist_np = self.histories.cpu().numpy()
                ids = hist_np[i, :hist_lens[i]].tolist()
                plen = self._slot_prompt[i]
                gen_part = ids[plen:]
                if self.eos_token_id in gen_part:
                    gen_part = gen_part[:gen_part.index(
                        self.eos_token_id) + 1]
                gen_part = gen_part[:self._slot_max_new[i]]
                self.results[self._slot_req[i]] = Outputs(
                    ids[:plen] + gen_part, len(gen_part),
                    self._slot_steps[i], [])
                self.loop_stats[self._slot_req[i]] = st
                if len(self.loop_stats) > LOOP_STATS_KEPT:
                    self.loop_stats.pop(next(iter(self.loop_stats)))
                self._stream_done(self._slot_req[i])
                actives[i] = False
                samp[i] = False
                slot_sigs[i] = None
                self._slot_req[i] = None
                self._slot_gen[i] = None
                self._release_slot(i)
        out, self.results = self.results, {}
        return out


# ----------------------------------------------------------------------
# Paged batched fused serving over a shared page pool
# ----------------------------------------------------------------------

class PagedBatchedFusedSamEngine(BatchedFusedSamEngine):
    """``BatchedFusedSamEngine`` whose KV lives in a shared page pool
    (reference ``samd_tpu/fused_sam.py:894-1069``).

    Each step's forward scatters the fresh KV into pages and attends
    straight over the pool through the page tables (K4,
    ``ops.paged_attention``).  Per segment the host pre-allocates each live
    slot's worst-case growth (``steps_per_call * block`` tokens) and passes
    the tables and per-slot capacity limits to the steps; a tight pool
    shortens the segment, and a slot that stops at capacity retries once
    pages free.  A finished request returns its pages, so the footprint
    follows the live tokens, not B x S.

    ``quantized_kv=True`` stores int8 pages with f32 per-row scales: half
    the page bytes of bf16.  The prefill runs a dense batch-1 forward into
    a fresh bf16 cache of the prompt's bucket and scatters it into pages
    (quantized on the way for an int8 pool), as the reference does.  Chain
    drafts commit a prefix of the written block, so no KV compaction is
    needed.
    """

    def __init__(self, *args, n_pages: int = 64, page_size: int = 128,
                 quantized_kv: bool = False, **kwargs):
        self._n_pages = n_pages
        self._page_size = page_size
        self._quantized_kv = quantized_kv
        super().__init__(*args, **kwargs)

    # -- hooks -------------------------------------------------------------
    def _init_kv(self):
        if self.S % self._page_size != 0:
            raise ValueError("max_cache_len must be a multiple of page_size")
        if self.model_cfg.kv_quant:
            raise ValueError("the paged engine manages its own KV "
                             "quantization (quantized_kv=True); use a "
                             "kv_quant=False model config")
        self.pool = PagedKVPool(self.model_cfg, n_pages=self._n_pages,
                                page_size=self._page_size,
                                device=self.device,
                                quantized=self._quantized_kv)
        self.kv_k, self.kv_v = self.pool.k, self.pool.v
        self.page_reqs = [PagedRequest(self.pool, self.S)
                          for _ in range(self.B)]
        self._limits = np.zeros((self.B,), np.int32)
        self._stall = 0
        self.peak_pages = 0   # high-water mark of allocated pages
        # a stopped slot's kv_limit (hist + block) can pass S by up to one
        # block: -1 columns keep its table reads in range (and its writes
        # on the scratch page)
        self._table_pad = -(-self.cfg.block // self._page_size) + 1
        self._tables_host = None
        self._tables_t = torch.full(
            (self.B, self.page_reqs[0].max_pages + self._table_pad), -1,
            dtype=torch.int32, device=self.device)

    def _tables(self) -> torch.Tensor:
        """The [B, P + pad] device tables: one buffer for the engine's life
        (a captured step reads it), written again only when a page
        assignment changed."""
        host = np.stack([r.host_table() for r in self.page_reqs])
        host = np.pad(host, ((0, 0), (0, self._table_pad)),
                      constant_values=-1)
        if self._tables_host is None or \
                not np.array_equal(self._tables_host, host):
            self._tables_t.copy_(torch.from_numpy(host))
            self._tables_host = host
        return self._tables_t

    def _alloc_limits(self) -> np.ndarray:
        return self._limits

    def _paged_aux(self) -> PagedAux:
        return PagedAux(self._tables(), self.pool.scratch_page)

    def _pre_segment(self, hist_lens, actives) -> None:
        grow = self.cfg.steps_per_call * self.cfg.block
        for i in range(self.B):
            if not actives[i]:
                self._limits[i] = 0
                continue
            want = min(self.S, int(hist_lens[i]) + grow)
            # best-effort: a tight pool shortens the segment (the slot's
            # limit guard ends it at capacity) instead of failing
            self._limits[i] = self.page_reqs[i].ensure_upto(want)
        self.peak_pages = max(self.peak_pages,
                              self.pool.n_pages - len(self.pool._free))

    def _release_slot(self, slot: int) -> None:
        self.page_reqs[slot].release()

    def _should_retry_slot(self, slot: int, hist_len: int,
                           budget: int) -> bool:
        # unfinished only because allocation stopped short of the slot's
        # dense limit: keep it active, pages free as others finish (a
        # coincidental EOS here merely generates past it; the finish trim
        # keeps the output right)
        M = self.cfg.block
        return (budget > 0 and hist_len + M <= self.S
                and hist_len + M > int(self._limits[slot]))

    def _post_segment(self, stepped: int) -> None:
        if stepped == 0:
            self._stall += 1
            if self._stall >= 3:
                raise MemoryError(
                    "paged KV pool too small: no slot could step for 3 "
                    f"consecutive segments ({self.pool.n_pages} pages of "
                    f"{self._page_size})")
        else:
            self._stall = 0

    def _can_admit(self, ids) -> bool:
        P = _bucket(len(ids), self.prefill_buckets)
        return self.pool.pages_for(P) <= len(self.pool._free)

    def _check_fits(self, ids, gen: GenerationConfig) -> None:
        # admission takes the prompt's bucket of pages, inline or not; a
        # bucket larger than the whole pool would wait forever
        if not self.prefill_buckets or len(ids) > self.prefill_buckets[-1]:
            raise ValueError(f"prompt length {len(ids)} exceeds the largest "
                             f"prefill bucket {self.prefill_buckets[-1:]}")
        need = self.pool.pages_for(_bucket(len(ids), self.prefill_buckets))
        if need > self.pool.n_pages:
            raise ValueError(f"prompt length {len(ids)} needs {need} pages; "
                             f"the pool holds {self.pool.n_pages}")

    def live_kv_tokens(self) -> int:
        """Pool tokens allocated to requests right now."""
        return sum(len(r.pages) for r in self.page_reqs) * self._page_size

    def _admit_inline(self, slot: int) -> None:
        self.page_reqs[slot].release()

    # -- prefill: dense batch-1 forward, scattered into pages ---------------
    def _prefill_slot(self, slot: int, ids
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        P = _bucket(len(ids), self.prefill_buckets)
        req = self.page_reqs[slot]
        req.release()
        req.ensure(min(-(-P // self._page_size) * self._page_size, self.S))
        # a bf16 (cfg.dtype) cache of P slots, also over an int8 pool
        fk, fv = init_kv_cache(self.model_cfg, 1, P, self.device)
        first = self._prefill_forward(slot, ids, P, fk, fv, P)
        flat_pg, flat_sl = paged_flat_indices(
            req.table(self.device)[None],
            torch.zeros((1,), dtype=torch.int32, device=self.device), P,
            self._page_size, self.pool.scratch_page)
        for l in range(self.model_cfg.num_layers):
            paged_write_block(self.kv_k[l], fk[l], flat_pg, flat_sl)
            paged_write_block(self.kv_v[l], fv[l], flat_pg, flat_sl)
        self._seed_history(slot, ids)
        return first
