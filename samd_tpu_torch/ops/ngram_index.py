"""n-gram hash index for corpus-scale fused retrieval (counterpart of
``samd_tpu/ops/ngram_index.py``; the port keeps its own copy of the host
builder).

The brute-force corpus search (``fused_sam.suffix_match``) reads the whole
corpus buffer on every step.  The index replaces that scan with a probe:

  * build (host, numpy): for each gram size n, hash the n-gram ending at
    every corpus position into ``[num_buckets, bucket_cap]`` position
    tables that keep the ``bucket_cap`` EARLIEST positions per bucket (the
    automaton's tie-break is the earliest end position), and optionally the
    ``keep_latest`` latest ones in a second table;
  * probe (device, plain torch, over a leading slot axis): one bucket per
    gram size, an exact backward compare of every candidate against up to
    ``max_ngram + ext`` window tokens, and the (longest, earliest) match —
    the contract of ``fused_sam.suffix_match``.

A bucket holds ``bucket_cap`` positions, so on a repetitive corpus the true
longest match can be evicted and the probe returns a shorter (true) match;
greedy outputs stay exact (verification), only accept length can drop.

The hash is the reference's uint32 polynomial (multiplier 2654435761) over
the tokens oldest first.  torch has no general uint32 arithmetic on CUDA,
so the probe computes it in int64, reduced mod 2^32 after every step, with
the multiply split into 16-bit halves so no int64 product overflows; the
bucket is its low bits and equals numpy's bit for bit.  Over a window read
newest first (``win[k]`` is k tokens back), the hash of the n-gram ending at
the newest token is ``sum_{k<n} win[k] * MULT^k mod 2^32``: one prefix sum
gives every gram size at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

# the reference's rolling-hash multiplier (odd, so bijective mod 2^32)
_MULT = np.uint32(2654435761)
_MASK32 = 0xFFFFFFFF


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass(frozen=True)
class NgramIndex:
    """Device tables, one per gram size, stacked on a leading axis.

    ``table`` is ``[G, num_buckets, bucket_cap]`` int32 (-1 padded) for the
    gram sizes ``grams`` (descending); ``latest`` the optional
    ``[G, num_buckets, keep_latest]`` tables of latest positions, or None.
    ``sizes`` ([G] int64) and ``powers`` (``MULT^k mod 2^32`` for k below
    the largest gram, int64) live on the tables' device, so a probe copies
    nothing from the host."""

    grams: Tuple[int, ...]
    bucket_cap: int
    table: torch.Tensor
    latest: Optional[torch.Tensor]
    sizes: torch.Tensor
    powers: torch.Tensor

    @property
    def num_candidates(self) -> int:
        """The width of a probe's candidate row: every gram's bucket, and
        its latest positions where they are kept."""
        return self.table.shape[0] * self.table.shape[2] + (
            0 if self.latest is None
            else self.latest.shape[0] * self.latest.shape[2])

    @property
    def nbytes(self) -> int:
        n = self.table.numel() * self.table.element_size()
        if self.latest is not None:
            n += self.latest.numel() * self.latest.element_size()
        return n


def _hash_ngrams_np(tokens: np.ndarray, n: int) -> np.ndarray:
    """uint32 polynomial hash of the n-gram ending at each position
    i >= n - 1: ``[len(tokens) - n + 1]`` hashes."""
    N = len(tokens)
    h = np.zeros(N - n + 1, dtype=np.uint32)
    t = tokens.astype(np.uint32)
    for j in range(n):
        h = h * _MULT + t[j:N - n + 1 + j]
    return h


def _build_tables_np(tokens: np.ndarray, grams: Sequence[int],
                     bucket_cap: int, num_buckets: int, keep_latest: int):
    """The host tables: ``([G, nb, cap], [G, nb, keep_latest] or None)``."""
    N = len(tokens)
    nb = num_buckets
    table = np.full((len(grams), nb, bucket_cap), -1, np.int32)
    latest = np.full((len(grams), nb, keep_latest), -1, np.int32) \
        if keep_latest else None
    for g, n in enumerate(grams):
        if N < n:
            continue
        h = _hash_ngrams_np(tokens, n)
        buckets = (h & np.uint32(nb - 1)).astype(np.int64)
        pos = np.arange(n - 1, N, dtype=np.int64)
        # positions ascend, and a stable sort by bucket keeps them
        # earliest first within each bucket
        order = np.argsort(buckets, kind="stable")
        sb, sp = buckets[order], pos[order]
        starts = np.searchsorted(sb, np.arange(nb))
        rank = np.arange(len(sb)) - starts[sb]
        keep = rank < bucket_cap
        table[g, sb[keep], rank[keep]] = sp[keep].astype(np.int32)
        if keep_latest:
            counts = np.searchsorted(sb, np.arange(nb), side="right") \
                - starts
            from_end = counts[sb] - 1 - rank
            keep_l = from_end < keep_latest
            latest[g, sb[keep_l], from_end[keep_l]] = \
                sp[keep_l].astype(np.int32)
    return table, latest


def build_ngram_index(corpus: Sequence[int], *,
                      grams: Sequence[int] = (8, 4, 2, 1),
                      bucket_cap: int = 8, num_buckets: int = 0,
                      keep_latest: int = 0,
                      device: Union[str, torch.device] = "cuda"
                      ) -> NgramIndex:
    """Build the index on the host (vectorized numpy, about linear in the
    corpus) and move its tables to ``device``.

    ``num_buckets=0`` picks ``max(next_pow2(len(corpus)), 1024)``;
    ``keep_latest > 0`` also stores each bucket's latest positions."""
    tokens = np.ascontiguousarray(corpus, dtype=np.int32)
    nb = num_buckets or max(_next_pow2(len(tokens)), 1024)
    if nb & (nb - 1):
        raise ValueError("num_buckets must be a power of two")
    gs = tuple(sorted(set(int(g) for g in grams), reverse=True))
    table, latest = _build_tables_np(tokens, gs, bucket_cap, nb, keep_latest)
    return NgramIndex(
        grams=gs, bucket_cap=bucket_cap,
        table=torch.from_numpy(table).to(device),
        latest=None if latest is None else torch.from_numpy(latest).to(device),
        sizes=torch.tensor(gs, dtype=torch.int64, device=device),
        powers=hash_powers(gs[0], device))


def _mul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` and ``b`` in [0, 2^32), with no
    int64 product past 2^48: b is split into 16-bit halves."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def hash_powers(n: int, device: Union[str, torch.device]) -> torch.Tensor:
    """``MULT^k mod 2^32`` for k < n: int64 [n] on ``device``."""
    powers = [1]
    for _ in range(n - 1):
        powers.append(powers[-1] * int(_MULT) & _MASK32)
    return torch.tensor(powers, dtype=torch.int64, device=device)


def window_hashes(win: torch.Tensor, powers: torch.Tensor) -> torch.Tensor:
    """Hashes of the n-grams ending at the newest token of each
    newest-first window ``win`` [B, W], for n = 1 .. len(powers) <= W:
    int64 [B, n], column n - 1 equal to ``_hash_ngrams_np``'s for that
    gram."""
    toks = win[:, :powers.shape[0]].to(torch.int64) & _MASK32
    return torch.cumsum(_mul_mod32(toks, powers), dim=1) & _MASK32


def indexed_suffix_match(corpus: torch.Tensor, corpus_len: torch.Tensor,
                         index: NgramIndex, query: torch.Tensor,
                         tail: torch.Tensor, tail_len: torch.Tensor, *,
                         max_ngram: int, ext: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index-probed longest-suffix match, the contract of
    ``fused_sam.suffix_match`` over the corpus: returns (match_len,
    end_pos), int32 [B], end_pos the earliest stored end index of a longest
    match (0 when nothing matches), match capped at ``max_ngram + ext``.

    corpus [C] with a 0-dim ``corpus_len``; query [B, Q] (the trailing
    window, -1 left-padded, ``query[:, -1]`` the start token); tail [B,
    ext] (the tokens before the window, newest last, -1 padded) and
    tail_len [B].  Gram sizes may exceed ``max_ngram``: their hashes draw
    on the tail too.  A gram is probed only where the window holds n live
    tokens, so no -1 is ever hashed into a live probe."""
    W = max_ngram + ext
    L = corpus.shape[0]
    dev = corpus.device
    B = query.shape[0]
    tail_valid = torch.arange(ext, device=dev)[None, :] < tail_len[:, None]
    # newest first: win[:, 0] is the start token, win[:, k] k steps back
    win = torch.cat([torch.flip(query, (1,)),
                     torch.where(tail_valid, torch.flip(tail, (1,)), -1)],
                    dim=1).to(torch.int32)                        # [B, W]
    live = (win >= 0).sum(dim=1)                                  # [B]
    # a gram past the window has no candidates; one is probed only where
    # the window holds n live tokens
    hashes = window_hashes(win, index.powers[:W])          # [B, <= W]
    h = hashes[:, torch.clamp(index.sizes - 1, max=hashes.shape[1] - 1)]
    probed = (index.sizes[None, :] <= W) \
        & (live[:, None] >= index.sizes[None, :])                 # [B, G]
    g_idx = torch.arange(len(index.grams), device=dev)[None, :]
    cands = []
    for table in (index.table,) + (() if index.latest is None
                                   else (index.latest,)):
        bucket = h & (table.shape[1] - 1)
        c = table[g_idx, bucket]                                  # [B,G,cap]
        cands.append(torch.where(probed[:, :, None], c, -1))
    e = torch.cat(cands, dim=2).reshape(B, -1)                    # [B, C]
    # exact backward compare: corpus[e - j] against win[j]
    j = torch.arange(W, device=dev)
    pos = e[:, :, None] - j                                       # [B, C, W]
    toks = corpus[torch.clamp(pos, 0, L - 1).long()]
    ok = (toks == win[:, None, :]) & (pos >= 0) & (win[:, None, :] >= 0) \
        & (e[:, :, None] >= 0) & (e[:, :, None] < corpus_len)
    run = torch.cumprod(ok.to(torch.int32), dim=2).sum(dim=2)     # [B, C]
    best_len = run.amax(dim=1)
    # the earliest end position among the longest matches
    e_key = torch.where((run == best_len[:, None]) & (best_len[:, None] > 0),
                        e, 2 ** 30)
    end = torch.where(best_len > 0, e_key.amin(dim=1), 0)
    return best_len.to(torch.int32), end.to(torch.int32)
