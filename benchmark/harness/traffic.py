"""The one traffic generator: it reads a mix's JSON file and draws the
requests and the corpus of a run from the seed.

A mix file (``traffic/<name>.json``) holds:

    clients        closed-loop clients: each sends its next request when its
                   previous one finishes
    strata         sizes come in blocks of this many requests; a block holds
                   the same sizes (the distributions' quantiles at
                   (i + 0.5) / strata) in an order drawn once for the mix,
                   the same for every seed, so every seed serves the same
                   work; the seed draws the token ids
    prompt_len     a size distribution (below), or absent when prompts are
                   documents
    new_tokens     the distribution of each request's output budget
    corpus         {"kind": "random", "tokens": n}: n seeded random ids, or
                   {"kind": "served_documents", "continuation": c,
                    "separator": id}: each document with its most asked
                   question served once at set-up with c new tokens,
                   stored as that prompt + continuation + separator
    documents      {"count": n, "len": distribution, "pick": {"zipf": s}}:
                   prompts are whole documents; the document of Zipf rank
                   k (k = 1 most asked) has a length fixed for every seed
                   (the sizes alternate short and long down the ranks),
                   and each block of ``strata`` requests asks each rank
                   its Zipf share of the block (largest remainders), in the
                   mix's order
    questions      {"count": n, "len": distribution, "pick": {"zipf": s}},
                   with documents only: each document has n questions of
                   seeded ids (rank j's length the same for every
                   document and seed), appended to it; each block asks
                   each question rank its Zipf share, in an order of its
                   own

A size distribution is {"dist": "lognormal", "median", "sigma"},
{"dist": "loguniform"} or {"dist": "uniform"}, each clipped to
[min, max].  Token ids are uniform over the vocabulary.  Greedy requests
only; the end token is off, so each request decodes its whole budget.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional

import numpy as np

from .draws import stream_seed


@dataclass
class Request:
    ids: List[int]
    max_new: int
    doc: Optional[int] = None
    question: Optional[int] = None


def quantile(dist: Dict, p: float) -> int:
    """The distribution's p-quantile, rounded and clipped to [min, max]."""
    lo, hi = dist["min"], dist["max"]
    kind = dist["dist"]
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(p))
    elif kind == "loguniform":
        x = math.exp(math.log(lo) + p * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        x = lo + p * (hi - lo)
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    return int(min(hi, max(lo, round(x))))


def strata(dist: Dict, n: int) -> List[int]:
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


def alternate(n: int) -> List[int]:
    """0, n-1, 1, n-2, ...: the ranks' sizes alternate short and long."""
    return [i // 2 if i % 2 == 0 else n - 1 - i // 2 for i in range(n)]


def zipf_quota(n: int, k: int, s: float) -> List[int]:
    """k picks among n ranks, each rank r (0 most asked) as often as its
    share 1/(r+1)^s of a Zipf law gives, rounded by largest remainders."""
    w = 1.0 / np.arange(1, n + 1) ** s
    share = k * w / w.sum()
    quota = np.floor(share).astype(int)
    for r in np.argsort(-(share - quota), kind="stable")[:k - quota.sum()]:
        quota[r] += 1
    return [r for r in range(n) for _ in range(quota[r])]


class Traffic:
    """A run's traffic: ``mix`` (the parsed file), ``seed``, and the
    model's vocabulary size."""

    def __init__(self, mix: Dict, seed: int, vocab: int, name: str = ""):
        self.mix = mix
        self.vocab = vocab
        self.rng = np.random.default_rng(stream_seed(seed, "traffic", name))
        # the order of sizes: the mix's own, whatever the seed
        self.order_rng = np.random.default_rng(stream_seed(0, "order", name))
        self.clients = int(mix["clients"])
        self.K = int(mix.get("strata", 32))
        docs = mix.get("documents")
        self.documents: List[List[int]] = []
        self.questions: List[List[List[int]]] = []
        if docs is not None:
            lens = strata(docs["len"], docs["count"])
            self.documents = [self._ids(lens[i])
                              for i in alternate(len(lens))]
        qs = mix.get("questions")
        if qs is not None:
            qlens = strata(qs["len"], qs["count"])
            self.questions = [[self._ids(n) for n in qlens]
                              for _ in self.documents]

    def _ids(self, n: int) -> List[int]:
        return self.rng.integers(0, self.vocab, size=n).tolist()

    def prompt(self, d: int, j: Optional[int]) -> List[int]:
        """Document d, with its question j where the mix has questions."""
        return list(self.documents[d]) + (
            list(self.questions[d][j]) if self.questions else [])

    def prompt_lengths(self) -> List[int]:
        """Every prompt length the mix can send (for the warm-up)."""
        if self.documents:
            n_q = len(self.questions[0]) if self.questions else 1
            return sorted({len(self.prompt(d, j))
                           for d in range(len(self.documents))
                           for j in range(n_q)})
        return sorted(set(strata(self.mix["prompt_len"], self.K)))

    def stored_prompts(self) -> List[List[int]]:
        """The prompts served at set-up into the corpus: each document
        with its most asked question."""
        return [self.prompt(d, 0) for d in range(len(self.documents))]

    def corpus_kind(self) -> str:
        return self.mix["corpus"]["kind"]

    def random_corpus(self) -> List[int]:
        return self._ids(int(self.mix["corpus"]["tokens"]))

    def document_corpus(self, continuations: List[List[int]]) -> List[int]:
        """Stored prompt + its served continuation + separator, for each."""
        sep = int(self.mix["corpus"]["separator"])
        out: List[int] = []
        for prompt, cont in zip(self.stored_prompts(), continuations):
            out += prompt + cont + [sep]
        return out

    def requests(self) -> Iterator[Request]:
        """The run's requests, without end, in blocks of ``strata``."""
        news = strata(self.mix["new_tokens"], self.K)
        lens = None if self.documents else strata(self.mix["prompt_len"],
                                                  self.K)
        picks = asks = None
        if self.documents:
            picks = zipf_quota(len(self.documents), self.K, float(
                self.mix["documents"]["pick"]["zipf"]))
        if self.questions:
            asks = zipf_quota(len(self.questions[0]), self.K, float(
                self.mix["questions"]["pick"]["zipf"]))
        while True:
            new_order = self.order_rng.permutation(self.K)
            order = self.order_rng.permutation(self.K)
            ask_order = self.order_rng.permutation(self.K) if asks else None
            for j in range(self.K):
                budget = news[new_order[j]]
                if picks is None:
                    yield Request(self._ids(lens[order[j]]), budget)
                else:
                    d = picks[order[j]]
                    q = asks[ask_order[j]] if asks else None
                    yield Request(self.prompt(d, q), budget, d, q)
