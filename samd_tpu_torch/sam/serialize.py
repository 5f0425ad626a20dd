"""Flat-array serialization for suffix automata (counterpart of
``samd_tpu/sam/serialize.py``, same on-disk format: a file saved by either
package loads in the other).

A built automaton is frozen to a versioned ``.npz`` of flat arrays with
transitions in CSR form:

    link[num_states]        int32   suffix links (-1 for root)
    length[num_states]      int32   longest-string length per state
    first_end[num_states]   int32   end index of first occurrence
    occ[num_states]         int64   occurrence counts (zeros if untracked)
    trans_ptr[num_states+1] int64   CSR row pointers
    trans_tok[num_edges]    int32   edge tokens, sorted per row
    trans_dst[num_edges]    int32   edge target states
    text[len]               int32   indexed token stream

``save_sam`` takes the Python automaton or the native one
(``sam.native.NativeSuffixAutomaton``, which exports the same arrays);
``load_sam`` rebuilds the Python automaton, as the reference does.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Union

import numpy as np

from .automaton import SuffixAutomaton

FORMAT_VERSION = 1


def to_arrays(sam) -> dict:
    """The automaton's flat arrays (the native engine exports its own)."""
    if not isinstance(sam, SuffixAutomaton):
        return sam.to_arrays()
    n = sam.num_states
    counts = np.fromiter((len(t) for t in sam._trans), dtype=np.int64, count=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    num_edges = int(ptr[-1])
    tok = np.empty(num_edges, dtype=np.int32)
    dst = np.empty(num_edges, dtype=np.int32)
    for s, t in enumerate(sam._trans):
        if not t:
            continue
        items = sorted(t.items())
        base = ptr[s]
        for j, (a, b) in enumerate(items):
            tok[base + j] = a
            dst[base + j] = b
    return {
        "version": np.int64(FORMAT_VERSION),
        "flags": np.int64(int(sam.track_text) | (int(sam.track_counts) << 1)),
        "link": np.asarray(sam._link, dtype=np.int32),
        "length": np.asarray(sam._len, dtype=np.int32),
        "first_end": np.asarray(sam._first_end, dtype=np.int32),
        "occ": np.asarray(sam._occ, dtype=np.int64),
        "trans_ptr": ptr,
        "trans_tok": tok,
        "trans_dst": dst,
        "text": np.asarray(sam.text, dtype=np.int32),
    }


def from_arrays(arrays: dict) -> SuffixAutomaton:
    version = int(arrays["version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported SAM format version {version}")
    flags = int(arrays["flags"])
    sam = SuffixAutomaton(track_text=bool(flags & 1),
                          track_counts=bool(flags & 2))
    link = np.asarray(arrays["link"], dtype=np.int32)
    n = len(link)
    sam._link = link.tolist()
    sam._len = np.asarray(arrays["length"], dtype=np.int32).tolist()
    sam._first_end = np.asarray(arrays["first_end"], dtype=np.int32).tolist()
    sam._occ = np.asarray(arrays["occ"], dtype=np.int64).tolist()
    ptr = np.asarray(arrays["trans_ptr"], dtype=np.int64)
    tok = np.asarray(arrays["trans_tok"], dtype=np.int32)
    dst = np.asarray(arrays["trans_dst"], dtype=np.int32)
    sam._trans = [
        dict(zip(tok[ptr[s]:ptr[s + 1]].tolist(),
                 dst[ptr[s]:ptr[s + 1]].tolist()))
        for s in range(n)
    ]
    sam.text = np.asarray(arrays["text"], dtype=np.int32).tolist()
    # `last` is only needed to keep growing; pick the state for the full text.
    sam._last = _full_text_state(sam)
    sam.reset_cursor()
    return sam


def _full_text_state(sam: SuffixAutomaton) -> int:
    state = 0
    target = len(sam.text)
    for s in range(sam.num_states):
        if sam._len[s] == target and sam._first_end[s] == target - 1:
            state = s
            break
    return state


def save_sam(sam, path_or_file: Union[str, os.PathLike, BinaryIO]) -> None:
    np.savez_compressed(path_or_file, **to_arrays(sam))


def load_sam(path_or_file: Union[str, os.PathLike, BinaryIO], *,
             topk: int = 0) -> SuffixAutomaton:
    with np.load(path_or_file) as data:
        sam = from_arrays(dict(data.items()))
    if topk:
        sam.finalize_topk(topk)
    return sam
