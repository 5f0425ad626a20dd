"""ctypes bindings for the native (C++) suffix-automaton engine
(counterpart of ``samd_tpu/sam/native.py``).

``NativeSuffixAutomaton`` drafts exactly as the Python
:class:`samd_tpu_torch.sam.automaton.SuffixAutomaton` for everything the
drafters use (feed/peek/reset/sequence_draft/tree_draft/finalize_topk) and
exports the same CSR arrays (``sam.serialize``).  The library is built from
``samd_tpu_torch/csrc/sam_engine.cpp`` with g++ at first use, into
``samd_tpu_torch/csrc/build/`` under a name that carries a hash of the
source, the compiler and its flags, so an edited source is never served a
stale library.  This is host code, not a CUDA kernel.

Unlike the reference, a failed build raises (with g++'s output) instead of
falling back to the Python automaton: a caller that wants the Python engine
asks for it (``SamdConfig(use_native_sam=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "sam_engine.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

I32 = ctypes.POINTER(ctypes.c_int32)
I64 = ctypes.POINTER(ctypes.c_int64)


def _ptr(arr: np.ndarray, ty):
    return arr.ctypes.data_as(ty)


def library_path() -> Path:
    """Where the library for the current source, compiler and flags
    lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (CXX,) + CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsam_engine_{digest}.so"


def _compile(lib: Path) -> None:
    """Build ``lib`` with g++, into a temporary name first so that
    processes building at once never load a half-written file; raises
    RuntimeError with the compiler's output when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native SAM engine failed to build: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native SAM engine failed to build (rc {proc.returncode}):\n"
            f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native engine; raises RuntimeError
    when it cannot be built."""
    lib_path = library_path()
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.sam_create.restype = ctypes.c_void_p
    lib.sam_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sam_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("sam_num_states", "sam_text_len", "sam_num_edges"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.sam_feed.argtypes = [ctypes.c_void_p, I32, ctypes.c_int64,
                             ctypes.c_int]
    lib.sam_extend.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.sam_reset_cursor.argtypes = [ctypes.c_void_p]
    lib.sam_reset.argtypes = [ctypes.c_void_p]
    lib.sam_cursor.argtypes = [ctypes.c_void_p, I32, I32]
    lib.sam_peek.argtypes = [ctypes.c_void_p, ctypes.c_int32, I32, I32]
    lib.sam_match.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int32, I32, ctypes.c_int64, I32, I32]
    lib.sam_sequence_draft.restype = ctypes.c_int32
    lib.sam_sequence_draft.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, I32]
    lib.sam_finalize_topk.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.sam_tree_draft.restype = ctypes.c_int32
    lib.sam_tree_draft.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, I32, I32]
    lib.sam_export.argtypes = [ctypes.c_void_p, I32, I32, I32, I64, I64,
                               I32, I32, I32]
    lib.sam_import.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        I32, I32, I32, I64, I64, I32, I32, I32]
    return lib


def native_available() -> bool:
    """Whether the native engine builds and loads here.  Unlike the
    reference's, nothing falls back on a False: a caller that wants the
    Python engine asks for it."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


class NativeSuffixAutomaton:
    """C++-backed automaton with the SuffixAutomaton drafting interface."""

    def __init__(self, *, track_text: bool = True,
                 track_counts: bool = False):
        lib = load_library()
        self._lib = lib
        self.track_text = track_text
        self.track_counts = track_counts
        self._h = ctypes.c_void_p(lib.sam_create(int(track_text),
                                                 int(track_counts)))
        self._topk_k = 0

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sam_destroy(h)
            self._h = None

    # -- introspection -------------------------------------------------
    @property
    def num_states(self) -> int:
        return self._lib.sam_num_states(self._h)

    def __len__(self) -> int:
        return self._lib.sam_text_len(self._h)

    def _cursor(self) -> Tuple[int, int]:
        s, l = ctypes.c_int32(), ctypes.c_int32()
        self._lib.sam_cursor(self._h, ctypes.byref(s), ctypes.byref(l))
        return s.value, l.value

    @property
    def cur_state(self) -> int:
        return self._cursor()[0]

    @property
    def cur_length(self) -> int:
        return self._cursor()[1]

    # -- construction / matching ---------------------------------------
    def feed(self, tokens: Sequence[int], *, grow: bool) -> None:
        arr = np.ascontiguousarray(tokens, dtype=np.int32)
        self._lib.sam_feed(self._h, _ptr(arr, I32), len(arr), int(grow))

    def extend(self, token: int) -> None:
        """Index one token; the cursor stays where it is, as in the Python
        engine's ``extend``."""
        self._lib.sam_extend(self._h, int(token))

    def advance_cursor(self, token: int) -> None:
        arr = np.asarray([token], dtype=np.int32)
        self._lib.sam_feed(self._h, _ptr(arr, I32), 1, 0)

    def peek(self, token: int) -> Tuple[int, int]:
        s, l = ctypes.c_int32(), ctypes.c_int32()
        self._lib.sam_peek(self._h, token, ctypes.byref(s), ctypes.byref(l))
        return s.value, l.value

    def match_step(self, state: int, length: int,
                   token: int) -> Tuple[int, int]:
        """Stateless walk (``SamCursor`` support)."""
        arr = np.asarray([token], dtype=np.int32)
        s, l = ctypes.c_int32(), ctypes.c_int32()
        self._lib.sam_match(self._h, state, length, _ptr(arr, I32), 1,
                            ctypes.byref(s), ctypes.byref(l))
        return s.value, l.value

    def reset_cursor(self) -> None:
        self._lib.sam_reset_cursor(self._h)

    def reset(self) -> None:
        self._lib.sam_reset(self._h)
        self._topk_k = 0

    def index_corpus(self, sequences: Sequence[Sequence[int]],
                     eos_token: int) -> None:
        for seq in sequences:
            self.feed(seq, grow=True)
            if len(seq) == 0 or seq[-1] != eos_token:
                self.feed([eos_token], grow=True)

    # -- drafting ------------------------------------------------------
    def sequence_draft(self, state: int, start_token: int, n_predicts: int,
                       *, widen: bool = False, pad: bool = False) -> List[int]:
        out = np.empty(max(n_predicts, 1), dtype=np.int32)
        n = self._lib.sam_sequence_draft(
            self._h, state, start_token, n_predicts, int(widen), int(pad),
            _ptr(out, I32))
        return out[:n].tolist()

    def finalize_topk(self, k: int = 8) -> None:
        self._lib.sam_finalize_topk(self._h, k)
        self._topk_k = k

    @property
    def _topk(self):
        # truthy once finalized, as the Python engine's table is
        return self._topk_k or None

    def tree_draft(self, state: int, start_token: int, n_nodes: int,
                   k: int) -> Tuple[List[int], List[int]]:
        out_t = np.empty(max(n_nodes, 1), dtype=np.int32)
        out_p = np.empty(max(n_nodes, 1), dtype=np.int32)
        n = self._lib.sam_tree_draft(self._h, state, start_token, n_nodes, k,
                                     _ptr(out_t, I32), _ptr(out_p, I32))
        return out_t[:n].tolist(), out_p[:n].tolist()

    # -- serialization (the CSR arrays of sam/serialize.py) --------------
    def to_arrays(self) -> dict:
        n = self.num_states
        e = self._lib.sam_num_edges(self._h)
        t = len(self)
        link = np.empty(n, np.int32)
        length = np.empty(n, np.int32)
        first_end = np.empty(n, np.int32)
        occ = np.empty(n, np.int64)
        ptr = np.empty(n + 1, np.int64)
        tok = np.empty(e, np.int32)
        dst = np.empty(e, np.int32)
        text = np.empty(t, np.int32)
        self._lib.sam_export(self._h, _ptr(link, I32), _ptr(length, I32),
                             _ptr(first_end, I32), _ptr(occ, I64),
                             _ptr(ptr, I64), _ptr(tok, I32), _ptr(dst, I32),
                             _ptr(text, I32))
        return {
            "version": np.int64(1),
            "flags": np.int64(int(self.track_text)
                              | (int(self.track_counts) << 1)),
            "link": link, "length": length, "first_end": first_end,
            "occ": occ, "trans_ptr": ptr, "trans_tok": tok, "trans_dst": dst,
            "text": text,
        }

    @classmethod
    def from_arrays(cls, arrays: dict) -> "NativeSuffixAutomaton":
        flags = int(arrays["flags"])
        sam = cls(track_text=bool(flags & 1), track_counts=bool(flags & 2))
        link = np.ascontiguousarray(arrays["link"], np.int32)
        length = np.ascontiguousarray(arrays["length"], np.int32)
        first_end = np.ascontiguousarray(arrays["first_end"], np.int32)
        occ = np.ascontiguousarray(arrays["occ"], np.int64)
        ptr = np.ascontiguousarray(arrays["trans_ptr"], np.int64)
        tok = np.ascontiguousarray(arrays["trans_tok"], np.int32)
        dst = np.ascontiguousarray(arrays["trans_dst"], np.int32)
        text = np.ascontiguousarray(arrays["text"], np.int32)
        sam._lib.sam_import(
            sam._h, len(link), len(tok), len(text), _ptr(link, I32),
            _ptr(length, I32), _ptr(first_end, I32), _ptr(occ, I64),
            _ptr(ptr, I64), _ptr(tok, I32), _ptr(dst, I32), _ptr(text, I32))
        return sam


def build_native_corpus_sam(sequences: Sequence[Sequence[int]],
                            eos_token: int, *,
                            topk: int = 8) -> NativeSuffixAutomaton:
    """``automaton.build_corpus_sam`` on the native engine."""
    sam = NativeSuffixAutomaton(track_text=True, track_counts=True)
    sam.index_corpus(sequences, eos_token)
    sam.finalize_topk(topk)
    sam.reset_cursor()
    return sam
