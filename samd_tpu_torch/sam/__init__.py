"""Suffix automata and draft-tree buffers (counterpart of
``samd_tpu/sam``): host code the port keeps its own copy of."""

from .automaton import SamCursor, SuffixAutomaton, build_corpus_sam
from .serialize import from_arrays, load_sam, save_sam, to_arrays
from .trees import (
    TreeBuffers,
    adjacency_to_parents,
    ancestor_closure,
    build_tree_buffers,
    chain_buffers,
    leaf_paths,
    node_depths,
    parents_to_adjacency,
)

__all__ = [
    "SuffixAutomaton",
    "SamCursor",
    "build_corpus_sam",
    "load_sam",
    "save_sam",
    "to_arrays",
    "from_arrays",
    "TreeBuffers",
    "adjacency_to_parents",
    "ancestor_closure",
    "build_tree_buffers",
    "chain_buffers",
    "leaf_paths",
    "node_depths",
    "parents_to_adjacency",
]
