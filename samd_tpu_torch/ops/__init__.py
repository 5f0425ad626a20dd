"""Kernels of the port and their plain versions."""

from .treeops import (
    depths_from_parents,
    pack_draft_host,
    paths_from_parents,
    tree_mask_from_parents,
    unpack_draft,
)

__all__ = [
    "tree_mask_from_parents", "depths_from_parents", "paths_from_parents",
    "unpack_draft", "pack_draft_host",
]
