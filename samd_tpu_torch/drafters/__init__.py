"""Host drafters (counterpart of ``samd_tpu/drafters``): the adaptive SAM
selector and the Token-Recycle tree drafter.  The EAGLE drafters are
ROADMAP queue 1 item 13."""

from .base import Draft, Drafter
from .sam_drafter import AdaptiveSelector
from .token_recycle import TokenRecycleDrafter
from .tree_topology import (
    child_ranks,
    load_topology,
    rank_probability_tree,
    save_topology,
)

__all__ = [
    "Draft", "Drafter", "AdaptiveSelector", "TokenRecycleDrafter",
    "rank_probability_tree", "child_ranks", "save_topology", "load_topology",
    "make_drafter",
]


def make_drafter(samd_cfg, vocab_size, *, static_sam=None):
    """The drafter stack for a SamdConfig: an ``AdaptiveSelector`` over the
    request's own SAM, the optional static corpus SAM (a
    ``sam.SamCursor`` per request when several requests share one), and
    for ``sam_hybrid`` the Token-Recycle tree drafter."""
    tree_drafter = None
    if samd_cfg.draft_source == "sam_hybrid":
        if samd_cfg.tree_method == "token_recycle":
            parents = None
            if samd_cfg.tree_adjacency is not None:
                from ..sam.trees import adjacency_to_parents
                parents = adjacency_to_parents(samd_cfg.tree_adjacency)
            tree_drafter = TokenRecycleDrafter(
                vocab_size, parents=parents,
                max_nodes=samd_cfg.max_predicts,
                topk=samd_cfg.tree_topk)
        elif samd_cfg.tree_method in ("eagle", "eagle2"):
            raise NotImplementedError(
                f"tree_method {samd_cfg.tree_method!r} (the EAGLE draft "
                "nets) is not ported yet (ROADMAP queue 1 item 13)")
        else:
            raise NotImplementedError(
                f"tree_method {samd_cfg.tree_method!r} not yet wired")
    return AdaptiveSelector(samd_cfg, static_sam=static_sam,
                            tree_drafter=tree_drafter)
