"""Host drafters (counterpart of ``samd_tpu/drafters``): the adaptive SAM
selector, the Token-Recycle tree drafter and the EAGLE drafters
(``drafters.eagle``)."""

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


def make_drafter(samd_cfg, vocab_size, *, static_sam=None, model_cfg=None,
                 params=None, eagle_net_params=None):
    """The drafter stack for a SamdConfig: an ``AdaptiveSelector`` over the
    request's own SAM, the optional static corpus SAM (a
    ``sam.SamCursor`` per request when several requests share one), and
    for ``sam_hybrid`` the tree drafter of ``tree_method``: Token Recycle,
    or the EAGLE-2 (``"eagle2"``) or EAGLE-1 (``"eagle"``) draft net, which
    needs the target's ``model_cfg`` and ``params`` (it shares their
    embedding and head) and takes ``eagle_net_params`` (from
    ``drafters.eagle.net.convert_eagle_state_dict``, or None for a random
    net)."""
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
            if model_cfg is None or params is None:
                raise ValueError(f"{samd_cfg.tree_method} needs model_cfg "
                                 "and params")
            if samd_cfg.tree_method == "eagle2":
                from .eagle.drafter import make_eagle2 as make
            else:
                from .eagle.eagle1 import make_eagle1 as make
            tree_drafter = make(model_cfg, params, samd_cfg,
                                net_params=eagle_net_params)
        else:
            raise NotImplementedError(
                f"tree_method {samd_cfg.tree_method!r} not yet wired")
    return AdaptiveSelector(samd_cfg, static_sam=static_sam,
                            tree_drafter=tree_drafter)
