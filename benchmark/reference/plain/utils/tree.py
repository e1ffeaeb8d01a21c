"""Nested tuples of tensors (the states and outputs of the step) as a flat
list of leaves, in the JAX tree-flatten order: fields in order, depth
first, a None contributing no leaves."""

from __future__ import annotations

from typing import Iterable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of `tree`, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in tree_leaves(sub)]


def tree_rebuild(like, leaves: Iterable[torch.Tensor]):
    """A tree of the structure of `like` with the given tensors, in
    tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return next(it)
        items = [build(sub) for sub in node]
        return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)

    return build(like)
