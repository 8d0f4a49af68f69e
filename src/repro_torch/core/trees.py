"""Leaf walks and reductions over parameter and state trees — nested
dicts and NamedTuples of tensors.

The counterpart of the JAX package's pytree utilities for the port's plain
trees.  Leaves are visited in sorted-key order at every dict level and in
field order in a NamedTuple, the order ``jax.tree.leaves`` uses, so both
packages sum the same terms in the same order.
"""
from __future__ import annotations

from typing import Callable, List

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a tree of dicts and NamedTuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_namedtuple(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure, visiting
    leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_sq_norm(tree) -> torch.Tensor:
    """Σ_leaves ‖x‖² (a 0-d tensor)."""
    return sum((x * x).sum() for x in tree_leaves(tree))


def tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(tree))


def tree_sq_dist(a, b, lead: int = 0) -> torch.Tensor:
    """Σ_leaves ‖x − y‖², summed over every axis after the first ``lead``
    ones: ``lead=0`` gives a scalar, ``lead=1`` one value per row of a
    per-client stack (``b`` broadcasts against ``a``)."""
    return sum(((x - y) ** 2).flatten(lead).sum(-1) if lead
               else ((x - y) ** 2).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
