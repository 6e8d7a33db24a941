"""Minimal pytree helpers for the port's NamedTuples of tensors."""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over NamedTuples / tuples / lists of tensors
    (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def bwhere(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-lane select: ``mask`` (B,) broadcast over the trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def tree_where(mask: torch.Tensor, new, old):
    """Per-lane select over whole pytrees."""
    return tree_map(lambda a, b: bwhere(mask, a, b), new, old)
