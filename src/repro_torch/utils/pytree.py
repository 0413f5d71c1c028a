"""Size helpers over nested containers of tensors: the counterpart of
``repro/utils/pytree.py``.

A tree is a tensor, an ``nn.Module`` (its parameters), or a dict, list or
tuple of trees (a NamedTuple such as ``AdamState`` included); anything else
is a leaf of one element and no bytes, as ``repro`` counts a leaf without a
shape. Meta and fake tensors count by their shapes and dtypes: nothing is
read.
"""
from __future__ import annotations

from typing import Iterator

import torch
from torch import nn


def tree_leaves(tree) -> Iterator:
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_num_params(tree) -> int:
    """Total number of tensor elements in a tree."""
    return int(sum(t.numel() if isinstance(t, torch.Tensor) else 1 for t in tree_leaves(tree)))


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensors of a tree."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))
