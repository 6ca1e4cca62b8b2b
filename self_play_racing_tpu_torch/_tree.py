"""A minimal ``tree_map`` over the port's state containers (dataclasses, dicts,
lists and tuples of tensors), standing in for ``jax.tree.map``."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise to tensors at the same place in ``tree`` and ``rest``.
    Leaves that are not tensors are taken from ``tree`` unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def where_rows(mask, new, old):
    """Per-row select over two trees of ``[N, ...]`` tensors: ``new`` where
    ``mask`` ([N] bool) is set, else ``old``."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)
    return tree_map(pick, new, old)
