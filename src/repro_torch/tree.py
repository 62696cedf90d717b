"""Nested-dict parameter trees: the port's counterpart of JAX pytrees.

Parameters are plain nested dicts of tensors whose keys follow the
reference's ``init_params`` layout; stacked per-unit weights carry a
leading ``n_units`` dimension. ``flatten`` gives the reference
checkpoint's key scheme (``checkpoint/npz.py:_flatten``): keys joined by
``/`` in sorted order, e.g. ``units/attn/wq/w``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}, keys in sorted (JAX pytree) order."""
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def unit_slice(units, u: int):
    """Unit ``u`` of a stacked unit tree (views, no copy)."""
    return tree_map(lambda t: t[u], units)


def grad_leaves(params, layered=()) -> tuple:
    """Fresh leaf tensors for one backward pass, sharing storage with
    ``params``: every tensor outside a unit stack once, and every tensor
    of a unit stack (a subtree named ``units``: the model's, and an
    encoder-decoder's ``encoder/units``, each split by its own leading
    dimension) as one leaf per unit, or, under a subtree of the model's
    units named in ``layered`` (whose tensors stack the unit's layers a
    second time), one leaf per (unit, layer). Returns (split tree for
    ``forward``, list of (flat key, index or None, leaf)); the index is
    (unit,) or (unit, layer). Taking the gradient of such leaves avoids
    the full-size zero-padded gradient that slicing a stacked leaf would
    build once per slice in the backward."""
    slots = []

    def leaf(t, key, index=None):
        x = t.detach().requires_grad_(True)
        slots.append((key, index, x))
        return x

    def unit(units, prefix, u, layered):
        out = {}
        for sub in sorted(units):
            flat = flatten(units[sub], f"{prefix}{sub}/")
            if sub in layered:
                n_layers = next(iter(flat.values())).shape[1]
                out[sub] = [unflatten({k[len(f"{prefix}{sub}/"):]:
                                       leaf(t[u, i], k, (u, i))
                                       for k, t in flat.items()})
                            for i in range(n_layers)]
            else:
                out.update(unflatten({k[len(prefix):]: leaf(t[u], k, (u,))
                                      for k, t in flat.items()}))
        return out

    def split_tree(tree, prefix, layered):
        out: Dict[str, Any] = {}
        for key in sorted(tree):
            val, path = tree[key], prefix + key
            if key == "units":
                n = next(iter(flatten(val).values())).shape[0]
                out[key] = [unit(val, path + "/", u, layered)
                            for u in range(n)]
            elif isinstance(val, dict):
                out[key] = split_tree(val, path + "/", ())
            else:
                out[key] = leaf(val, path)
        return out

    return split_tree(params, "", layered), slots


def zeros_like_tree(tree, dtype: torch.dtype):
    """Zeros shaped like each leaf, in ``dtype``; a DTensor leaf gives a
    DTensor at its placements."""
    from repro_torch.sharding.hooks import is_dtensor

    def zeros(t):
        if is_dtensor(t):
            return torch.zeros_like(t, dtype=dtype)
        return torch.zeros(t.shape, dtype=dtype, device=t.device)
    return tree_map(zeros, tree)
