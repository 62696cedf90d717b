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


def grad_leaves(params) -> tuple:
    """Fresh leaf tensors for one backward pass, sharing storage with
    ``params``: every non-unit tensor once, and every stacked unit tensor
    as one leaf per unit. Returns (split tree for ``forward``, list of
    (flat key, unit index or None, leaf)). Taking the gradient of per-unit
    leaves avoids the full-size zero-padded gradient that slicing a
    stacked leaf would build once per unit in the backward."""
    slots = []

    def leaf(t, key, u=None):
        x = t.detach().requires_grad_(True)
        slots.append((key, u, x))
        return x

    split: Dict[str, Any] = {}
    for top in sorted(params):
        if top == "units":
            flat = flatten(params["units"], "units/")
            n = next(iter(flat.values())).shape[0]
            split["units"] = [
                unflatten({k[len("units/"):]: leaf(t[u], k, u)
                           for k, t in flat.items()})
                for u in range(n)]
        else:
            sub = flatten({top: params[top]})
            split.update(unflatten({k: leaf(t, k) for k, t in sub.items()}))
    return split, slots


def zeros_like_tree(tree, dtype: torch.dtype):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=dtype,
                                          device=t.device), tree)
