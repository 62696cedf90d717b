"""Activation sharding hook (the reference's ``sharding/hooks.py``).

Model code calls ``constrain(x, "act_ffn")`` at the choke points. Outside
a rules context, or on a plain tensor, it is the identity, so a run on
one device keeps its bits. Inside (``launch.train --distributed``, the
dry-run, ``ScheduleExecutor(rules=)``), a DTensor is redistributed to
the sanitized placements of the name's spec on the context's mesh.

The context also enters DTensor's implicit replication: the tensors the
model builds itself (positions, RoPE tables, masks, the aux-loss zero)
are plain, and take part in DTensor ops as replicated.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Dict, Optional

import torch

from .rules import sanitized_placements

_CURRENT: Optional[Dict[str, object]] = None  # {"table", "mesh", "rules"}


def current_rules() -> Optional[Dict[str, object]]:
    return _CURRENT


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor: a DTensor exists only once ``torch.distributed.tensor`` is
    loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def activation_rules(table: Dict[str, tuple], mesh=None, rules=None):
    """Install a logical-name -> spec table for the duration of a run.
    ``mesh`` (default ``rules.mesh``) is the mesh the specs name;
    ``rules`` (a ``ShardingRules``) additionally enables
    ``constrain_params_tree``."""
    global _CURRENT
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _CURRENT
    if mesh is None and rules is not None:
        mesh = rules.mesh
    _CURRENT = {"table": dict(table), "mesh": mesh, "rules": rules}
    try:
        with implicit_replication():
            yield
    finally:
        _CURRENT = prev


def placements_for(x, name: str) -> Optional[tuple]:
    """The sanitized placements of ``name``'s spec for a tensor of
    ``x``'s shape on the context's mesh (else ``x``'s own), or None when
    no rules are installed or the name has no entry."""
    if _CURRENT is None:
        return None
    spec = _CURRENT["table"].get(name)
    if spec is None:
        return None
    mesh = _CURRENT["mesh"] or x.device_mesh
    return sanitized_placements(mesh, x.shape, spec)


def constrain(x, name: str):
    """Redistribute a DTensor to the placements registered under
    ``name`` (identity on a plain tensor, outside a rules context, or
    when the name has no entry). As JAX's sharding constraint, it holds
    the gradient to the same placements in the backward (DTensor's own
    ``redistribute`` would move it back to the input's)."""
    if _CURRENT is None or not is_dtensor(x):
        return x
    want = placements_for(x, name)
    if want is None:
        return x
    if x.requires_grad:
        return _Constrain.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _redistribute_to(x, want):
    return x if tuple(x.placements) == tuple(want) else \
        x.redistribute(x.device_mesh, want)


class _Constrain(torch.autograd.Function):
    """Forward and backward both to ``want``."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return _redistribute_to(x, want)

    @staticmethod
    def backward(ctx, g):
        return _redistribute_to(g, ctx.want), None


def constrain_params_tree(tree):
    """Redistribute a parameter-shaped tree of DTensors (e.g. gradients)
    to the parameters' sanitized placements. No-op outside a rules
    context with ``rules``."""
    if _CURRENT is None or _CURRENT.get("rules") is None:
        return tree
    from repro_torch.tree import flatten, unflatten
    rules = _CURRENT["rules"]
    mesh = _CURRENT["mesh"] or rules.mesh

    def one(path, leaf):
        if not is_dtensor(leaf):
            return leaf
        want = sanitized_placements(mesh, leaf.shape,
                                    rules.param_spec(path, leaf.ndim))
        return leaf.redistribute(mesh, want)

    return unflatten({p: one(p, t) for p, t in flatten(tree).items()})


def split_last(x, *shape):
    """``x`` with its last dim split into ``shape`` (heads, head_dim).
    A DTensor sharded on that dim over a mesh dim whose size does not
    divide ``shape[0]`` (36 heads over 16-way 'model') is gathered along
    it first: DTensor cannot split an unevenly sharded dim, and the
    sanitized ``act_heads`` keeps such heads whole anyway."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        mesh = x.device_mesh
        want = [Replicate() if p.is_shard(last) and shape[0] % mesh.size(i)
                else p for i, p in enumerate(x.placements)]
        if want != list(x.placements):
            x = x.redistribute(mesh, want)
    return x.reshape(*x.shape[:-1], *shape)


def unshard(x, dim: int):
    """A DTensor gathered along tensor dim ``dim`` (the identity on a
    plain tensor, or when ``dim`` is not sharded)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def as_dtensor(t, mesh):
    """A plain tensor beside DTensors as a DTensor replicated on
    ``mesh`` (it is whole on every rank); a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def merge_last(x, n: int):
    """``x`` with its last ``n`` dims merged into one (heads x head_dim
    back into the model width). A DTensor's gradient is held to the
    merged tensor's placements: arriving sharded on the merged dim, it
    could not be split back into unevenly sharded heads (36 over
    16-way 'model')."""
    y = x.reshape(*x.shape[:x.ndim - n], -1)
    if is_dtensor(y) and y.requires_grad:
        y = _Constrain.apply(y, tuple(y.placements))
    return y
