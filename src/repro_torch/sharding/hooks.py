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


def contiguous_local(x):
    """``x`` with its local block contiguous and its global strides a
    contiguous tensor's (the identity on a plain tensor). DTensor gives
    an op's output the global strides of its own rules, which need not
    be the layout of the local block the op produced (an einsum's
    expert-major output over a token-major block); a later reshape that
    the global strides allow as a view then asks the local block for a
    view it cannot give. No data moves between ranks."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    stride = torch.empty(x.shape, device="meta").stride()
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False,
                              shape=x.shape, stride=stride)


def as_dtensor(t, mesh):
    """A plain tensor beside DTensors as a DTensor replicated on
    ``mesh`` (it is whole on every rank); a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sharding(mesh, batch: int, heads) -> tuple:
    """(mesh dims that shard the batch, mesh dim that shards the heads or
    None): the batch axes when their product divides ``batch``, 'model'
    when its size divides every count in ``heads`` (None: no head
    split)."""
    from .rules import make_rules, mesh_sizes
    ctx = current_rules()
    rules = ctx["rules"] if ctx and ctx.get("rules") is not None \
        else make_rules(mesh)
    names, sizes = list(mesh.mesh_dim_names), mesh_sizes(mesh)
    prod = 1
    for a in rules.batch:
        prod *= sizes[a]
    b_dims = [names.index(a) for a in rules.batch] if batch % prod == 0 \
        else []
    tp = rules.tp
    h_dim = names.index(tp) if heads is not None and tp in names and all(
        h % sizes[tp] == 0 for h in heads) else None
    return b_dims, h_dim


def _placements(mesh, b_dims, h_dim, batch_at, head_at, grad=False
                ) -> list:
    """Placements of one operand: ``Shard(batch_at)`` on the batch mesh
    dims, ``Shard(head_at)`` on the head mesh dim, ``Replicate()``
    elsewhere. An operand without the dim (its position None) is whole
    on those ranks; with ``grad`` its gradient there is each rank's
    partial sum (``Partial()``): the SSD's A summed over the local batch,
    its B and C over the local heads, the sLSTM's r and bias over the
    local batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for i in b_dims:
        out[i] = Shard(batch_at) if batch_at is not None else (
            Partial() if grad else Replicate())
    if h_dim is not None:
        out[h_dim] = Shard(head_at) if head_at is not None else (
            Partial() if grad else Replicate())
    return out


def on_local_blocks(fn, args, roles, out_roles, batch: int, heads):
    """``fn`` on each rank's local blocks of ``args`` through
    ``local_map`` (the kernel wrappers, and the model code that DTensor
    cannot propagate: zamba2's conv, the mLSTM and sLSTM scans).
    ``roles``: each operand's (batch dim, head dim), None for a dim it
    lacks; ``out_roles`` the same for each output; ``heads`` the head
    counts that 'model' must divide to split them, or None to keep every
    rank's block whole along the head dims (and along every dim but the
    batch)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    b_dims, h_dim = _sharding(mesh, batch, heads)
    ins = tuple(_placements(mesh, b_dims, h_dim, *r) for r in roles)
    grads = tuple(_placements(mesh, b_dims, h_dim, *r, grad=True)
                  for r in roles)
    outs = tuple(_placements(mesh, b_dims, h_dim, *r) for r in out_roles)
    # one output's placements are a list; several outputs', a tuple
    mapped = local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                       in_placements=ins, in_grad_placements=grads,
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(*(as_dtensor(a, mesh) if isinstance(a, torch.Tensor)
                    else a for a in args))


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
