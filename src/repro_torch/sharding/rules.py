"""Parameter and activation sharding specs (the reference's
``sharding/rules.py``), and their DTensor placements.

Meshes: one pod ``('data'=16, 'model'=16)``; two pods
``('pod'=2, 'data'=16, 'model'=16)``, where 'pod' extends data
parallelism (parameters replicated across pods; the gradient reduction
crosses pods once per step).

Parameters are 2-D sharded: the tensor-parallel dimension over 'model',
the FSDP dimension over 'data'. Rules are matched on the parameter's
flat path (``tree.flatten``'s '/'-joined keys, the reference's
``_path_str``); stacked per-unit parameters (under ``units/``) get a
leading ``None`` for the unit dimension, and the inner per-unit stacks
(``/mamba/``, ``/mlstm/``) a second.

A spec is a tuple ``P`` with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (one dim over
several mesh axes, major to minor). ``placements`` turns it into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple


class P(tuple):
    """A partition spec: ``P('data', None, ('pod', 'data'))``, the
    reference's ``jax.sharding.PartitionSpec`` as a tuple. As there, a
    one-name tuple is stored as the name."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh_axis_names(mesh))


@dataclass(frozen=True)
class ShardingRules:
    """Bundle of (mesh, fsdp axis, tp axis, activation table)."""

    mesh: Any
    fsdp: str = "data"
    tp: str = "model"
    # long-decode mode: KV cache sequence-sharded instead of batch-sharded
    seq_shard_cache: bool = False

    @property
    def batch(self) -> Tuple[str, ...]:
        return batch_axes(self.mesh)

    def activation_table(self) -> Dict[str, P]:
        b, tp = self.batch, self.tp
        table = {
            # residual stream (B, S, D)
            "act_btd": P(b, None, None),
            # ffn hidden (B, S, F): TP over F
            "act_ffn": P(b, None, tp),
            # attention heads (B, S, H, hd): TP over query heads
            "act_heads": P(b, None, tp, None),
            # mamba / xlstm inner (B, S, d_inner): TP over channels
            "act_inner": P(b, None, tp),
            # logits (B, S, V): TP over vocab
            "logits": P(b, None, tp),
            # MoE dispatched tokens (G, E, cap, D): token groups on the
            # batch axes, experts over 'model' (EP)
            "moe_dispatch": P(b, tp, None, None),
            # per-token router probs (B, S, E)
            "router": P(b, None, None),
        }
        if self.seq_shard_cache:
            # 0.5M-token decode, batch 1: cache (B, S, Hkv, hd) sharded on S
            table["kv_cache"] = P(None, ("data", tp) if "data" in
                                  mesh_axis_names(self.mesh) else (tp,),
                                  None, None)
            table["ssm_state"] = P(None, tp, None, None)
        else:
            # cache (B, S, Hkv, hd): batch over data, KV heads over TP
            table["kv_cache"] = P(b, None, self.tp, None)
            # ssm state (B, H, dh, N): batch-sharded, heads TP
            table["ssm_state"] = P(b, tp, None, None)
        return table

    def param_spec(self, path: str, ndim: int) -> P:
        prefix = 0
        if "units/" in path or path.startswith("units"):
            prefix += 1                  # stacked over units
        if "/mamba/" in path or "/mlstm/" in path:
            prefix += 1                  # inner per-unit layer stack
        base = max(ndim - prefix, 0)
        spec = _match_param(path, base, self.fsdp, self.tp)
        if prefix:
            spec = P(*([None] * prefix), *spec)
            spec = P(*(list(spec)[:ndim] + [None] * (ndim - len(spec))))
        return spec


def sanitize_spec(mesh, shape, spec: P) -> P:
    """Drop mesh axes whose size does not divide the dimension: an odd
    dim falls back to replicated on that dim."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(shape):
            out.append(None)
            continue
        tup = axes if isinstance(axes, tuple) else (axes,)
        prod = 1
        for a in tup:
            prod *= sizes[a]
        out.append(axes if shape[i] % prod == 0 else None)
    return P(*out)


def _match_param(path: str, ndim: int, fsdp: str, tp: str) -> P:
    """Map one parameter path to its (non-stacked) spec."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("b",) or ndim == 0:
        return P(*([None] * ndim))
    if "norm" in path or leaf == "scale":
        return P(*([None] * ndim))
    if "embed" in path and leaf == "table":            # (V, D)
        return P(tp, fsdp)
    if "router" in path:                               # (D, E)
        return P(fsdp, None)
    if "experts" in path:
        # (E, D, F) gate/up; (E, F, D) down: experts over TP (EP)
        if ndim == 3:
            return P(tp, fsdp, None)
        return P(tp, None)
    if leaf in ("A_log", "D", "dt_bias"):              # (H,) ssm scalars
        return P(tp) if ndim == 1 else P(*([None] * ndim))
    if "conv" in path:                                 # (k, channels)
        return P(None, tp) if ndim == 2 else P(*([None] * ndim))
    # projections: the direction decides which dim is TP
    in_proj = any(k in path for k in
                  ("wq", "wk", "wv", "gate", "up", "in_proj", "w_qkv",
                   "q_proj", "k_proj", "v_proj"))
    out_proj = any(k in path for k in ("wo", "down", "out_proj", "o_proj"))
    if ndim == 2:
        if out_proj:
            return P(tp, fsdp)
        if in_proj:
            return P(fsdp, tp)
        return P(fsdp, tp)   # default: last dim TP
    if ndim == 1:
        # a projection's bias stays replicated
        return P(None)
    return P(*([None] * ndim))


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` on the tensor dim whose entry names it, else
    ``Replicate()``. One tensor dim over several mesh axes (('pod',
    'data') for the batch, ('data', 'model') for the long-decode KV
    cache) becomes a ``Shard(i)`` on each of those mesh dims; with the
    mesh dims in mesh order (major first) the block index along that dim
    is ``i_major * size_minor + i_minor``, JAX's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in axes if isinstance(axes, tuple) else (axes,):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def sanitized_placements(mesh, shape, spec: Sequence) -> tuple:
    return placements(mesh, sanitize_spec(mesh, tuple(shape), spec))


def param_specs(rules: ShardingRules, params) -> Dict:
    """Spec tree mirroring ``params`` (a tree of tensors, ``meta`` ones
    included)."""
    from repro_torch.tree import flatten, unflatten
    return unflatten({path: rules.param_spec(path, t.ndim)
                      for path, t in flatten(params).items()})


def param_placements(rules: ShardingRules, params) -> Dict:
    """Sanitized placements tree for ``params`` on ``rules.mesh`` (the
    reference's ``param_sharding``)."""
    from repro_torch.tree import flatten, unflatten
    return unflatten({
        path: sanitized_placements(rules.mesh, t.shape,
                                   rules.param_spec(path, t.ndim))
        for path, t in flatten(params).items()})


def make_rules(mesh, *, seq_shard_cache: bool = False) -> ShardingRules:
    return ShardingRules(mesh=mesh, seq_shard_cache=seq_shard_cache)


def distribute_tree(mesh, tree, placements_tree):
    """DTensors of ``tree``'s tensors at ``placements_tree``'s placements
    on ``mesh``. Every rank holds the whole tensor (the same seed gives
    the same values) and keeps its own block of it, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import flatten, unflatten
    pl = flatten(placements_tree)
    return unflatten({
        path: distribute_tensor(t, mesh, pl[path], src_data_rank=None)
        for path, t in flatten(tree).items()})


def full_tree(tree):
    """Plain tensors of a tree of DTensors (each gathered whole); a plain
    leaf is kept."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
