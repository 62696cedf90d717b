"""Sharding specs of every dry-run input (the reference's
``launch/specs.py``): parameters, optimizer state, the data batch and the
decode cache, as specs and as sanitized DTensor placements. The training
driver, the executor and the tests reuse them; nothing here starts a
process group.

Parameter, moment and cache trees are ``meta`` tensors (no memory); paths
are ``tree.flatten``'s keys, the reference's ``_path_str``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.rules import (P, ShardingRules, param_placements,
                                        param_specs, sanitize_spec,
                                        sanitized_placements)
from repro_torch.train.optimizer import OptState, adamw_init
from repro_torch.tree import flatten, unflatten

__all__ = ["BF16_MOMENTS_ABOVE", "TRAIN_ACCUM_STEPS", "batch_shardings",
           "batch_spec", "cache_shardings", "cache_spec", "opt_shape",
           "opt_shardings", "param_shardings", "param_specs",
           "params_shape", "sanitize_spec"]

# archs whose optimizer moments are kept in bf16 (more than 50 GB of
# parameters in bf16)
BF16_MOMENTS_ABOVE = 50e9

# gradient-accumulation sub-steps of the train_4k dry-run
TRAIN_ACCUM_STEPS: Dict[str, int] = {
    "llama3-405b": 16,
    "llama4-maverick-400b-a17b": 8,
    "zamba2-7b": 2,
    "glm4-9b": 2,
    "stablelm-12b": 2,
}


def params_shape(cfg: ArchConfig) -> Any:
    """The parameter tree as ``meta`` tensors (no allocation)."""
    from repro_torch.models import init_params
    return init_params(cfg, 0, device="meta")


def moment_dtype(p_shape) -> torch.dtype:
    n_params = sum(t.numel() for t in flatten(p_shape).values())
    return torch.bfloat16 if n_params * 2 > BF16_MOMENTS_ABOVE \
        else torch.float32


def opt_shape(cfg: ArchConfig, p_shape) -> OptState:
    """AdamW state of ``p_shape`` on ``meta``: moments in bf16 above
    ``BF16_MOMENTS_ABOVE`` bytes of bf16 parameters, else f32."""
    return adamw_init(p_shape, moment_dtype=moment_dtype(p_shape))


def batch_spec(rules: ShardingRules, name: str, ndim: int) -> P:
    b = rules.batch
    if ndim == 0:
        return P()
    return P(b, *([None] * (ndim - 1)))


def cache_spec(rules: ShardingRules, path: str, ndim: int,
               *, seq_shard: bool) -> P:
    """Decode-cache leaf specs. Leaves are stacked over units (leading
    U). ``seq_shard``: long_500k mode, batch 1, the KV sequence dim
    sharded."""
    b, tp = rules.batch, rules.tp
    leaf = path.rsplit("/", 1)[-1]
    if ndim <= 1:
        return P(*([None] * ndim))
    if leaf in ("k", "v"):                      # (U, B, S, H, D)
        if seq_shard:
            axes = ("data", tp) if "data" in rules.mesh.mesh_dim_names \
                else (tp,)
            return P(None, None, axes, *([None] * (ndim - 3)))
        # batch over the data axes and KV heads over 'model'; a kv-head
        # count that does not divide the TP axis falls back to
        # replicated heads through sanitize_spec
        return P(None, b, None, tp, *([None] * (ndim - 4)))
    if leaf in ("state", "C"):                  # (U, B, H, P, N)
        if seq_shard:
            return P(None, None, tp, *([None] * (ndim - 3)))
        return P(None, b, tp, *([None] * (ndim - 3)))
    if leaf == "conv":                          # (U, B, k-1, ch)
        if seq_shard:
            return P(*([None] * (ndim - 1)), tp)
        return P(None, b, *([None] * (ndim - 2)))
    if leaf in ("n", "m", "h", "c"):            # mLSTM / sLSTM vectors
        if seq_shard:
            return P(None, None, tp, *([None] * (ndim - 3))) if ndim >= 3 \
                else P(*([None] * ndim))
        return P(None, b, *([None] * (ndim - 2)))
    return P(*([None] * ndim))


def _tensor_leaves(tree) -> Dict[str, Any]:
    """Flat leaves that are tensors (a cache's host ``cross_len`` is
    not)."""
    return {k: t for k, t in flatten(tree).items()
            if isinstance(t, torch.Tensor)}


def cache_shardings(rules: ShardingRules, cache_shape, *, seq_shard: bool):
    return unflatten({
        path: sanitized_placements(
            rules.mesh, t.shape,
            cache_spec(rules, path, t.ndim, seq_shard=seq_shard))
        for path, t in _tensor_leaves(cache_shape).items()})


def batch_shardings(rules: ShardingRules, batch_shape):
    return {k: sanitized_placements(rules.mesh, t.shape,
                                    batch_spec(rules, k, t.ndim))
            for k, t in batch_shape.items()}


# the reference's name here for ``sharding.rules.param_placements``
param_shardings = param_placements


def opt_shardings(rules: ShardingRules, o_shape: OptState, p_shape):
    """The moments take their parameters' placements; the step is a host
    int."""
    pspec = param_shardings(rules, p_shape)
    return OptState(step=None, m=pspec, v=pspec)
