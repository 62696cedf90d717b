"""Loss and train step (the reference's ``train/train_step.py``).

On DTensor parameters (``launch.train --distributed``,
``ScheduleExecutor(rules=)``) autograd returns each gradient where
DTensor's rules leave it, often a partial sum over the batch axes and not
at its parameter's placements (the reference's XLA moved it there
implicitly). ``_reduce_grad`` brings each micro-batch's gradient to its
parameter's placements before it is added into the accumulator:
``reshard_grads=False`` all-reduces the partial sums at full size and
keeps the local block, ``True`` reduce-scatters straight to the
placements; ``grad_reduce_dtype`` casts before that reduction. As in the
reference, the accumulated gradients are cast to ``grad_reduce_dtype``
before the update, on plain tensors and DTensors alike; on plain tensors
``reshard_grads`` has nothing to move."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.models import forward
from repro_torch.models.model import layered_units
from repro_torch.sharding.hooks import is_dtensor, unshard
from repro_torch.tree import flatten, grad_leaves, tree_map
from repro_torch.util.spans import span

from .grad_accum import accumulate_gradients
from .optimizer import OptState, _chunks, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1            # s, gradient-accumulation sub-steps
    lr: float = 3e-4
    weight_decay: float = 0.1
    aux_loss_weight: float = 0.01   # MoE load balance (0 aux here)
    remat: bool = True
    accum_dtype: str = "float32"
    schedule: Optional[Callable] = None   # overrides lr when set
    # reduce each DTensor gradient straight to its parameter's placements
    # (reduce-scatter) instead of a full-size all-reduce; optionally in a
    # narrower dtype
    reshard_grads: bool = False
    grad_reduce_dtype: Optional[str] = None


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            aux_loss_weight: float = 0.01, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token CE in f32. An optional ``sample_mask`` (B,) marks
    padded rows of a ragged final micro-batch: they add nothing to the CE
    and the mean runs over valid samples."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    # vocab-sharded DTensor logits are gathered along the vocab first:
    # left to itself, DTensor moves the shards to the sequence for the
    # log-softmax, and the backward then carries strided shards that it
    # cannot propagate under fake tensors (the dry-run)
    logits = unshard(logits, 2)
    labels = batch["labels"]
    b, s, v = logits.shape
    ll = -F.cross_entropy(logits.float().reshape(b * s, v),
                          labels.reshape(b * s),
                          reduction="none").reshape(b, s)
    mask = batch.get("sample_mask")
    if mask is None:
        ce = -ll.mean()
    else:
        ce = -(ll * mask[:, None]).sum() / (
            torch.clamp(mask.sum(), min=1.0) * s)
    loss = ce + aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux}


def make_loss_and_grad(cfg: ArchConfig, tc: TrainConfig = TrainConfig()):
    """(params, micro_batch) -> (loss, grads), the function that
    ``accumulate_gradients`` calls once per micro-batch. Gradients are
    taken with respect to the leaves of ``tree.grad_leaves`` and come
    back as a list of (flat key, index, gradient): the index is None for
    a whole leaf, (u,) for one unit of a stacked unit weight, or (u, i)
    for one layer of a hybrid's Mamba2 stack."""
    layered = layered_units(cfg)

    def lg(params, micro_batch):
        split, slots = grad_leaves(params, layered)
        with span("repro_torch.step.forward"):
            loss, _ = loss_fn(cfg, split, micro_batch,
                              aux_loss_weight=tc.aux_loss_weight,
                              remat=tc.remat)
        with span("repro_torch.step.backward"):
            grads = torch.autograd.grad(loss,
                                        [leaf for _, _, leaf in slots])
            if is_dtensor(loss):
                loss = loss.full_tensor()
                grads = [_reduce_grad(g, leaf.placements, tc)
                         for (_, _, leaf), g in zip(slots, grads)]
        return loss.detach(), [(key, index, g) for (key, index, _), g
                               in zip(slots, grads)]

    return lg


def _reduce_grad(g, want, tc: TrainConfig):
    """One DTensor gradient at the placements ``want`` of its leaf, cast
    to ``tc.grad_reduce_dtype`` first. ``reshard_grads=False`` reduces
    its partial sums to replicated (an all-reduce at full size) and then
    keeps the local block; ``True`` redistributes straight to ``want``
    (a reduce-scatter)."""
    from torch.distributed.tensor import Replicate
    if tc.grad_reduce_dtype is not None:
        g = g.to(torch_dtype(tc.grad_reduce_dtype))
    if not tc.reshard_grads and any(p.is_partial() for p in g.placements):
        g = g.redistribute(g.device_mesh, [
            Replicate() if p.is_partial() else p for p in g.placements])
    if tuple(g.placements) != tuple(want):
        g = g.redistribute(g.device_mesh, want)
    return g


def grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of ``grads`` as f32, from f64 sums over chunks:
    the CPU's f32 vector_norm accumulates a large tensor naively (2.4e-4
    off for a 2.4M-entry gradient), and a whole-tensor f64 cast would
    copy a multi-GB gradient. DTensor gradients: each rank sums its local
    blocks, each divided by the number of ranks that hold the same block,
    and one all-reduce adds the ranks' sums."""
    flat = list(flatten(grads).values())
    sharded = [g for g in flat if is_dtensor(g)]

    def copies(g) -> float:
        if not is_dtensor(g):
            return 1.0
        n = 1
        for i, p in enumerate(g.placements):
            if not p.is_shard():
                n *= g.device_mesh.size(i)
        return float(n)

    with torch.no_grad():
        total = sum(torch.linalg.vector_norm(c, dtype=torch.float64) ** 2
                    / copies(g) for g in flat for c in _chunks(g))
        if sharded:
            import torch.distributed as dist
            mesh = sharded[0].device_mesh
            if mesh.size() != dist.get_world_size():
                raise ValueError("grad_norm: the mesh must span the "
                                 "process group")
            dist.all_reduce(total)
        return torch.sqrt(total).float()


def make_train_step(cfg: ArchConfig, tc: TrainConfig = TrainConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). Params and optimizer state are updated in place (and
    returned). Gradient accumulation is a loop over micro-batches whose
    memory scales with batch/accum_steps."""
    lg = make_loss_and_grad(cfg, tc)

    def train_step(params, opt_state: OptState, batch):
        loss, grads = accumulate_gradients(
            lg, params, batch, tc.accum_steps,
            accum_dtype=torch_dtype(tc.accum_dtype))
        with span("repro_torch.step.optimizer"):
            if tc.grad_reduce_dtype is not None:
                gdt = torch_dtype(tc.grad_reduce_dtype)
                grads = tree_map(lambda g: g.to(gdt), grads)
            lr = tc.schedule if tc.schedule is not None else tc.lr
            params, opt_state = adamw_update(
                grads, opt_state, params, lr=lr,
                weight_decay=tc.weight_decay)
            norm = grad_norm(grads)
        return params, opt_state, {"loss": loss, "grad_norm": norm}

    return train_step
