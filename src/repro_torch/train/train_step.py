"""Loss and train step (the reference's ``train/train_step.py``). The
reference's ``reshard_grads`` / ``grad_reduce_dtype`` need a mesh and are
left out on one device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.models import forward
from repro_torch.tree import flatten, grad_leaves

from .grad_accum import accumulate_gradients
from .optimizer import OptState, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1            # s, gradient-accumulation sub-steps
    lr: float = 3e-4
    weight_decay: float = 0.1
    aux_loss_weight: float = 0.01   # MoE load balance (0 aux here)
    remat: bool = True
    accum_dtype: str = "float32"
    schedule: Optional[Callable] = None   # overrides lr when set


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            aux_loss_weight: float = 0.01, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token CE in f32. An optional ``sample_mask`` (B,) marks
    padded rows of a ragged final micro-batch: they add nothing to the CE
    and the mean runs over valid samples."""
    logits, aux = forward(cfg, params, batch, remat=remat)
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
    """(params, micro_batch) -> (loss, flat grads), the function that
    ``accumulate_gradients`` calls once per micro-batch. Gradients are
    taken with respect to per-unit leaves (``tree.grad_leaves``), so a
    stacked unit weight comes back as a list of per-unit gradients."""

    def lg(params, micro_batch):
        split, slots = grad_leaves(params)
        loss, _ = loss_fn(cfg, split, micro_batch,
                          aux_loss_weight=tc.aux_loss_weight,
                          remat=tc.remat)
        grads = torch.autograd.grad(loss, [leaf for _, _, leaf in slots])
        flat: Dict = {}
        for (key, u, _), g in zip(slots, grads):
            if u is None:
                flat[key] = g
            else:
                flat.setdefault(key, [None] * cfg.n_units)[u] = g
        return loss.detach(), flat

    return lg


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
        lr = tc.schedule if tc.schedule is not None else tc.lr
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=tc.weight_decay)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(
                torch.linalg.vector_norm(g.float()) ** 2
                for g in flatten(grads).values()))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
