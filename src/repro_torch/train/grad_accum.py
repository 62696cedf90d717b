"""Gradient accumulation, the paper's enabling mechanism (Section
IV-A.4), as the reference's ``train/grad_accum.py``: a step at batch B
taken as ``s = ceil(B/b)`` micro-batches of ``b = ceil(B/accum_steps)``
rows. When b does not divide B the final micro-batch is padded to b rows
and masked by an injected ``sample_mask``, and each micro-batch's loss
and gradients are weighted by n_i/B in f32 before the cast to
``accum_dtype``, so the sum is the exact full-batch mean.

The micro-batch loop is ``util.loops.scan`` (the reference's
``lax.scan``; a Python loop over every micro-batch, which the dry-run can
count from one trip), and each micro-batch's gradients are dropped as
soon as they are added to the accumulator, so only one micro-batch's
gradients are alive at a time.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.sharding.hooks import is_dtensor
from repro_torch.tree import flatten, zeros_like_tree
from repro_torch.util.loops import scan
from repro_torch.util.spans import span


def _leading_dim(batch: Dict[str, torch.Tensor]) -> int:
    dims = {t.shape[0] for t in batch.values()}
    if len(dims) != 1:
        raise ValueError(f"inconsistent batch leading dims: {dims}")
    return dims.pop()


@torch.no_grad()
def _add_into(acc, grads, weight=None) -> None:
    """acc += grads, or acc += f32(weight * grads) on the ragged path.
    ``grads`` is the list of (flat key, index, gradient) that
    ``loss_and_grad`` returns: the index is None for a whole leaf, (u,)
    for unit u of a stacked unit weight, or (u, i) for layer i of it."""
    fa = flatten(acc)
    for key, index, g in grads:
        t = fa[key]
        if is_dtensor(t):
            # the gradient already stands at the slice's placements
            # (``train_step._reduce_grad``): add the local blocks
            t, g = t.to_local(), g.to_local()
        t = t if index is None else t[index]
        g = g.float()
        t.add_(g if weight is None else g * weight)


def _rows(t, start: int, stop: int):
    """Rows [start, stop) of a batch tensor. A DTensor sharded along the
    batch gives the same rows as on one device, sharded again over the
    batch axes when they divide the micro-batch (DTensor gathers the
    batch to slice it; token ids are small)."""
    part = t[start:stop]
    if not is_dtensor(t) or part.placements == t.placements:
        return part
    from torch.distributed.tensor import Replicate
    mesh, n = t.device_mesh, stop - start
    sizes = [mesh.size(i) for i, pl in enumerate(t.placements)
             if pl.is_shard(0)]
    prod = 1
    for size in sizes:
        prod *= size
    want = [pl if n % prod == 0 or not pl.is_shard(0) else Replicate()
            for pl in t.placements]
    return part.redistribute(mesh, want)


def accumulate_gradients(
    loss_and_grad: Callable,       # (params, micro_batch) -> (loss, grads)
    params,
    batch: Dict[str, torch.Tensor],
    accum_steps: int,
    *,
    accum_dtype=torch.float32,
) -> Tuple[torch.Tensor, Any]:
    """Returns (mean loss, mean grads in ``accum_dtype``, shaped like
    ``params``) over the micro-batches of ``batch`` (a dict of tensors
    with a common leading dim B). ``loss_and_grad`` returns its gradients
    as a list of (``tree.flatten`` key, index, gradient), the index
    selecting the slice of the stacked weight (``tree.grad_leaves``).

    ``accum_steps <= 1`` is one micro-batch through the same path: its
    gradients are cast to ``accum_dtype`` and scaled by 1.0, the same
    values the reference's optimizer makes of them with its own cast."""
    # ``sample_mask`` is reserved for the ragged-path injection below
    if accum_steps > 1 and "sample_mask" in batch:
        raise ValueError("sample_mask is injected by accumulate_gradients; "
                         "pre-masked batches are only supported with "
                         "accum_steps=1")

    big = _leading_dim(batch)
    sub = math.ceil(big / max(accum_steps, 1))
    steps = math.ceil(big / sub)
    device = next(iter(batch.values())).device
    with span("repro_torch.step.accumulate"):
        acc = zeros_like_tree(params, accum_dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)

    if big % sub == 0:
        def micro(i, _):
            with span("repro_torch.step.micro_batch"):
                mb = {k: _rows(t, i * sub, (i + 1) * sub)
                      for k, t in batch.items()}
                loss, grads = loss_and_grad(params, mb)
                with span("repro_torch.step.accumulate"):
                    _add_into(acc, grads)
                    del grads
                    loss_sum.add_(loss.detach().float())
            return None, None

        scan(micro, None, steps, uniform=True)
        inv = 1.0 / steps
        with span("repro_torch.step.accumulate"):
            with torch.no_grad():
                for t in flatten(acc).values():
                    t.mul_(inv)
            loss = loss_sum * inv
        return loss, acc

    # ragged final micro-batch: pad + mask, weight each micro-batch by its
    # valid-sample share so the sum is the exact full-batch mean
    last = big - (steps - 1) * sub
    padded = steps * sub
    counts = torch.full((steps,), float(sub), dtype=torch.float32)
    counts[-1] = float(last)
    weights = counts / big                       # f32, sums to 1
    mask = (torch.arange(padded, dtype=torch.float32, device=device)
            < big).float().reshape(steps, sub)
    def ragged(i, _):
        with span("repro_torch.step.micro_batch"):
            mb = {}
            for k, t in batch.items():
                part = _rows(t, i * sub, (i + 1) * sub)
                if part.shape[0] < sub:
                    pad = torch.zeros((sub - part.shape[0],) + part.shape[1:],
                                      dtype=t.dtype, device=t.device)
                    part = torch.cat([part, pad])
                mb[k] = part
            mb["sample_mask"] = mask[i]
            loss, grads = loss_and_grad(params, mb)
            with span("repro_torch.step.accumulate"):
                w = weights[i].to(device)
                _add_into(acc, grads, w)
                del grads
                loss_sum.add_(w * loss.detach().float())
        return None, None

    scan(ragged, None, steps)
    return loss_sum, acc
