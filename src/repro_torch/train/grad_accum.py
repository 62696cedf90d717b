"""Gradient accumulation, the paper's enabling mechanism (Section
IV-A.4), as the reference's ``train/grad_accum.py``: a step at batch B
taken as ``s = ceil(B/b)`` micro-batches of ``b = ceil(B/accum_steps)``
rows. When b does not divide B the final micro-batch is padded to b rows
and masked by an injected ``sample_mask``, and each micro-batch's loss
and gradients are weighted by n_i/B in f32 before the cast to
``accum_dtype``, so the sum is the exact full-batch mean.

The micro-batch loop is a Python loop (the reference's ``lax.scan``), and
each micro-batch's gradients are dropped as soon as they are added to the
accumulator, so only one micro-batch's gradients are alive at a time.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.tree import flatten, zeros_like_tree


def _leading_dim(batch: Dict[str, torch.Tensor]) -> int:
    dims = {t.shape[0] for t in batch.values()}
    if len(dims) != 1:
        raise ValueError(f"inconsistent batch leading dims: {dims}")
    return dims.pop()


@torch.no_grad()
def _add_into(acc, grads, weight=None) -> None:
    """acc += grads, or acc += f32(weight * grads) on the ragged path.
    ``grads`` is flat, as ``loss_and_grad`` returns it: a stacked unit
    weight's key maps to its list of per-unit gradients."""
    fa = flatten(acc)
    for key, g in grads.items():
        pairs = (zip(fa[key].unbind(0), g) if isinstance(g, list)
                 else [(fa[key], g)])
        for t, gi in pairs:
            gi = gi.float()
            t.add_(gi if weight is None else gi * weight)


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
    flat (``tree.flatten`` keys), a stacked unit weight as a list of
    per-unit gradients.

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
    acc = zeros_like_tree(params, accum_dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)

    if big % sub == 0:
        for i in range(steps):
            mb = {k: t[i * sub:(i + 1) * sub] for k, t in batch.items()}
            loss, grads = loss_and_grad(params, mb)
            _add_into(acc, grads)
            del grads
            loss_sum += loss.detach().float()
        inv = 1.0 / steps
        with torch.no_grad():
            for t in flatten(acc).values():
                t.mul_(inv)
        return loss_sum * inv, acc

    # ragged final micro-batch: pad + mask, weight each micro-batch by its
    # valid-sample share so the sum is the exact full-batch mean
    last = big - (steps - 1) * sub
    padded = steps * sub
    counts = torch.full((steps,), float(sub), dtype=torch.float32)
    counts[-1] = float(last)
    weights = counts / big                       # f32, sums to 1
    mask = (torch.arange(padded, dtype=torch.float32, device=device)
            < big).float().reshape(steps, sub)
    for i in range(steps):
        mb = {}
        for k, t in batch.items():
            part = t[i * sub:(i + 1) * sub]
            if part.shape[0] < sub:
                pad = torch.zeros((sub - part.shape[0],) + part.shape[1:],
                                  dtype=t.dtype, device=t.device)
                part = torch.cat([part, pad])
            mb[k] = part
        mb["sample_mask"] = mask[i]
        loss, grads = loss_and_grad(params, mb)
        w = weights[i].to(device)
        _add_into(acc, grads, w)
        del grads
        loss_sum += w * loss.detach().float()
    return loss_sum, acc
