"""The reference's training steps: the loss of each step, the first
step's gradient and the parameters' change after the steps, each by
leaf, from the benchmark's weights and batches.

A step is the mean loss over the batch's rows and its gradient, taken
row by row and averaged in f32 (the full-batch mean, whatever the
program's micro-batches), then AdamW (decoupled weight decay, bias
corrections) in f32. Between steps each parameter is held in the type
the weights were made in, as the configuration states (bf16 leaves are
rounded to bf16 after each update; f32 leaves stay f32), and every
computation is f32 with TF32 off, or, for the control, ``fp8``.

A leaf is a tensor outside the blocks, one block's slice of a stacked
tensor (``key[u]``), or, where a block stacks its layers a second time
(``layered``), one layer's (``key[u,i]``).
"""
from __future__ import annotations

import importlib

import torch

from .common import PRECISIONS, strict_f32


def leaves(flat: dict, layered=()) -> dict:
    """{leaf name: view} over a {flat key: tensor} dict."""
    out = {}
    for key in sorted(flat):
        t = flat[key]
        if key.startswith("units/") and any(key.startswith(p)
                                            for p in layered):
            for u in range(t.shape[0]):
                for i in range(t.shape[1]):
                    out[f"{key}[{u},{i}]"] = t[u, i]
        elif key.startswith("units/"):
            for u in range(t.shape[0]):
                out[f"{key}[{u}]"] = t[u]
        else:
            out[key] = t
    return out


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tensors.items()}


def adamw(p, g, m, v, step: int, opt: dict):
    """One AdamW update of p (f32) in place."""
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    p.sub_(opt["lr"] * (mhat / (torch.sqrt(vhat) + opt["eps"])
                        + opt["weight_decay"] * p))


def train(weights: dict, run: dict, batches: list, opt: dict, *,
          layered=(), prec: str = "f32", rows=None) -> dict:
    """Steps the reference over ``batches`` (one a step) from
    ``weights`` ({flat key: tensor}, in the types the model keeps).
    ``rows``: the rows of each batch that count (all by default).
    Returns {"losses": [...], "grad": {leaf: norm of step 1's gradient},
    "change": {leaf: norm of the change over all the steps}}."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    family = importlib.import_module(f"{__package__}.{run['family']}")
    src = leaves(weights, layered)
    stored = {k: t.dtype for k, t in src.items()}
    P = {k: t.detach().float().clone().requires_grad_(True)
         for k, t in src.items()}
    m = {k: torch.zeros_like(t) for k, t in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    out = {"losses": []}
    names = list(P)
    with strict_f32():
        for step, batch in enumerate(batches, start=1):
            n = batch["tokens"].shape[0]
            use = list(range(n)) if rows is None else list(rows)
            grads = {k: torch.zeros_like(t) for k, t in P.items()}
            loss_sum = 0.0
            for r in use:
                row = {k: t[r] for k, t in batch.items()}
                loss = family.row_loss(P, run, row, prec)
                gs = torch.autograd.grad(loss, [P[k] for k in names],
                                         allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        grads[k].add_(g, alpha=1.0 / len(use))
                loss_sum += float(loss.detach()) / len(use)
                del gs, loss
            out["losses"].append(loss_sum)
            if step == 1:
                out["grad"] = leaf_norms(grads)
            with torch.no_grad():
                for k in names:
                    adamw(P[k], grads[k], m[k], v[k], step, opt)
                    P[k].copy_(P[k].to(stored[k]).float())
            del grads
        with torch.no_grad():
            out["change"] = {k: float(torch.linalg.vector_norm(
                P[k] - src[k].float())) for k in names}
    return out
