"""A cell's inputs, made on the device from ``--seed``: every job's
weights and its training batches. The same seed on the same kind of
device gives the same tensors, so the reference makes the weights again
after the window instead of keeping a copy of them.

Weights: one generator call a stacked tensor, in the type the port keeps
it in: N(0, 0.02) for projections and embeddings, N(0, 0.1) for the
Mamba2 conv, ones for norm scales and Mamba2's D, zeros for biases,
A_log = log(1..16) over the heads, and dt_bias the inverse softplus of dt
drawn log-uniform in [1e-3, 1e-1] (Mamba2's initialisation).

Batches: ``count`` batches of B rows of S + 1 uniform token ids each
(tokens and the next-token labels), in one call; a vlm job also gets its
rows' vision-patch embeddings, N(0, 0.02), in one call.
"""
from __future__ import annotations

import math

import torch

SEED_STRIDE = 1_000_003


def job_seed(seed: int, job: int, what: int) -> int:
    """The generator seed of one job's weights (what=0) or batches (1)."""
    return (seed * SEED_STRIDE + 7919 * job + what) % (2 ** 63)


def _leaf(name: str, shape, dtype, gen, device):
    if name in ("scale", "D"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ("b", "conv_b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "A_log":
        h = shape[-1]
        a = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
        return a.expand(shape).to(dtype).clone()
    if name == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    std = 0.1 if name == "conv_w" else 0.02
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def make_weights(layout: dict, seed: int, device) -> dict:
    """{flat key: tensor} for ``layout`` ({flat key: (shape, dtype)}),
    leaves made in sorted key order from one generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {key: _leaf(key.rsplit("/", 1)[-1], shape, dtype, gen, device)
            for key, (shape, dtype) in sorted(layout.items())}


def make_batches(run: dict, batch: int, seq: int, count: int, seed: int,
                 device) -> list:
    """``count`` training batches of one job, each a dict of tokens and
    labels (B, S) int64 and, for the vlm family, vision_embeds
    (B, vision_tokens, d_model) in the model's dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    toks = torch.randint(0, run["vocab"], (count, batch, seq + 1),
                         generator=gen, device=device)
    vision = None
    if run["family"] == "vlm":
        vision = torch.randn((count, batch, run["vision_tokens"],
                              run["d_model"]), generator=gen,
                             dtype=getattr(torch, run["dtype"]),
                             device=device).mul_(0.02)
    out = []
    for k in range(count):
        b = {"tokens": toks[k, :, :-1].contiguous(),
             "labels": toks[k, :, 1:].contiguous()}
        if vision is not None:
            b["vision_embeds"] = vision[k]
        out.append(b)
    return out
