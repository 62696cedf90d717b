"""Shared layers: RMS norm, linear, tied embedding, RoPE / M-RoPE and the
SwiGLU MLP. Parameters are plain dicts of tensors in the reference's
layout (``models/layers.py``): linear weights are (d_in, d_out)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, dtype, device, std=0.02):
    """N(0, std^2) in f32 from ``gen``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def rms_norm(p, x, eps=1e-5):
    """Variance in f32, then cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed(p, tokens, dtype):
    return F.embedding(tokens, p["table"].to(dtype))


def unembed(p, x):
    # tied head: logits = x @ table.T
    return x @ p["table"].to(x.dtype).T


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, head_dim//2)."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE. positions3: (3, B, S) temporal/height/width
    streams; ``sections`` split the head_dim//2 rotary channels among
    them. Returns (B, S, head_dim//2) cos/sin."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"head_dim//2 = {head_dim // 2}")
    freqs = rope_freqs(head_dim, theta, positions3.device)
    ang_all = positions3[..., None].float() * freqs      # (3, B, S, D/2)
    chunks = []
    start = 0
    for i, sec in enumerate(sections):
        chunks.append(ang_all[i, :, :, start:start + sec])
        start += sec
    ang = torch.cat(chunks, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def swiglu(p, x):
    h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    return linear(p["down"], h)
