"""Plain PyTorch pieces of the reference models, in float32.

Everything here is written from the published equations, imports nothing
of the program, and computes in f32 with TF32 off (``strict_f32``). Every
matrix product goes through ``mm``, so that the control (``fp8``)
quantizes the operands of the same products and nothing else:
float8 e4m3 with one scale a tensor (its largest magnitude at 448) for
the forward's operands, e5m2 for the gradient flowing back, each product
accumulated in f32.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")


@contextmanager
def strict_f32():
    """TF32 off for matrix products and convolutions while the
    reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _quant(t, dtype):
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _FP8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _quant(a, torch.float8_e4m3fn)
        qb = _quant(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quant(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # sum over batch dims a broadcast operand did not have
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def mm(a, b, prec: str):
    if prec == "fp8":
        return _FP8Product.apply(a, b)
    return a @ b


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> angles (..., S, head_dim / 2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def mrope_angles(seq: int, head_dim: int, theta: float, sections,
                 vision_tokens: int, device, grid_w: int = 32):
    """Qwen2-VL's M-RoPE with a vision prefix of ``vision_tokens``
    patches on a grid ``grid_w`` wide: (t, h, w) = (0, i // grid_w,
    i % grid_w) there and (i, i, i) for text; the rotary channels split
    among the three streams by ``sections``."""
    pos = torch.arange(seq, device=device)
    vis = pos < vision_tokens
    t = torch.where(vis, torch.zeros_like(pos), pos)
    h = torch.where(vis, pos // grid_w, pos)
    w = torch.where(vis, pos % grid_w, pos)
    parts, start = [], 0
    for stream, sec in zip((t, h, w), sections):
        parts.append(rope_angles(stream, head_dim, theta)[:, start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def rotate(x, ang):
    """x (S, H, D) by angles (S, D/2): the halves (x1, x2) become
    (x1 cos - x2 sin, x2 cos + x1 sin)."""
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, wq, wk, wv, wo, ang, *, n_heads, n_kv_heads, head_dim,
              prec):
    """Causal softmax attention of one row x (S, d): GQA, RoPE on q and
    k, scores scaled by 1 / sqrt(head_dim)."""
    s = x.shape[0]
    q = mm(x, wq, prec).view(s, n_heads, head_dim)
    k = mm(x, wk, prec).view(s, n_kv_heads, head_dim)
    v = mm(x, wv, prec).view(s, n_kv_heads, head_dim)
    if ang is not None:
        q, k = rotate(q, ang), rotate(k, ang)
    rep = n_heads // n_kv_heads
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))          # (H, S, D)
    scores = mm(q, k.transpose(1, 2), prec) / math.sqrt(head_dim)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(probs, v, prec).transpose(0, 1).reshape(s, n_heads * head_dim)
    return mm(out, wo, prec)


def swiglu(x, gate, up, down, prec):
    return mm(F.silu(mm(x, gate, prec)) * mm(x, up, prec), down, prec)


def token_loss(logits, labels):
    """Mean next-token cross-entropy of one row, f32."""
    return F.cross_entropy(logits, labels)
