"""Plain PyTorch versions of the attention kernels (the reference's
``kernels/ref.py:attention_ref`` plus the backward the Pallas kernels
compute). Deliberately naive: full (S, S) score matrices, f32 throughout.

They take the kernels' (B, H, S, D) layout and masking (``score_mask``,
the reference's ``_score_mask``) and scale q by ``d**-0.5`` before the
QK^T product, as the kernels do. A masked score contributes exactly 0, so
a row with no visible key has O = 0 and ``lse = 0`` (the reference's
convention for fully masked rows). On the CPU the kernel wrappers call
these; on the card ``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import torch


def score_mask(s: int, *, causal: bool, window: int, device
               ) -> torch.Tensor:
    """(S, S) validity mask: causal (qpos >= kpos) and sliding window
    (kpos > qpos - window)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, mask):
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * d ** -0.5, k.float())
    return s.masked_fill(~mask, float("-inf"))


def attention_ref(q, k, v, *, causal=True, window=0):
    """q/k/v: (B, H, S, D) -> (O in q.dtype, lse (B, H, S) f32).
    Differentiable by autograd in q, k, v."""
    mask = score_mask(q.shape[2], causal=causal, window=window,
                      device=q.device)
    s = _scores(q, k, mask)
    m = s.amax(dim=-1, keepdim=True).detach()
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)),
                      torch.zeros_like(l))
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal, window):
    """P = exp(s - lse) (masked entries 0) and dS = P * (dO V^T - delta)."""
    mask = score_mask(q.shape[2], causal=causal, window=window,
                      device=q.device)
    p = torch.exp(_scores(q, k, mask) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=True, window=0):
    """dQ = scale * dS K, in q.dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, window)
    scale = q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype)


def attention_bwd_dkdv_ref(q, k, v, do, lse, delta, *, causal=True,
                           window=0):
    """dK = scale * dS^T Q and dV = P^T dO, in k/v dtype."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, window)
    scale = q.shape[-1] ** -0.5
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)
