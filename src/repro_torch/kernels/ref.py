"""Plain PyTorch versions of the attention kernels (the reference's
``kernels/ref.py``: ``attention_ref`` plus the backward the Pallas kernels
compute, ``flash_decode_ref`` and ``flash_decode_paged_ref``).
Deliberately naive: full score matrices, f32 throughout.

They take the kernels' (B, H, S, D) layout and masking (``score_mask``,
the reference's ``_score_mask``) and scale q by ``d**-0.5`` before the
QK^T product, as the kernels do. A masked score contributes exactly 0, so
a row with no visible key has O = 0 and ``lse = 0`` (the reference's
convention for fully masked rows). On the CPU the kernel wrappers call
these; on the card ``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import torch


def score_mask(s: int, *, causal: bool, window: int, device, sk=None,
               q_offset: int = 0) -> torch.Tensor:
    """(S, Sk) validity mask, Sk = S unless given: causal (qpos >= kpos)
    and sliding window (kpos > qpos - window). Query row i sits at
    absolute position ``q_offset + i``."""
    sk = s if sk is None else sk
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, mask):
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * d ** -0.5, k.float())
    return s.masked_fill(~mask, float("-inf"))


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B, H, Sq, D), k/v: (B, H, Sk, D) -> (O in q.dtype, lse
    (B, H, Sq) f32); query row i sits at absolute position
    ``q_offset + i`` (0 and Sq == Sk for training). Differentiable by
    autograd in q, k, v."""
    mask = score_mask(q.shape[2], causal=causal, window=window,
                      device=q.device, sk=k.shape[2], q_offset=q_offset)
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


def flash_decode_ref(q, k, v, lengths):
    """One-query decode attention in model layout. q: (B, 1, H, D); k/v:
    (B, S, H, D) with kv heads already repeated; lengths: (B,) valid
    cache rows (kpos < lengths[b]). A masked probability is exactly 0,
    so a slot with length 0 gives 0. Returns (B, 1, H, D) in q.dtype."""
    s_cache, d = k.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5,
                          k.float())
    valid = torch.arange(s_cache, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    out = out / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def flash_decode_paged_ref(q, k_pool, v_pool, pages, lengths):
    """Paged decode attention in model layout. q: (B, 1, H, D); pools:
    (N, page_size, H_kv, D); pages: (B, P) block table (-1 = unassigned);
    lengths: (B,). Gathers each slot's pages into a linear (B, P *
    page_size, H_kv, D) cache (a -1 entry reads page 0, masked by
    length), repeats the kv heads and defers to ``flash_decode_ref``, so
    it gives the linear cache's result bit for bit."""
    b, p_tab = pages.shape
    _, ps, h_kv, d = k_pool.shape
    groups = q.shape[2] // h_kv
    safe = pages.long().clamp_min(0)
    k = k_pool[safe].reshape(b, p_tab * ps, h_kv, d)
    v = v_pool[safe].reshape(b, p_tab * ps, h_kv, d)
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)
    return flash_decode_ref(q, k, v, lengths)
