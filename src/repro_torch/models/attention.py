"""GQA attention for training (the reference's ``models/attention.py``).
The attention core always goes through ``kernels.ops.flash_attention``,
which routes on the tensor's device: the flash kernels on the card, their
plain PyTorch version (``kernels/ref.py:attention_ref``) on the CPU. It
stands in for the reference's plain ``full_attention`` /
``chunked_attention``; the port has no switch between the kernel and the
plain path other than the device."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .layers import apply_rope, linear, normal_init


def attention_init(gen, d_model, n_heads, n_kv_heads, head_dim, *,
                   n_units, qkv_bias=False, dtype, device):
    """Stacked (n_units, d_in, d_out) projections, std 0.02."""
    def lin(d_in, d_out, bias):
        p = {"w": normal_init(gen, (n_units, d_in, d_out), dtype, device)}
        if bias:
            p["b"] = torch.zeros((n_units, d_out), dtype=dtype,
                                 device=device)
        return p

    return {
        "wq": lin(d_model, n_heads * head_dim, qkv_bias),
        "wk": lin(d_model, n_kv_heads * head_dim, qkv_bias),
        "wv": lin(d_model, n_kv_heads * head_dim, qkv_bias),
        "wo": lin(n_heads * head_dim, d_model, False),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D); autograd sums the
    gradient over each group."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def attention(p, x, cos, sin, *, n_heads, n_kv_heads, head_dim,
              causal=True, window=0):
    """Training attention over the whole sequence."""
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = linear(p["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = linear(p["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    groups = n_heads // n_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return linear(p["wo"], out.reshape(b, s, n_heads * head_dim))
