"""Mamba2 (SSD) block, training half (the reference's ``models/ssm.py``:
``mamba2_init``, ``_split_proj``, ``_causal_conv``, ``mamba2_forward``).

The SSD core always goes through ``kernels.ops.ssd``: on the card the
hand-written chunk-scan kernels, on the CPU their plain version. ``A_log``,
``dt_bias`` and ``D`` stay f32 in a bf16 model, as in the reference, and
the SSD runs in f32. Serving (``mamba2_prefill``, ``mamba2_decode`` and a
chunked SSD with an initial state) comes with the hybrid-serving slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import linear, normal_init, rms_norm


def mamba2_init(gen, d_model, d_inner, ssm_state, n_heads, d_conv=4, *,
                lead=(), dtype, device):
    """One Mamba2 layer's parameters, each with leading dims ``lead``
    (the model stacks them (n_units, layers per unit)). Values follow the
    reference's init in distribution, not bit for bit."""
    if d_inner % n_heads:
        raise ValueError(f"d_inner {d_inner} is not a multiple of "
                         f"{n_heads} heads")
    n, h = ssm_state, n_heads
    d_in_proj = 2 * d_inner + 2 * n + h          # z, x, B, C, dt
    conv_ch = d_inner + 2 * n                    # x, B, C get convolved
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand(lead + (h,), generator=gen, **f32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": {"w": normal_init(gen, lead + (d_model, d_in_proj), dtype,
                                     device)},
        "conv_w": normal_init(gen, lead + (d_conv, conv_ch), dtype, device,
                              std=0.1),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)).expand(
            lead + (h,)).clone(),
        "dt_bias": dt_bias,
        "D": torch.ones(lead + (h,), **f32),
        "norm": {"scale": torch.ones(lead + (d_inner,), dtype=dtype,
                                     device=device)},
        "out_proj": {"w": normal_init(gen, lead + (d_inner, d_model), dtype,
                                      device)},
    }


def _split_proj(proj, d_inner, n, h):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., d_inner + d_inner + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, xbc: (B, S, C), w: (k, C): the reference's
    shifted sum, not ``F.conv1d`` (cuDNN would run an f32 conv in TF32)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i].to(xbc.dtype) for i in range(k))
    return F.silu(out + b.to(xbc.dtype))


def mamba2_forward(p, x, *, d_inner, ssm_state, n_heads):
    """x: (B, S, d_model) -> (B, S, d_model)."""
    b, s, _ = x.shape
    n, h = ssm_state, n_heads
    proj = linear(p["in_proj"], x)
    z, xbc, dt_raw = _split_proj(proj, d_inner, n, h)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner].float().reshape(b, s, h, d_inner // h)
    Bm = xbc[..., d_inner:d_inner + n].float()
    Cm = xbc[..., d_inner + n:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])   # (b,s,h)
    A = -torch.exp(p["A_log"])
    y = ops.ssd(xs, dt, A, Bm, Cm)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z))
    return linear(p["out_proj"], y)
