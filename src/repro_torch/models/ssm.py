"""Mamba2 (SSD) block (the reference's ``models/ssm.py``): training
(``mamba2_init``, ``_split_proj``, ``_causal_conv``, ``mamba2_forward``)
and serving (``mamba2_init_cache``, ``mamba2_prefill``, ``mamba2_decode``).

The SSD core of training and prefill goes through ``kernels.ops``
(``ssd``, and ``ssd_prefill``, which continues a cached state and returns
the final one): on the card the hand-written chunk-scan kernels, on the
CPU their plain version. Decode is the one-token recurrence in f32, plain
PyTorch as in the reference, which has no kernel for it either. ``A_log``,
``dt_bias`` and ``D`` stay f32 in a bf16 model, as in the reference, and
the SSD runs in f32.

A layer's decode cache is {"conv": (B, d_conv - 1, C) in the model's
dtype, the last raw conv inputs; "state": (B, H, P, N) f32}. Prefill and
decode write it in place, as attention writes its K/V rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.hooks import constrain, is_dtensor, on_local_blocks

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


def _causal_conv(xbc, w, b, window=None):
    """Depthwise causal conv, xbc: (B, S, C), w: (k, C), continuing
    ``window`` (B, k - 1, C), the raw inputs before xbc (zeros if None):
    the reference's shifted sum, not ``F.conv1d`` (cuDNN would run an f32
    conv in TF32). On DTensors it runs on each rank's local blocks
    (``local_map``): the batch over the batch axes, the channels over
    'model' (where it divides them, as ``act_inner`` shards them), the
    sequence whole on every rank (gathered first if it came sharded)."""
    if any(is_dtensor(t) for t in (xbc, w, b, window)):
        args = (xbc, w, b) + (() if window is None else (window,))
        roles = ((0, 2), (None, 1), (None, 0), (0, 2))[:len(args)]
        return on_local_blocks(_causal_conv, args, roles, ((0, 2),),
                               xbc.shape[0], (xbc.shape[2],))
    k, s = w.shape[0], xbc.shape[1]
    if window is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([window.to(xbc.dtype), xbc], dim=1)
    out = sum(pad[:, i:i + s] * w[i].to(xbc.dtype) for i in range(k))
    return F.silu(out + b.to(xbc.dtype))


def _ssm_inputs(p, xbc, dt_raw, d_inner, n, h):
    """x (.., H, P), Bm, Cm (.., N) and dt (.., H) in f32, and A (H,)."""
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_inner].float().reshape(lead + (h, d_inner // h))
    Bm = xbc[..., d_inner:d_inner + n].float()
    Cm = xbc[..., d_inner + n:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return xs, Bm, Cm, dt, -torch.exp(p["A_log"])


def _out(p, y, z, x):
    """y (B, S, H, P) f32 -> the gated norm and the out projection."""
    b, s = y.shape[:2]
    y = y.reshape(b, s, -1).to(x.dtype)
    return linear(p["out_proj"], rms_norm(p["norm"], y * F.silu(z)))


def mamba2_forward(p, x, *, d_inner, ssm_state, n_heads):
    """x: (B, S, d_model) -> (B, S, d_model)."""
    proj = linear(p["in_proj"], x)
    z, xbc, dt_raw = _split_proj(proj, d_inner, ssm_state, n_heads)
    xbc = constrain(_causal_conv(xbc, p["conv_w"], p["conv_b"]),
                    "act_inner")
    xs, Bm, Cm, dt, A = _ssm_inputs(p, xbc, dt_raw, d_inner, ssm_state,
                                    n_heads)
    y = ops.ssd(xs, dt, A, Bm, Cm) + p["D"][:, None] * xs
    return _out(p, y, z, x)


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #
def mamba2_init_cache(batch, d_inner, ssm_state, n_heads, d_conv=4, *,
                      lead=(), dtype, device):
    """A zeroed decode cache, each leaf with leading dims ``lead`` (the
    model stacks them (n_units, layers per unit))."""
    lead = tuple(lead)
    conv_ch = d_inner + 2 * ssm_state
    return {
        "conv": torch.zeros(lead + (batch, d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, n_heads, d_inner // n_heads,
                                     ssm_state),
                             dtype=torch.float32, device=device),
    }


def mamba2_prefill(p, x, cache, *, d_inner, ssm_state, n_heads):
    """The whole prompt x (B, S, d_model) in one call, warm-started from
    ``cache`` (conv window and SSM state), which it leaves as a
    per-token ``mamba2_decode`` loop would have: the last d_conv - 1 raw
    conv inputs and the state after the last row, written in place.
    Returns (out (B, S, d_model), cache). The SSD goes through
    ``ops.ssd_prefill``."""
    n, h = ssm_state, n_heads
    proj = linear(p["in_proj"], x)
    z, xbc_raw, dt_raw = _split_proj(proj, d_inner, n, h)
    conv = cache["conv"]
    xbc = constrain(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"], conv),
                    "act_inner")
    conv.copy_(torch.cat([conv, xbc_raw[:, -conv.shape[1]:].to(conv.dtype)],
                         dim=1)[:, -conv.shape[1]:])
    xs, Bm, Cm, dt, A = _ssm_inputs(p, xbc, dt_raw, d_inner, n, h)
    y, state = ops.ssd_prefill(xs, dt, A, Bm, Cm, cache["state"])
    cache["state"].copy_(constrain(state, "ssm_state"))
    y = y + p["D"][:, None] * xs
    return _out(p, y, z, x), cache


def mamba2_decode(p, x, cache, *, d_inner, ssm_state, n_heads):
    """One token, x (B, 1, d_model): the conv over the cached window and
    this token, then one step of the recurrence in f32
    state = exp(A dt) state + dt x B^T, y = state C + D x. Updates
    ``cache`` in place; returns (out (B, 1, d_model), cache). Besides
    the two projections every op works element by element or along a
    row's own last axis, never across the batch."""
    n, h = ssm_state, n_heads
    proj = linear(p["in_proj"], x)[:, 0]                     # (B, ...)
    z, xbc, dt_raw = _split_proj(proj, d_inner, n, h)
    win = torch.cat([cache["conv"], xbc[:, None].to(cache["conv"].dtype)],
                    dim=1)                                   # (B, k, C)
    w = p["conv_w"].float()
    conv = sum(win[:, i].float() * w[i] for i in range(w.shape[0]))
    xbc = F.silu(conv + p["conv_b"].float())
    cache["conv"].copy_(win[:, 1:])
    xs, Bm, Cm, dt, A = _ssm_inputs(p, xbc, dt_raw, d_inner, n, h)
    state = cache["state"]                                   # (B, H, P, N)
    state.mul_(torch.exp(A * dt)[..., None, None]).add_(
        (dt[..., None] * xs)[..., None] * Bm[:, None, None, :])
    state = constrain(state, "ssm_state")
    y = (state * Cm[:, None, None, :]).sum(dim=-1) + p["D"][:, None] * xs
    return _out(p, y[:, None], z[:, None], x), cache
