"""Plain reference of the hybrid family (zamba2-7b as the port runs it):
one row's loss, f32.

``n_layers`` Mamba2 layers in units of ``attn_every``, each layer
x + Mamba2(rms_norm(x)), each unit followed by the one shared block
(the dense family's attention + SwiGLU block, the same weights at every
application); a final norm and an untied head.

Mamba2 (arXiv:2405.21060): in_proj to (z, x B C, dt); a depthwise causal
conv of width ``ssm_conv`` over (x, B, C) and SiLU; dt = softplus(dt +
dt_bias), A = -exp(A_log); the scan h_t = exp(A dt_t) h_{t-1} + dt_t x_t
B_t^T, y_t = h_t C_t + D x_t, one group of B and C for all heads; then
rms_norm(y * SiLU(z)) and out_proj. The scan is computed chunk by chunk
(the SSD's block decomposition, chunks of 64): exact, and far shorter
than 2048 sequential steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import dense
from .common import mm, rms_norm, token_loss

MAMBA = ("ln/scale", "mamba/in_proj/w", "mamba/conv_w", "mamba/conv_b",
         "mamba/A_log", "mamba/dt_bias", "mamba/D", "mamba/norm/scale",
         "mamba/out_proj/w")
SHARED = tuple(f"shared_attn/{k}" for k in dense.BLOCK)
CHUNK = 64


def ssd(x, dt, A, Bm, Cm, chunk: int = CHUNK):
    """x (S, H, P), dt (S, H), A (H,), Bm/Cm (S, N) -> y (S, H, P)."""
    s, h, p = x.shape
    nc = s // chunk
    X = (x * dt[..., None]).view(nc, chunk, h, p)
    cum = (A * dt).view(nc, chunk, h).cumsum(1)                  # (c, l, h)
    Bc, Cc = Bm.view(nc, chunk, -1), Cm.view(nc, chunk, -1)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    seg = cum[:, :, None, :] - cum[:, None, :, :]                # (c, i, j, h)
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    scores = Cc @ Bc.transpose(1, 2)                             # (c, i, j)
    y = torch.einsum("cijh,cjhp->cihp", scores[..., None] * decay, X)
    # each chunk's contribution to the state leaving it, then the states
    # entering each chunk
    to_end = torch.exp(cum[:, -1:, :] - cum)                     # (c, l, h)
    local = torch.einsum("clh,clhp,cln->chpn", to_end, X, Bc)
    total = torch.exp(cum[:, -1, :])                             # (c, h)
    state = torch.zeros_like(local[0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = total[c][:, None, None] * state + local[c]
    entering = torch.stack(entering)                             # (c,h,p,n)
    y = y + torch.einsum("cin,chpn,cih->cihp", Cc, entering, torch.exp(cum))
    return y.reshape(s, h, p)


def mamba_layer(x, run, prec, ln, in_proj, conv_w, conv_b, A_log, dt_bias,
                D, norm, out_proj):
    di = run["ssm_expand"] * run["d_model"]
    n, h, k = run["ssm_state"], run["ssm_heads"], run["ssm_conv"]
    s = x.shape[0]
    proj = mm(rms_norm(x, ln, run["norm_eps"]), in_proj, prec)
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * n], proj[:, 2 * di + 2 * n:]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(pad[i:i + s] * conv_w[i] for i in range(k)) + conv_b)
    xs = xbc[:, :di].view(s, h, di // h)
    Bm, Cm = xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt + dt_bias)
    y = ssd(xs, dt, -torch.exp(A_log), Bm, Cm) + D[:, None] * xs
    y = rms_norm(y.reshape(s, di) * F.silu(z), norm, 1e-5)
    return x + mm(y, out_proj, prec)


def row_loss(P, run, row, prec):
    seq = row["tokens"].shape[0]
    ang = dense.angles(run, seq, row["tokens"].device)
    x = dense.embed(P, run, row)
    per_unit = run["attn_every"] or run["n_layers"]
    shared = [P[k] for k in SHARED] if run["attn_every"] else None
    for u in range(run["n_layers"] // per_unit):
        for i in range(per_unit):
            ws = [P[f"units/mamba/{key}[{u},{i}]"] for key in MAMBA]
            x = checkpoint(mamba_layer, x, run, prec, *ws,
                           use_reentrant=False)
        if shared is not None:
            x = checkpoint(dense.block, x, ang, run, prec, *shared,
                           use_reentrant=False)
    return token_loss(dense.head(x, P, run, prec), row["labels"])
