"""Mixture-of-Experts FFN (the reference's ``models/moe.py``): top-k
routing in f32, grouped capacity-based dispatch, an optional shared
expert (Llama-4) and expert padding (granite's 40 experts padded to a
multiple of an expert-parallel axis; padded experts get router logits of
-1e30, so they are never chosen).

Three dispatches, as in the reference:
  * ``einsum``  - one-hot dispatch and combine einsums over per-group
                  capacity slots (the reference's default).
  * ``scatter`` - the same slots through an index scatter and gather.
  * ``dense``   - every expert on every token, the exact weighted sum of
                  its top-k; O(E) compute, the routing oracle, and the
                  one dispatch whose rows do not depend on the other
                  tokens of the call (so a suffix prefill gives a whole
                  prefill's rows).

Tokens are taken in groups of ``group_size`` along the sequence, and an
expert holds at most C = max(1, ceil(cf * g * k / E)) tokens of a group;
an assignment past C is dropped. No Pallas kernel stands behind this
module in the reference: it is plain PyTorch here too, and its products
go to cuBLAS on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.hooks import constrain, contiguous_local, unshard

from .layers import linear, normal_init, swiglu

GROUP_SIZE = 256
CAPACITY_FACTOR = 1.25


def moe_init(gen, d_model, n_experts, d_ff, *, shared_expert=False,
             pad_to: int = 0, lead=(), dtype, device):
    """Router (d, E_pad) and stacked experts (E_pad, d, f) / (E_pad, f, d),
    each with the leading dims ``lead``; ``pad_to`` pads the expert
    dimension to that count (0 = no padding); ``shared_expert`` adds a
    SwiGLU MLP every token takes."""
    e_pad = max(n_experts, pad_to)

    def w(*shape):
        return {"w": normal_init(gen, lead + shape, dtype, device)}

    p = {"router": w(d_model, e_pad),
         "experts": {
             "gate": normal_init(gen, lead + (e_pad, d_model, d_ff), dtype,
                                 device),
             "up": normal_init(gen, lead + (e_pad, d_model, d_ff), dtype,
                               device),
             "down": normal_init(gen, lead + (e_pad, d_ff, d_model), dtype,
                                 device)}}
    if shared_expert:
        p["shared"] = {"gate": w(d_model, d_ff), "up": w(d_model, d_ff),
                       "down": w(d_ff, d_model)}
    return p


def stable_top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``'s order: values descending and, among equal
    values, the lower expert index first. A stable descending sort keeps
    equal values in index order, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of 0."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_positions(mask_e: torch.Tensor, capacity: int):
    """Capacity slots. mask_e: (G, g, k, E) one-hot of each token's k-th
    choice. Every first choice of a group is placed before any second
    choice (k-priority), each in token order. Returns (position (G, g, k),
    keep (G, g, k)): an assignment whose position reaches ``capacity`` is
    dropped."""
    G, g, k, E = mask_e.shape
    positions, keeps = [], []
    offset = torch.zeros((G, 1, E), dtype=mask_e.dtype,
                         device=mask_e.device)
    for slot in range(k):
        m = mask_e[:, :, slot, :]                         # (G, g, E)
        pos_in_e = torch.cumsum(m, dim=1) - m + offset
        pos = (pos_in_e * m).sum(-1)                      # (G, g)
        positions.append(pos)
        keeps.append(pos < capacity)
        offset = offset + m.sum(dim=1, keepdim=True)
    return torch.stack(positions, -1), torch.stack(keeps, -1)


def _experts(w, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert on its slots: xe (G, E, C, d) -> (G, E, C,
    d). A DTensor operand of an expert product has its local block made
    contiguous first (``contiguous_local``): the einsum reshapes it
    expert-major, which DTensor's strides allow as a view and the local
    block's layout does not."""
    dt = xe.dtype
    xe = contiguous_local(xe)
    h = F.silu(torch.einsum("tecd,edf->tecf", xe, w["gate"].to(dt))) \
        * torch.einsum("tecd,edf->tecf", xe, w["up"].to(dt))
    return torch.einsum("tecf,efd->tecd", contiguous_local(h),
                        w["down"].to(dt))


def moe_forward(p, x, *, n_experts: int, top_k: int,
                group_size: int = GROUP_SIZE,
                capacity_factor: float = CAPACITY_FACTOR,
                dispatch: str = "einsum"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux load-balance loss, 0-dim f32)."""
    b, s, d = x.shape
    e_pad = p["router"]["w"].shape[-1]
    logits = linear(p["router"], x.float())                # (B, S, E_pad)
    if e_pad > n_experts:
        pad = torch.arange(e_pad, device=x.device) >= n_experts
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    probs = constrain(torch.softmax(logits, dim=-1), "router")

    # load-balance aux (Switch): E * sum_e f_e * P_e; argmax takes the
    # first of equal maxima, as jnp.argmax does
    top1 = torch.argmax(probs, dim=-1)
    f_e = _one_hot(top1, e_pad, torch.float32).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(f_e * p_e)

    gate_vals, top_idx = stable_top_k(probs, top_k)        # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    if dispatch == "dense":
        return _dense_moe(p, x, gate_vals, top_idx) + _shared(p, x), aux
    if dispatch not in ("einsum", "scatter"):
        raise ValueError(f"unknown moe dispatch {dispatch!r}")

    g = min(group_size, s)
    if s % g:
        raise ValueError(f"sequence {s} is not a multiple of the MoE group "
                         f"{g}")
    G = b * (s // g)
    cap = max(1, math.ceil(capacity_factor * g * top_k / n_experts))
    xg = x.reshape(G, g, d)
    idxg = top_idx.reshape(G, g, top_k)
    gateg = gate_vals.reshape(G, g, top_k)
    onehot = _one_hot(idxg, e_pad, torch.int64)           # (G, g, k, E)
    pos, keep = _top_k_positions(onehot, cap)              # (G, g, k)

    if dispatch == "scatter":
        y = _scatter_moe(p, xg, idxg, pos, keep, gateg, cap, e_pad)
        return y.reshape(b, s, d) + _shared(p, x), aux
    # dispatch and combine tensors (G, g, E, C); a dropped assignment's
    # slot row is 0
    slot_oh = _one_hot(pos, cap, x.dtype) * keep[..., None].to(x.dtype)
    disp = torch.einsum("tgke,tgkc->tgec", onehot.to(x.dtype), slot_oh)
    comb = torch.einsum("tgk,tgke,tgkc->tgec", gateg.float(),
                        onehot.float(), slot_oh.float())
    xe = constrain(torch.einsum("tgec,tgd->tecd", disp, xg), "moe_dispatch")
    ye = constrain(_experts(p["experts"], xe), "moe_dispatch")
    # combine in the model dtype, as the reference does. DTensor runs this
    # einsum as a bmm over (expert, slot) merged, which it cannot
    # propagate with the experts sharded (a strided shard): the expert
    # outputs are gathered over 'model' first
    y = torch.einsum("tgec,tecd->tgd", comb.to(x.dtype), unshard(ye, 1))
    return y.reshape(b, s, d).to(x.dtype) + _shared(p, x), aux


def _scatter_moe(p, xg, idxg, pos, keep, gateg, cap, e_pad):
    """Index dispatch: xe[G, e, c] += x[G, t] at (e, c) = (expert, slot) of
    each kept assignment (a dropped one adds a zero row at slot C - 1);
    the combine gathers the same slots back."""
    G, g, d = xg.shape
    gi = torch.arange(G, device=xg.device)[:, None, None].expand_as(idxg)
    upd = xg[:, :, None, :] * keep[..., None].to(xg.dtype)  # (G, g, k, d)
    pos_c = torch.clamp_max(pos, cap - 1)
    xe = torch.zeros((G, e_pad, cap, d), dtype=xg.dtype, device=xg.device)
    xe = xe.index_put((gi, idxg, pos_c), upd, accumulate=True)
    xe = constrain(xe, "moe_dispatch")
    ye = constrain(_experts(p["experts"], xe), "moe_dispatch")
    picked = ye[gi, idxg, pos_c]                            # (G, g, k, d)
    wk = (gateg * keep.to(gateg.dtype)).to(xg.dtype)
    return torch.einsum("tgk,tgkd->tgd", wk, picked)


def _shared(p, x):
    if "shared" not in p:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return swiglu(p["shared"], x)


def _dense_moe(p, x, gate_vals, top_idx):
    """Exact O(E) oracle: every expert on every token, the top-k summed
    with their normalised gates in f32."""
    w = p["experts"]
    dt = x.dtype
    e_pad = w["gate"].shape[0]
    h = F.silu(torch.einsum("bsd,edf->ebsf", x, w["gate"].to(dt))) \
        * torch.einsum("bsd,edf->ebsf", x, w["up"].to(dt))
    ys = torch.einsum("ebsf,efd->ebsd", h, w["down"].to(dt))
    weights = torch.zeros(gate_vals.shape[:-1] + (e_pad,),
                          dtype=torch.float32, device=x.device)
    for k in range(gate_vals.shape[-1]):
        weights = weights + gate_vals[..., k:k + 1] * _one_hot(
            top_idx[..., k], e_pad, torch.float32)
    y = torch.einsum("ebsd,bse->bsd", ys.float(), weights)
    return y.to(dt)
