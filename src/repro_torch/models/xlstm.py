"""xLSTM blocks [arXiv:2405.04517] (the reference's ``models/xlstm.py``):
the mLSTM (matrix memory, the chunkwise-parallel training form with
log-space gate stabilisation) and the sLSTM (scalar memory, strictly
recurrent). xLSTM[7:1] stacks 7 mLSTM blocks per sLSTM block.

Plain PyTorch, as in the reference, which has no Pallas kernel for
either: the mLSTM's chunk loop is a Python loop over chunks of 256 rows
(the reference's ``lax.scan``), and the sLSTM's recurrence a Python loop
over tokens, some twenty small launches a token and layer on the card.
q, k, v and the (C, n, m) state are f32 whatever the model's dtype.

A layer's decode cache: the mLSTM's {"C": (B, H, Dh, Dh), "n": (B, H,
Dh), "m": (B, H)}, the sLSTM's {"h", "c", "n", "m"}, each (B, d_model);
all f32. The sLSTM's ``n`` starts at 1e-6, not 0. Prefill and decode
write the cache in place, as attention writes its K/V rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.hooks import (constrain, is_dtensor, merge_last,
                                        on_local_blocks, split_last)
from repro_torch.util.loops import scan

from .layers import linear, normal_init, rms_norm

CHUNK = 256
NEG = -1e30


# ---------------------------------------------------------------------- #
# mLSTM
# ---------------------------------------------------------------------- #
def mlstm_init(gen, d_model, d_inner, n_heads, *, lead=(), dtype, device):
    """One mLSTM layer's parameters, each with leading dims ``lead`` (the
    model stacks them (n_units, mLSTM layers per unit)). ``in_proj``
    packs q, k, v, z (the output gate), i_raw and f_raw."""
    lead = tuple(lead)
    return {
        "in_proj": {"w": normal_init(
            gen, lead + (d_model, 4 * d_inner + 2 * n_heads), dtype,
            device)},
        "norm": {"scale": torch.ones(lead + (d_inner,), dtype=dtype,
                                     device=device)},
        "out_proj": {"w": normal_init(gen, lead + (d_inner, d_model), dtype,
                                      device)},
    }


def _mlstm_split(proj, di, h):
    q = proj[..., 0 * di:1 * di]
    k = proj[..., 1 * di:2 * di]
    v = proj[..., 2 * di:3 * di]
    z = proj[..., 3 * di:4 * di]
    i_raw = proj[..., 4 * di:4 * di + h]
    f_raw = proj[..., 4 * di + h:]
    return q, k, v, z, i_raw, f_raw


def _gates(i_raw, f_raw):
    """(i_log, f_log) in f32: f_log = log sigmoid(f_raw) <= 0."""
    return i_raw.float(), -F.softplus(-f_raw.float())


def mlstm_chunked(q, k, v, i_log, f_log, *, chunk=CHUNK, init_state=None,
                  return_state=False):
    """q/k/v: (B, S, H, D) f32; i_log/f_log: (B, S, H) f32 (f_log <= 0).
    Returns h (B, S, H, D) [, state (C, n, m)]. An S that ``chunk`` does
    not divide runs as one chunk of S rows, as in the reference. On
    DTensors the scan runs on each rank's local blocks (``local_map``):
    the batch over the batch axes, the heads over 'model' where it
    divides them (DTensor has no rule for the ``flip`` in a cumsum's
    backward)."""
    args = (q, k, v, i_log, f_log) + tuple(init_state or ())
    if any(is_dtensor(t) for t in args):
        def local(*a):
            out = mlstm_chunked(*a[:5], chunk=chunk,
                                init_state=a[5:] or None,
                                return_state=return_state)
            return (out[0], *out[1]) if return_state else out

        per_head, state = (0, 2), ((0, 1),) * 3
        out = on_local_blocks(
            local, args, (per_head,) * 5 + (state if init_state else ()),
            (per_head,) + (state if return_state else ()), q.shape[0],
            (q.shape[2],))
        return (out[0], tuple(out[1:])) if return_state else out
    b, s, h, d = q.shape
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, d) * d ** -0.5
    kc = k.reshape(b, nc, chunk, h, d)
    vc = v.reshape(b, nc, chunk, h, d)
    ic = i_log.reshape(b, nc, chunk, h)
    fc = f_log.reshape(b, nc, chunk, h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    neg = torch.full((), NEG, dtype=torch.float32, device=q.device)

    if init_state is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
        m = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    else:
        C, n, m = init_state

    def step(c, state):
        C, n, m = state
        qi, ki, vi, ii, fi = qc[:, c], kc[:, c], vc[:, c], ic[:, c], fc[:, c]
        cum = torch.cumsum(fi, dim=1)                         # (b, L, h)
        total = cum[:, -1]                                    # (b, h)
        # D[i, j] = cum_i - cum_j + i_log_j (i >= j)
        dm = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]
        dm = torch.where(causal, dm, neg)                     # (b, i, j, h)
        inter_log = cum + m[:, None, :]                       # (b, L, h)
        m_t = torch.maximum(dm.amax(dim=2), inter_log)        # (b, L, h)
        scores = torch.einsum("blhd,bjhd->bljh", qi, ki) \
            * torch.exp(dm - m_t[:, :, None, :])              # (b, i, j, h)
        inter = torch.exp(inter_log - m_t)[..., None]
        h_num = torch.einsum("bljh,bjhd->blhd", scores, vi) \
            + torch.einsum("blhd,bhde->blhe", qi, C) * inter
        n_t = torch.einsum("bljh,bjhd->blhd", scores, ki) + n[:, None] * inter
        qn = torch.einsum("blhd,blhd->blh", qi, n_t)
        denom = torch.maximum(qn.abs(), torch.exp(-m_t))
        out = h_num / denom[..., None]
        # end-of-chunk state
        a = total[:, None, :] - cum + ii                      # (b, L, h)
        m_next = torch.maximum(total + m, a.amax(dim=1))      # (b, h)
        w = torch.exp(a - m_next[:, None, :])                 # (b, L, h)
        decay = torch.exp(total + m - m_next)
        C = C * decay[..., None, None] \
            + torch.einsum("blh,blhd,blhe->bhde", w, ki, vi)
        n = n * decay[..., None] + torch.einsum("blh,blhd->bhd", w, ki)
        return (C, n, m_next), out

    # the last chunk is like the others unless autograd runs through them
    (C, n, m), outs = scan(step, (C, n, m), nc,
                           uniform=not torch.is_grad_enabled())
    out = torch.stack(outs, dim=1).reshape(b, s, h, d)
    if return_state:
        return out, (C, n, m)
    return out


def _mlstm_inputs(p, x, d_inner, n_heads):
    """The projection's q, k, v as (B, S, H, Dh) f32, z, and the gates."""
    dh = d_inner // n_heads
    q, k, v, z, i_raw, f_raw = _mlstm_split(linear(p["in_proj"], x),
                                            d_inner, n_heads)
    q = constrain(q, "act_inner")
    i_log, f_log = _gates(i_raw, f_raw)
    q, k, v = (split_last(t.float(), n_heads, dh) for t in (q, k, v))
    return q, k, v, z, i_log, f_log


def _mlstm_out(p, y, z, x):
    """y (B, S, H, Dh) f32 -> the gated norm and the out projection (the
    heads merged by ``merge_last``: 4 heads over a 16-way 'model' axis
    could not take back a gradient sharded along d_inner)."""
    y = merge_last(y, 2).to(x.dtype)
    return linear(p["out_proj"], rms_norm(p["norm"], y * F.silu(z)))


def mlstm_forward(p, x, *, d_inner, n_heads):
    """x: (B, S, d_model) -> (B, S, d_model)."""
    q, k, v, z, i_log, f_log = _mlstm_inputs(p, x, d_inner, n_heads)
    return _mlstm_out(p, mlstm_chunked(q, k, v, i_log, f_log), z, x)


def mlstm_prefill(p, x, cache, *, d_inner, n_heads):
    """The whole prompt in one chunkwise call, warm-started from
    ``cache``, which it leaves at the end-of-prompt state a per-token
    decode loop would reach, written in place. Returns (out, cache)."""
    q, k, v, z, i_log, f_log = _mlstm_inputs(p, x, d_inner, n_heads)
    y, (C, n, m) = mlstm_chunked(
        q, k, v, i_log, f_log,
        init_state=(cache["C"], cache["n"], cache["m"]), return_state=True)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    return _mlstm_out(p, y, z, x), cache


def mlstm_init_cache(batch, d_inner, n_heads, *, lead=(), device):
    lead, dh = tuple(lead), d_inner // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (batch, n_heads, dh, dh), **f32),
            "n": torch.zeros(lead + (batch, n_heads, dh), **f32),
            "m": torch.zeros(lead + (batch, n_heads), **f32)}


def mlstm_decode(p, x, cache, *, d_inner, n_heads):
    """One token, x (B, 1, d_model): one step of the stabilised
    recurrence C = f C + i k v^T, n = f n + i k. Updates ``cache`` in
    place (C, (B, H, Dh, Dh) f32, is read and written once a step);
    returns (out (B, 1, d_model), cache)."""
    b = x.shape[0]
    h, dh = n_heads, d_inner // n_heads
    q, k, v, z, i_raw, f_raw = _mlstm_split(linear(p["in_proj"], x)[:, 0],
                                            d_inner, h)
    i_log, f_log = _gates(i_raw, f_raw)
    q = q.float().reshape(b, h, dh) * dh ** -0.5
    k, v = k.float().reshape(b, h, dh), v.float().reshape(b, h, dh)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(f_log + m, i_log)
    f_s = torch.exp(f_log + m - m_new)
    i_s = torch.exp(i_log - m_new)
    C.mul_(f_s[..., None, None]).add_(
        i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n.mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    h_num = torch.einsum("bhd,bhde->bhe", q, C)
    qn = torch.einsum("bhd,bhd->bh", q, n)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    y = (h_num / denom[..., None]).reshape(b, 1, d_inner).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z[:, None]))
    return linear(p["out_proj"], y), cache


# ---------------------------------------------------------------------- #
# sLSTM
# ---------------------------------------------------------------------- #
def slstm_init(gen, d_model, n_heads, *, lead=(), dtype, device):
    """The input projection, the block-diagonal recurrent weights ``r``
    (H, Dh, 4 Dh), std 1/sqrt(Dh), the bias, the norm and the output
    projection, each with leading dims ``lead``."""
    lead, dh = tuple(lead), d_model // n_heads
    r = torch.randn(lead + (n_heads, dh, 4 * dh), generator=gen,
                    dtype=torch.float32, device=device) / dh ** 0.5
    return {
        "w_in": {"w": normal_init(gen, lead + (d_model, 4 * d_model), dtype,
                                  device)},
        "r": r.to(dtype),
        "b": torch.zeros(lead + (4 * d_model,), dtype=dtype, device=device),
        "norm": {"scale": torch.ones(lead + (d_model,), dtype=dtype,
                                     device=device)},
        "out_proj": {"w": normal_init(gen, lead + (d_model, d_model), dtype,
                                      device)},
    }


def _slstm_scan(p, u, h0, c0, n0, m0, n_heads):
    """u: (B, S, 4 d) f32 pre-activations from the input projection;
    h0, c0, n0, m0: (B, d) f32. One step a token, in order. The gates
    split the flattened (B, H 4 Dh) recurrent sum into four d-wide
    blocks after the head-major reshape, as the reference does, so one
    step mixes the heads: only the batch splits the recurrence. On
    DTensors the scan runs on each rank's local blocks (``local_map``)
    with the batch over the batch axes and d whole on every rank (the
    state gathered along d where the plan shards it); the reference's
    plan shards it over 'model'. Returns (hs (B, S, d), (h, c, n, m)
    after the last token)."""
    if any(is_dtensor(t) for t in (u, h0, c0, n0, m0)):
        row = (0, None)
        out = on_local_blocks(
            lambda u, h, c, n, m, r, bias: _slstm_steps(
                r, bias, u, h, c, n, m, n_heads),
            (u, h0, c0, n0, m0, p["r"], p["b"]),
            (row,) * 5 + ((None, None),) * 2, (row,) * 5, u.shape[0],
            None)
    else:
        out = _slstm_steps(p["r"], p["b"], u, h0, c0, n0, m0, n_heads)
    return out[0], tuple(out[1:])


def _slstm_steps(r, bias, u, h0, c0, n0, m0, n_heads):
    """``_slstm_scan`` on plain tensors: (hs, h, c, n, m)."""
    b, s, d4 = u.shape
    d = d4 // 4
    dh = d // n_heads
    r, bias = r.float(), bias.float()

    def step(t, state):
        hprev, c, n, m = state
        rec = torch.einsum("bhd,hde->bhe", hprev.reshape(b, n_heads, dh),
                           r).reshape(b, 4 * d)
        pre = u[:, t] + rec + bias
        i_raw, f_raw, z_raw, o_raw = torch.split(pre, d, dim=-1)
        f_log = -F.softplus(-f_raw)
        m_new = torch.maximum(f_log + m, i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(f_log + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_raw)
        n = f_s * n + i_s
        hprev = torch.sigmoid(o_raw) * c / torch.clamp_min(n, 1e-6)
        return (hprev, c, n, m_new), hprev

    state, hs = scan(step, (h0, c0, n0, m0), s,
                     uniform=not torch.is_grad_enabled())
    return (torch.stack(hs, dim=1), *state)


def slstm_forward(p, x, *, n_heads):
    b, s, d = x.shape
    u = linear(p["w_in"], x).float()
    z0 = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    hs, _ = _slstm_scan(p, u, z0, z0, z0 + 1e-6, z0, n_heads)
    y = rms_norm(p["norm"], hs.to(x.dtype))
    return linear(p["out_proj"], y)


def slstm_init_cache(batch, d_model, *, lead=(), device):
    """h, c, m zero and n = 1e-6, each (lead..., B, d_model) f32."""
    shape = tuple(lead) + (batch, d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.full(shape, 1e-6, **f32),
            "m": torch.zeros(shape, **f32)}


def slstm_decode(p, x, cache, *, n_heads):
    """Any number of tokens x (B, S, d_model) from the cached state: one
    token a step (it is also the sLSTM's prefill). Writes the state after
    the last token into ``cache`` in place; returns (out, cache)."""
    u = linear(p["w_in"], x).float()
    hs, state = _slstm_scan(p, u, cache["h"], cache["c"], cache["n"],
                            cache["m"], n_heads)
    for key, t in zip(("h", "c", "n", "m"), state):
        cache[key].copy_(t)
    y = rms_norm(p["norm"], hs.to(x.dtype))
    return linear(p["out_proj"], y), cache
