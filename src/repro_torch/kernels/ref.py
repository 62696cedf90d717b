"""Plain PyTorch versions of the kernels (the reference's
``kernels/ref.py``: ``attention_ref`` plus the backward the Pallas kernels
compute, ``flash_decode_ref`` and ``flash_decode_paged_ref``; ``ssd_ref``
plus the chunked forward and backward the SSD kernels compute, whole and
as the kernels' four passes).
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

from repro_torch.util.loops import scan


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
    """P = exp(s - lse) (masked entries 0) and dS = P * (dO V^T - delta),
    (B, H, Sq, Sk): q and dO have Sq rows, k and v Sk."""
    mask = score_mask(q.shape[2], causal=causal, window=window,
                      device=q.device, sk=k.shape[2])
    p = torch.exp(_scores(q, k, mask) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=True, window=0):
    """dQ = scale * dS K, (B, H, Sq, D) in q.dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, window)
    scale = q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype)


def attention_bwd_dkdv_ref(q, k, v, do, lse, delta, *, causal=True,
                           window=0):
    """dK = scale * dS^T Q and dV = P^T dO, (B, H, Sk, D) in k/v dtype."""
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


def ring_abs_pos(index: torch.Tensor, s_cache: int) -> torch.Tensor:
    """The reference's ``_ring_abs_pos``: the absolute position each ring
    row holds after the write at ``index % s_cache``. index: (B,) ->
    (B, S_cache); row j holds index - ((index - j) mod S_cache)."""
    rows = torch.arange(s_cache, device=index.device)[None, :]
    back = (index[:, None] % s_cache - rows) % s_cache
    return index[:, None] - back


def ring_decode_ref(q, k, v, index, window):
    """The reference's decode over a sliding window's ring buffer, its
    mask as written: row j is valid iff the position it holds (``
    ring_abs_pos``) is >= 0, <= index and > index - window. q: (B, 1, H,
    D); k/v: (B, S_cache, H, D) with kv heads already repeated; index:
    (B,) the decode positions, already written. The model's path runs
    the linear decode kernel with lengths min(index + 1, S_cache)
    instead (``models/attention.attention_decode``); this is the
    yardstick it is held to. Returns (B, 1, H, D) in q.dtype."""
    d = q.shape[-1]
    pos = ring_abs_pos(index, k.shape[1])
    valid = ((pos <= index[:, None]) & (pos > index[:, None] - window)
             & (pos >= 0))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * d ** -0.5
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------- #
# Mamba2 SSD
# ---------------------------------------------------------------------- #
def _wide(t: torch.Tensor) -> torch.dtype:
    """f32 arithmetic, or f64 when the caller hands in f64 (the tests'
    oracle)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ssd_ref(x, dt, A, Bm, Cm):
    """Sequential Mamba2/SSD recurrence (the obviously-correct oracle).

    x: (B,S,H,P), dt: (B,S,H), A: (H,) (<0), Bm/Cm: (B,S,N).
    h_t = exp(A*dt_t) h_{t-1} + dt_t * x_t (outer) B_t ;  y_t = C_t . h_t
    Returns y (B,S,H,P) in x's dtype."""
    wide = _wide(x)
    b, s, h, p = x.shape
    xw, dtw, bw, cw = (t.to(wide) for t in (x, dt, Bm, Cm))
    aw = A.to(wide)
    state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=wide, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(aw[None, :] * dtw[:, t])                  # (b,h)
        state = da[..., None, None] * state + torch.einsum(
            "bh,bn,bhp->bhpn", dtw[:, t], bw[:, t], xw[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cw[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def _ssd_chunks(x, dt, A, Bm, Cm, chunk: int):
    """Inputs cut into chunks in the arithmetic type: lists over chunks of
    x (b,L,h,p), dt and dA = A dt (b,L,h), Bm/Cm (b,L,n)."""
    b, s, h, p = x.shape
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    wide = _wide(x)
    dtw = dt.to(wide)
    dA = A.to(wide)[None, None, :] * dtw
    return [t.to(wide).split(chunk, dim=1) for t in (x, dtw, dA, Bm, Cm)]


def _chunk_fwd(xc, dtc, dAc, bc, cc):
    """Forward intermediates of one chunk (the kernel's recompute): cum,
    total, the masked decay, scores, m = scores * decay."""
    L = xc.shape[1]
    cum = torch.cumsum(dAc, dim=1)                               # (b,L,h)
    total = cum[:, -1]                                           # (b,h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xc.device))
    # mask the exponent before exp: i < j entries are exp of a positive
    diff = cum[:, :, None, :] - cum[:, None, :, :]               # (b,i,j,h)
    decay = torch.exp(torch.where(causal[None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    scores = torch.einsum("bin,bjn->bij", cc, bc)
    return cum, total, decay, scores, scores[..., None] * decay


def _init_state(init_state, x, n, wide):
    """The state entering the first chunk, (B,H,P,N) in ``wide``: the
    caller's, or 0."""
    b, _, h, p = x.shape
    if init_state is None:
        return torch.zeros((b, h, p, n), dtype=wide, device=x.device)
    return init_state.to(wide)


def _outputs(main, extra):
    """``main`` alone, or a tuple of it and the outputs asked for."""
    return (main, *extra) if extra else main


def ssd_fwd_ref(x, dt, A, Bm, Cm, *, chunk: int, return_states=False,
                init_state=None, return_final=False):
    """The SSD chunk scan at an explicit ``chunk`` (S a multiple of it):
    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) -> y (B,S,H,P) in x's
    dtype [, each chunk's input state (B,H,nc,P,N)] [, the state leaving
    the last chunk (B,H,P,N)], states in the arithmetic type: f32, or f64
    for f64 inputs. The scan starts from ``init_state`` (B,H,P,N), or 0.
    What the forward kernel computes, in the reference's ``_ssd_kernel``
    order."""
    xs, dts, dAs, bs, cs = _ssd_chunks(x, dt, A, Bm, Cm, chunk)

    def step(c, state):
        xc, dtc, dAc, bc, cc = xs[c], dts[c], dAs[c], bs[c], cs[c]
        cum, total, _, _, m = _chunk_fwd(xc, dtc, dAc, bc, cc)
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xc * dtc[..., None])
        y_inter = torch.einsum("bin,bhpn->bihp", cc, state) \
            * torch.exp(cum)[..., None]
        w = torch.exp(total[:, None] - cum) * dtc                # (b,L,h)
        s_local = torch.einsum("blhp,bln->bhpn", xc * w[..., None], bc)
        out = torch.exp(total)[..., None, None] * state + s_local
        return out, (state, y_intra + y_inter)

    state, outs = scan(step, _init_state(init_state, x, Bm.shape[-1],
                                         xs[0].dtype), len(xs), uniform=True)
    states, ys = zip(*outs)
    y = torch.cat(ys, dim=1).to(x.dtype)
    extra = ([torch.stack(states, dim=2)] if return_states else []) \
        + ([state] if return_final else [])
    return _outputs(y, extra)


def _bwd_chunk(xc, dtc, dAc, bc, cc, s0, ds1, dyc):
    """Backward of one chunk (the reference's ``_ssd_bwd_kernel`` body)
    from its input state s0 and the d(output state) ds1. Returns dx, ddt
    (the direct part), d(dA), the per-head dB, dC partials and
    d(input state)."""
    cum, total, decay, scores, m = _chunk_fwd(xc, dtc, dAc, bc, cc)
    xdt = xc * dtc[..., None]
    expcum = torch.exp(cum)
    etc = torch.exp(total[:, None] - cum)
    w = etc * dtc
    et = torch.exp(total)
    # state update: state_out = exp(total) s0 + (x w)^T B
    ds0 = et[..., None, None] * ds1
    dtotal = et * (ds1 * s0).sum(dim=(-2, -1))                   # (b,h)
    g = torch.einsum("blhp,bhpn->blhn", xc, ds1)
    db = w[..., None] * g
    dxw = torch.einsum("bln,bhpn->blhp", bc, ds1)
    dx = w[..., None] * dxw
    dw = (xc * dxw).sum(dim=-1)                                  # (b,L,h)
    ddt = dw * etc
    dcum = -(dw * w)
    dtotal = dtotal + (dw * w).sum(dim=1)
    # inter-chunk: y_inter = (C s0^T) exp(cum)
    dyec = dyc * expcum[..., None]
    y_inter = torch.einsum("bin,bhpn->bihp", cc, s0) * expcum[..., None]
    dc = torch.einsum("bihp,bhpn->bihn", dyec, s0)
    ds0 = ds0 + torch.einsum("bihp,bin->bhpn", dyec, cc)
    dcum = dcum + (dyc * y_inter).sum(dim=-1)
    # intra-chunk: y_intra = (scores * decay) @ (x dt)
    dm = torch.einsum("bihp,bjhp->bijh", dyc, xdt)
    dxdt = torch.einsum("bijh,bihp->bjhp", m, dyc)
    dscores = dm * decay
    dc = dc + torch.einsum("bijh,bjn->bihn", dscores, bc)
    db = db + torch.einsum("bijh,bin->bjhn", dscores, cc)
    ddiff = dm * scores[..., None] * decay   # masked: decay 0 -> 0
    dcum = dcum + ddiff.sum(dim=2) - ddiff.sum(dim=1)
    dx = dx + dxdt * dtc[..., None]
    ddt = ddt + (dxdt * xc).sum(dim=-1)
    # total = cum[-1], cum = cumsum(dA): d(dA) is the inclusive suffix sum
    # of dcum
    dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + dtotal[:, None]], dim=1)
    csum = torch.cumsum(dcum, dim=1)
    dda = csum[:, -1:] - csum + dcum
    return dx, ddt, dda, db, dc, ds0


def ssd_bwd_ref(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """The reverse-chunk SSD backward (the reference's ``_ssd_bwd_kernel``
    math) carrying d(state) from the last chunk to the first. Inputs as
    ``ssd_fwd_ref`` plus its ``states`` and the cotangent dy (B,S,H,P).
    Returns the kernel's raw outputs: dx (B,S,H,P) in x's dtype; ddt (the
    direct part), d(dA) (B,S,H) and the per-head dB, dC partials
    (B,S,H,N), all in the arithmetic type (f32; f64 for f64 inputs).
    ``ssd.combine_grads`` finishes the chain rule."""
    xs, dts, dAs, bs, cs = _ssd_chunks(x, dt, A, Bm, Cm, chunk)
    dys = dy.to(xs[0].dtype).split(chunk, dim=1)
    s0s = states.to(xs[0].dtype).unbind(2)
    nc = len(xs)

    def step(j, ds1):
        c = nc - 1 - j                                   # last chunk first
        *grads, ds0 = _bwd_chunk(xs[c], dts[c], dAs[c], bs[c], cs[c],
                                 s0s[c], ds1, dys[c])
        return ds0, grads

    # from d(final state) = 0
    _, outs = scan(step, torch.zeros_like(s0s[0]), nc, uniform=True)
    dx, ddt, dda, db, dc = (torch.cat(parts[::-1], dim=1)
                            for parts in zip(*outs))
    return dx.to(x.dtype), ddt, dda, db, dc


# The four passes of the kernels (``csrc/ssd.cu``), each with the inputs and
# outputs of its C entry. The chunk passes fold the chunks into the batch
# (every chunk is independent once its state is given); the state passes
# compute every chunk's local term at once and then run the recurrence.
def _fold(t, chunk: int, wide):
    """(B, S, ...) -> (B nc, chunk, ...) in the arithmetic type."""
    b, s = t.shape[:2]
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    return t.to(wide).reshape(b * (s // chunk), chunk, *t.shape[2:])


def _fold_states(st, wide):
    """(B, H, nc, P, N) -> (B nc, H, P, N)."""
    b, h, nc, p, n = st.shape
    return st.to(wide).transpose(1, 2).reshape(b * nc, h, p, n)


def _unfold(t, b: int):
    """(B nc, chunk, ...) -> (B, S, ...)."""
    return t.reshape(b, -1, *t.shape[2:])


def _cum(dt, A, chunk: int, wide):
    """Folded dt, cumsum(A dt) within each chunk, and its total."""
    dtc = _fold(dt, chunk, wide)
    cum = torch.cumsum(A.to(wide)[None, None, :] * dtc, dim=1)
    return dtc, cum, cum[:, -1]


def _recurrence(local, total, b: int, reverse: bool, init=None):
    """s_0 = init (default 0), s_{c+1} = exp(total_c) s_c + local_c over
    the chunks (in reverse order for the backward); returns the s entering
    each chunk, (B, H, nc, P, N), and the s leaving the last, (B, H, P,
    N)."""
    nc = local.shape[0] // b
    local = local.reshape(b, nc, *local.shape[1:])
    et = torch.exp(total).reshape(b, nc, -1)[..., None, None]
    state = torch.zeros_like(local[:, 0]) if init is None else init
    out = [None] * nc
    for c in (reversed(range(nc)) if reverse else range(nc)):
        out[c] = state
        state = et[:, c] * state + local[:, c]
    return torch.stack(out, dim=2), state


def ssd_fwd_state_ref(x, dt, A, Bm, *, chunk: int, init_state=None,
                      return_final=False):
    """The forward state pass: each chunk's input state (B,H,nc,P,N) [and
    the state leaving the last chunk (B,H,P,N)] in the arithmetic type,
    from x (B,S,H,P), dt (B,S,H), A (H,), Bm (B,S,N), starting from
    ``init_state`` (B,H,P,N), or 0."""
    wide = _wide(x)
    dtc, cum, total = _cum(dt, A, chunk, wide)
    w = torch.exp(total[:, None] - cum) * dtc                    # (b',L,h)
    local = torch.einsum("blhp,bln->bhpn",
                         _fold(x, chunk, wide) * w[..., None],
                         _fold(Bm, chunk, wide))
    init = _init_state(init_state, x, Bm.shape[-1], wide)
    states, final = _recurrence(local, total, x.shape[0], reverse=False,
                                init=init)
    return _outputs(states, [final] if return_final else [])


def ssd_fwd_chunk_ref(x, dt, A, Bm, Cm, states, *, chunk: int):
    """The forward chunk pass: y (B,S,H,P) in x's dtype from the inputs
    and each chunk's input state (B,H,nc,P,N)."""
    wide = _wide(x)
    xc, dtc, bc, cc = (_fold(t, chunk, wide) for t in (x, dt, Bm, Cm))
    dAc = A.to(wide)[None, None, :] * dtc
    cum, _, _, _, m = _chunk_fwd(xc, dtc, dAc, bc, cc)
    y_intra = torch.einsum("bijh,bjhp->bihp", m, xc * dtc[..., None])
    y_inter = torch.einsum("bin,bhpn->bihp", cc,
                           _fold_states(states, wide)) \
        * torch.exp(cum)[..., None]
    return _unfold(y_intra + y_inter, x.shape[0]).to(x.dtype)


def ssd_bwd_state_ref(dt, A, Cm, dy, *, chunk: int):
    """The backward state pass: each chunk's d(output state)
    (B,H,nc,P,N) in the arithmetic type, from dt (B,S,H), A (H,), Cm
    (B,S,N) and the cotangent dy (B,S,H,P)."""
    wide = _wide(dy)
    dtc, cum, total = _cum(dt, A, chunk, wide)
    dyec = _fold(dy, chunk, wide) * torch.exp(cum)[..., None]
    local = torch.einsum("bihp,bin->bhpn", dyec, _fold(Cm, chunk, wide))
    return _recurrence(local, total, dy.shape[0], reverse=True)[0]


def ssd_bwd_chunk_ref(x, dt, A, Bm, Cm, states, dstates, dy, *,
                      chunk: int):
    """The backward chunk pass: ``ssd_bwd_ref``'s raw outputs from each
    chunk's input state and d(output state) (B,H,nc,P,N)."""
    wide = _wide(x)
    xc, dtc, bc, cc, dyc = (_fold(t, chunk, wide)
                            for t in (x, dt, Bm, Cm, dy))
    dAc = A.to(wide)[None, None, :] * dtc
    *raw, _ = _bwd_chunk(xc, dtc, dAc, bc, cc, _fold_states(states, wide),
                         _fold_states(dstates, wide), dyc)
    dx, ddt, dda, db, dc = (_unfold(t, x.shape[0]) for t in raw)
    return dx.to(x.dtype), ddt, dda, db, dc
