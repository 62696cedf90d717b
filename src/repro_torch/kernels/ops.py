"""Model-layout entry to the kernels (the reference's ``kernels/ops.py``).
Routing is by the tensor's device inside each kernel wrapper: CUDA
launches the kernel, CPU takes the plain version, whatever the autotuned
table says. Tiles are fixed at compile time (flash attention 64 x 64;
decode one block per (slot, kv head, split); the SSD chunk 64, its state
passes one block per (batch, head, 16 rows of P), its chunk passes one
per (batch, head, chunk)). What is tuned (``autotune.py``) is the one
run-time knob the kernels have: the decode split (256 key positions by
default). As in the reference, a call that leaves it at ``None`` (every
model call site does) takes the installed table's entry of its shape
class, else ``autotune.DEFAULTS``; an explicit argument always wins
(tests pin it). With no table installed (the state at import) nothing
is looked up; with one, a shape class's answer is kept after its first
call. No entry routes away from the kernel.

Training takes ``flash_attention`` (Whisper's cross-attention with
Sk != Sq, non-causal) and ``ssd``; serving takes ``flash_attention`` for
the prefill (also at a query offset), the two decode entries (head_dim
64, 112, 128 or 160; the linear one also serves a sliding window's ring
buffer and Whisper's cross-attention decode) and, for the hybrid's Mamba2
layers, ``ssd_prefill``, which continues a cached SSM state over the
prompt and returns the state decode goes on from.

DTensor inputs (sharded training, ``launch.train --distributed``; the
dry-run) reach the same wrappers through ``local_map``: each rank's
kernel runs on its local block, batch over the batch axes and heads over
'model' (the placements of ``act_heads`` for q and the output,
``kv_cache`` for a cache, ``act_inner`` for the SSD's channels),
sanitized together so that every operand agrees: a batch that the batch
axes do not divide, or heads (kv heads too, for decode) that 'model'
does not divide, stay whole on every rank. Attention and the SSD are
independent across batch rows and heads, so the local result is the
global one's block. A sequence-sharded cache (the long-decode mode) is
gathered along the sequence first. A plain tensor takes the route
above unchanged; a DTensor's local block on the card launches the
kernel like any CUDA tensor."""
from __future__ import annotations

import torch

from repro_torch.sharding.hooks import is_dtensor, on_local_blocks
from repro_torch.util.spans import span

from . import autotune
from . import flash_attention as _flash
from . import flash_decode as _decode
from . import ssd as _ssd


def _resolve(kind: str, s: int, d: int, dtype, overrides: dict,
             device) -> dict:
    """Merge explicit call-site arguments over the tuned entry of this
    shape class (honoured only on the card it was tuned on) over
    ``DEFAULTS``."""
    explicit = {k: v for k, v in overrides.items() if v is not None}
    if len(explicit) == len(overrides):
        return explicit
    base = dict(autotune.DEFAULTS[kind])
    table = autotune.get_table()
    entry = None if table is None else table.lookup(kind, s, d, dtype,
                                                    device)
    if entry is not None:
        base.update({k: entry[k] for k in base if k in entry})
    base.update(explicit)
    return base


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) (model layout) -> (B, Sq, H,
    D); any sequence lengths. Query row i sits at absolute position
    ``q_offset + i``. Differentiable in q, k, v when ``q_offset`` is 0
    and either Sk == Sq (training, one-shot prefill) or the attention is
    non-causal (Whisper's cross-attention, decoder rows over encoder
    rows); otherwise (the suffix prefill over a filled cache, causal
    attention with Sk != Sq) forward only. One span a call, on a DTensor
    path too: the local blocks re-enter below it."""
    with span("repro_torch.kernels.attention"):
        return _attention_call(q, k, v, causal, window, q_offset)


def _attention_call(q, k, v, causal, window, q_offset):
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        role = (0, 2)
        return on_local_blocks(
            lambda q, k, v: _attention_call(q, k, v, causal, window,
                                            q_offset),
            (q, k, v), (role, role, role), (role,), q.shape[0],
            (q.shape[2],))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if q_offset == 0 and (k.shape[1] == q.shape[1] or not causal):
        out = _flash.flash_attention(qt, kt, vt, causal=causal,
                                     window=window)
    else:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError("flash_attention with q_offset, or causal "
                             "with Sk != Sq, is forward only")
        out, _ = _flash.flash_attention_fwd(qt, kt, vt, causal=causal,
                                            window=window,
                                            q_offset=q_offset)
    return out.transpose(1, 2)


def flash_decode(q, k, v, lengths, *, split=None):
    """Single-query decode attention against a linear KV cache. q:
    (B, 1, H, D); k/v: (B, S_cache, H_kv, D), the kv heads NOT repeated
    (the reference takes them repeated to H; the result is the same);
    lengths: (B,) valid-prefix rows. Not differentiable (serving only).
    ``split``: key positions a block takes (None: the tuned split of this
    (head_dim, dtype), else 256)."""
    if any(is_dtensor(t) for t in (q, k, v, lengths)):
        return on_local_blocks(
            lambda q, k, v, n: flash_decode(q, k, v, n, split=split),
            (q, k, v, lengths), ((0, 2), (0, 2), (0, 2), (0, None)),
            ((0, 2),), q.shape[0], (q.shape[2], k.shape[2]))
    cfg = _resolve("flash_decode", k.shape[1], q.shape[3], q.dtype,
                   {"split": split}, q.device)
    return _decode.flash_decode(q, k, v, lengths, split=cfg["split"])


def flash_decode_paged(q, k_pool, v_pool, pages, lengths, *, split=None):
    """Paged decode attention. q: (B, 1, H, D); k_pool/v_pool:
    (N_pages, page_size, H_kv, D) shared pools; pages: (B, P) per-slot
    page table (-1 = unassigned); lengths: (B,) valid rows. Not
    differentiable (serving only). ``split`` as in :func:`flash_decode`;
    the tuned table gives both the same split at one (head_dim, dtype),
    so a paged cache and a dense one give the same bits."""
    if any(is_dtensor(t) for t in (q, k_pool, v_pool, pages, lengths)):
        # the pools are shared by every slot: heads only, never batch
        return on_local_blocks(
            lambda q, k, v, pg, n: flash_decode_paged(q, k, v, pg, n,
                                                      split=split),
            (q, k_pool, v_pool, pages, lengths),
            ((0, 2), (None, 2), (None, 2), (0, None), (0, None)),
            ((0, 2),), q.shape[0], (q.shape[2], k_pool.shape[2]))
    cfg = _resolve("flash_decode_paged", k_pool.shape[1], q.shape[3],
                   q.dtype, {"split": split}, q.device)
    return _decode.flash_decode_paged(q, k_pool, v_pool, pages, lengths,
                                      split=cfg["split"])


def ssd(x, dt, A, Bm, Cm):
    """Mamba2 SSD: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) ->
    y (B,S,H,P). Differentiable in all five operands; any S. No knob to
    tune (``autotune.DEFAULTS["ssd"]`` is empty). One span a call, as
    ``flash_attention``."""
    with span("repro_torch.kernels.ssd"):
        return _ssd_call(x, dt, A, Bm, Cm)


def _ssd_call(x, dt, A, Bm, Cm):
    if any(is_dtensor(t) for t in (x, dt, A, Bm, Cm)):
        return on_local_blocks(
            _ssd_call, (x, dt, A, Bm, Cm),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None)), ((0, 2),),
            x.shape[0], (x.shape[2],))
    return _ssd.ssd(x, dt, A, Bm, Cm)


def ssd_prefill(x, dt, A, Bm, Cm, init_state):
    """Mamba2 SSD continuing a state (the reference's ``ssd_chunked``
    with ``init_state`` and ``return_state``): operands as ``ssd`` plus
    init_state (B,H,P,N) -> (y (B,S,H,P), final state (B,H,P,N) f32).
    Forward only (serving); any S."""
    if any(is_dtensor(t) for t in (x, dt, A, Bm, Cm, init_state)):
        return on_local_blocks(
            ssd_prefill, (x, dt, A, Bm, Cm, init_state),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1)),
            ((0, 2), (0, 1)), x.shape[0], (x.shape[2],))
    return _ssd.ssd_prefill(x, dt, A, Bm, Cm, init_state)
