"""GQA attention (the reference's ``models/attention.py``): training, the
one-shot and suffix prefill that fill a decode cache, and one-token decode
against a linear or paged KV cache.

The attention cores go through ``kernels.ops``, which routes on the
tensor's device: on the card the flash-attention forward kernel (training,
one-shot and suffix prefill) and the flash-decode kernels (decode over a
linear or paged cache), on the CPU their plain PyTorch versions
(``kernels/ref.py``). The port has no switch between a kernel and its
plain version other than the device. Decode caches are linear (row t
holds position t) or, with a sliding window, a ring buffer (position t
in row t % rows), as in the reference; both decode through the same
flash-decode kernel (``attention_decode`` says why the ring can).
Whisper's cross-attention (``cross_attention``, non-causal, decoder
queries over encoder rows, Sk != Sq) takes the flash forward, and its
backward in training; its decode over the cached encoder rows the linear
flash-decode kernel at lengths ``cross_len``. The reference computes it
with plain softmax attention, which reaches no Pallas kernel.

Caches are written in place: a decode step writes one row per example
into the tensors it is given, and a prefill writes the prompt's rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.hooks import (as_dtensor, constrain, is_dtensor,
                                        merge_last, split_last)

from .layers import apply_rope, linear, normal_init


def attention_init(gen, d_model, n_heads, n_kv_heads, head_dim, *,
                   n_units, qkv_bias=False, dtype, device):
    """Stacked (n_units, d_in, d_out) projections, std 0.02; unstacked
    (d_in, d_out) for ``n_units=None`` (the hybrid's shared block)."""
    lead = () if n_units is None else (n_units,)

    def lin(d_in, d_out, bias):
        p = {"w": normal_init(gen, lead + (d_in, d_out), dtype, device)}
        if bias:
            p["b"] = torch.zeros(lead + (d_out,), dtype=dtype,
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


def _qkv(p, x, cos, sin, n_heads, n_kv_heads, head_dim):
    """Projections and RoPE: (B, S, H, D) q and (B, S, Hkv, D) k, v."""
    q = split_last(linear(p["wq"], x), n_heads, head_dim)
    k = split_last(linear(p["wk"], x), n_kv_heads, head_dim)
    v = split_last(linear(p["wv"], x), n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return constrain(q, "act_heads"), k, v


def _out(p, out):
    out = constrain(out, "act_heads")
    return linear(p["wo"], merge_last(out, 2))


def attention(p, x, cos, sin, *, n_heads, n_kv_heads, head_dim,
              causal=True, window=0):
    """Training attention over the whole sequence."""
    q, k, v = _qkv(p, x, cos, sin, n_heads, n_kv_heads, head_dim)
    groups = n_heads // n_kv_heads
    out = ops.flash_attention(q, _repeat_kv(k, groups),
                              _repeat_kv(v, groups), causal=causal,
                              window=window)
    return _out(p, out)


def attention_prefill(p, x, cos, sin, cache, *, n_heads, n_kv_heads,
                      head_dim, window=0):
    """One-shot prefill: attend over the whole prompt (the math of
    ``attention``, with the window) and write its K/V rows into a fresh
    decode cache {"k", "v"} (B, S_cache, Hkv, D): rows ``[0, S)`` of a
    linear cache (``window == 0``), or, for a ring buffer, the last
    min(S, S_cache) positions t into rows t % S_cache (distinct rows, so
    one indexed write)."""
    s = x.shape[1]
    q, k, v = _qkv(p, x, cos, sin, n_heads, n_kv_heads, head_dim)
    s_cache = cache["k"].shape[1]
    if window > 0:
        keep = min(s, s_cache)
        rows = torch.arange(s - keep, s, device=x.device) % s_cache
        cache["k"][:, rows] = k[:, s - keep:].to(cache["k"].dtype)
        cache["v"][:, rows] = v[:, s - keep:].to(cache["v"].dtype)
    else:
        if s > s_cache:
            raise ValueError(f"prompt of {s} rows does not fit a cache of "
                             f"{s_cache}")
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    _constrain_cache(cache)
    groups = n_heads // n_kv_heads
    out = ops.flash_attention(q, _repeat_kv(k, groups),
                              _repeat_kv(v, groups), causal=True,
                              window=window)
    return _out(p, out), cache


def attention_prefill_extend(p, x, cos, sin, cache, *, start, n_heads,
                             n_kv_heads, head_dim):
    """Suffix prefill: rows ``[0, start)`` of the linear cache are already
    filled (a shared-prefix gather); write rows ``[start, start + S)`` and
    attend the suffix queries over rows ``[0, start + S)`` with the flash
    forward at query offset ``start``. x: (B, S_suffix, D), the suffix's
    residual stream. Each output row reduces over the same keys, in the
    same order, as the same row of ``attention_prefill`` over the whole
    prompt."""
    s = x.shape[1]
    q, k, v = _qkv(p, x, cos, sin, n_heads, n_kv_heads, head_dim)
    s_cache = cache["k"].shape[1]
    if start + s > s_cache:
        raise ValueError(f"rows [{start}, {start + s}) do not fit a cache "
                         f"of {s_cache}")
    cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
    _constrain_cache(cache)
    groups = n_heads // n_kv_heads
    kk = _repeat_kv(cache["k"][:, :start + s], groups)
    vv = _repeat_kv(cache["v"][:, :start + s], groups)
    out = ops.flash_attention(q, kk, vv, causal=True, q_offset=start)
    return _out(p, out), cache


def attention_decode(p, x, cos, sin, cache, index, *, n_heads, n_kv_heads,
                     head_dim, window=0, pages=None):
    """One-token decode. x: (B, 1, D); ``index``: (B,) absolute decode
    positions. cache {"k", "v"}: (B, S_cache, Hkv, D), linear
    (``window == 0``, S_cache == max_len) or a ring buffer (S_cache ==
    min(window, max_len)). ``pages`` switches to the paged layout (linear
    only): cache k/v are shared pools (N_pages + 1, page_size, Hkv, D),
    the last page a scratch page, and ``pages`` is the (B, P) block table
    (-1 = unassigned).

    The ring runs on the linear flash-decode kernel. The reference keeps
    it off its kernel (``models/attention.py``, ``attention_decode``) and
    masks ring row j by the absolute position it holds,
    ``_ring_abs_pos``: valid iff that position is >= 0 and within the
    window. Since S_cache <= window, the window test always holds, and
    the position, index - ((index - j) mod S_cache), is >= 0 exactly for
    rows j < min(index + 1, S_cache): the valid rows are a prefix. So the
    kernel with lengths min(index + 1, S_cache) takes the same keys, and
    the same softmax over them, summed in row order.
    ``ref.ring_decode_ref`` keeps the reference's mask as the yardstick."""
    q, k, v = _qkv(p, x, cos, sin, n_heads, n_kv_heads, head_dim)
    if pages is not None:
        return _attention_decode_paged(p, q, k, v, cache, index, pages)
    s_cache = cache["k"].shape[1]
    row = index % s_cache if window else index
    _scatter_rows(cache["k"], k, row)
    _scatter_rows(cache["v"], v, row)
    _constrain_cache(cache)
    lengths = (index + 1).clamp_max(s_cache) if window else index + 1
    out = ops.flash_decode(q, cache["k"], cache["v"], lengths)
    return _out(p, out), cache


def _attention_decode_paged(p, q, k, v, cache, index, pages):
    """Paged one-token decode: write this step's K/V row into the pool
    page that owns position ``index``, then attend over the pages of the
    block table with the paged flash-decode kernel.

    Write-safety: an example whose table has no page for ``index`` (an
    idle engine slot, or an index past the table) writes into the scratch
    page, the pool's last, which no table entry names. No host sync."""
    b = q.shape[0]
    n_rows, page_size = cache["k"].shape[:2]
    scratch = n_rows - 1
    p_tab = pages.shape[1]
    ar = torch.arange(b, device=q.device)
    pidx, off = index // page_size, index % page_size
    pid = pages[ar, pidx.clamp(max=p_tab - 1)].long()
    pid = torch.where((pidx < p_tab) & (pid >= 0), pid,
                      torch.full_like(pid, scratch))
    cache["k"][pid, off] = k[:, 0].to(cache["k"].dtype)
    cache["v"][pid, off] = v[:, 0].to(cache["v"].dtype)
    out = ops.flash_decode_paged(q, cache["k"], cache["v"], pages,
                                 index + 1)
    return _out(p, out), cache


def _constrain_cache(cache) -> None:
    """The K/V cache at its ``kv_cache`` placements, in the cache dict
    (a linear or ring cache; the paged pools' layout has no entry)."""
    cache["k"] = constrain(cache["k"], "kv_cache")
    cache["v"] = constrain(cache["v"], "kv_cache")


def _scatter_rows(cache: torch.Tensor, new: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """In place, per example: cache[b, slots[b]] = new[b, 0]. cache
    (B, S, H, D), new (B, 1, H, D), slots (B,). A row at or past S is
    dropped (JAX drops an out-of-bounds scatter; CUDA would fault): the
    row is clamped and the old value written back, with no host sync.
    A DTensor cache is written on each rank's local block (DTensor has no
    in-place indexed write across placements)."""
    if is_dtensor(cache):
        return _scatter_rows_local(cache, new, slots)
    b, s = cache.shape[:2]
    ar = torch.arange(b, device=cache.device)
    row = slots.clamp(0, s - 1)
    inside = (slots >= 0) & (slots < s)
    cache[ar, row] = torch.where(inside[:, None, None],
                                 new[:, 0].to(cache.dtype), cache[ar, row])
    return cache


def _scatter_rows_local(cache, new, slots):
    """``_scatter_rows`` of a DTensor cache on each rank's block: ``new``
    and ``slots`` are brought to the cache's batch and head placements,
    and each slot is shifted by the block's first row, so that a rank
    whose block of a sequence-sharded cache (the long-decode mode) does
    not hold the row drops the write."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache.device_mesh, list(cache.placements)
    # the block's first row: DTensor splits a dim over its mesh dims in
    # mesh order, each into chunks of ceil(rows / size)
    first, rows = 0, cache.shape[1]
    for i, p in enumerate(pl):
        if p.is_shard(1):
            rows = -(-rows // mesh.size(i))
            first += mesh.get_coordinate()[i] * rows
    new_l = as_dtensor(new, mesh).redistribute(mesh, [
        Replicate() if p.is_shard(1) else p for p in pl]).to_local()
    slots_l = as_dtensor(slots, mesh).redistribute(mesh, [
        Shard(0) if p.is_shard(0) else Replicate() for p in pl]).to_local()
    _scatter_rows(cache.to_local(), new_l, slots_l - first)
    return cache


# ---------------------------------------------------------------------- #
# cross-attention (Whisper's decoder over the encoder's output)
# ---------------------------------------------------------------------- #
def cross_kv(p, enc, *, n_heads, head_dim):
    """The encoder rows' K and V: enc (B, Se, D) -> two (B, Se, H, Dh)."""
    return (split_last(linear(p["wk"], enc), n_heads, head_dim),
            split_last(linear(p["wv"], enc), n_heads, head_dim))


def cross_attention(p, x, k, v, *, n_heads, head_dim):
    """x: (B, S, D) decoder rows attending, non-causally, every encoder
    row of k/v (B, Se, H, Dh): training (differentiable in x, k and v)
    and prefill over the cached rows."""
    q = split_last(linear(p["wq"], x), n_heads, head_dim)
    return _out(p, ops.flash_attention(q, k, v, causal=False))


def cross_attention_decode(p, x, k, v, lengths, *, n_heads, head_dim):
    """One decoder token x (B, 1, D) over the cached encoder rows k/v
    (B, Se, H, Dh), the first ``lengths`` (B,) of them valid."""
    q = split_last(linear(p["wq"], x), n_heads, head_dim)
    return _out(p, ops.flash_decode(q, k, v, lengths))
