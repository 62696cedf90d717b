"""Flash decode on the card: wrappers around the CUDA kernels of
``csrc/flash_decode.cu`` (linear cache and paged pool), split-K over
(slot, kv head): a block reads ``SPLIT`` key positions (a constant of
the kernel source) of one kv head
once for all the query heads it serves, and a second kernel merges a
slot's splits in split order. The splits a slot has depend on its length
alone, so a row's bits do not depend on the batch, the table width or the
cache's capacity.

Model layout throughout: q (B, 1, H, D); the linear cache (B, S, H_kv, D)
and the pools (N, page_size, H_kv, D) hold the kv heads once, and query
head h reads kv head h // (H // H_kv). bf16 or f32, head_dim 64, 112, 128
or 160.
Each wrapper routes on the device of the tensor it is given: a CPU tensor
takes the plain PyTorch version (``ref.py``, with the reference's
repeated-kv signature); a CUDA tensor launches the kernel or raises,
never falls back. ``LAUNCHES`` counts the launches of each wrapper, one
per call (the split kernel and its merge), and only those.

Replaces the reference's ``kernels/flash_decode.py`` (``flash_decode`` and
``flash_decode_paged``). The reference pads the cache to its block; these
kernels mask the ragged edge themselves, with the same result.
"""
from __future__ import annotations

from typing import Dict

import torch

from .flash_attention import _DTYPES, _route
from .ref import flash_decode_paged_ref, flash_decode_ref

LAUNCHES: Dict[str, int] = {"flash_decode": 0, "flash_decode_paged": 0}
HEAD_DIMS = (64, 112, 128, 160)


def _workspace(b: int, h: int, d: int, capacity: int, device):
    """f32 scratch for every (slot, head, split)'s (acc, m, l), for a
    cache of ``capacity`` key positions a slot; the kernel source sizes
    it (``repro_flash_decode_workspace``), as it owns the split size."""
    from .build import library
    n = library("flash_decode").lib.repro_flash_decode_workspace(
        b, h, d, capacity)
    if n < 0:
        raise ValueError(f"flash decode: workspace for B {b}, H {h}, "
                         f"D {d}, capacity {capacity} does not fit an int")
    return torch.empty(n, dtype=torch.float32, device=device)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=2)


def _check(name: str, q, k, v, lengths) -> int:
    """Validate the kernel's inputs; returns the kv-head count."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    b, one, h, d = q.shape
    if one != 1 or d not in HEAD_DIMS:
        raise ValueError(f"{name}: expected q (B, 1, H, D) with D in "
                         f"{HEAD_DIMS}, got {tuple(q.shape)}")
    h_kv = k.shape[2]
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != d or h % h_kv:
        raise ValueError(f"{name}: cache {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not fit q {tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)}, "
                         f"expected ({b},)")
    for key, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and "
                             "16-byte aligned")
        if key in ("k", "v") and t.dtype != q.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, q {q.dtype}")
    return h_kv


def _launch(entry: str, *args) -> None:
    from .build import launch
    launch("flash_decode", entry, *args)


def flash_decode(q, k, v, lengths) -> torch.Tensor:
    """q: (B, 1, H, D); k/v: (B, S, H_kv, D); lengths: (B,) int, valid
    rows kpos < lengths[b] (clamped to S) -> (B, 1, H, D) in q.dtype."""
    if not _route(q):
        groups = q.shape[2] // k.shape[2]
        return flash_decode_ref(q, _repeat_kv(k, groups),
                                _repeat_kv(v, groups), lengths)
    lengths = lengths.to(torch.int32)
    h_kv = _check("flash_decode", q, k, v, lengths)
    b, _, h, d = q.shape
    if k.shape[0] != b:
        raise ValueError(f"flash_decode: cache batch {k.shape[0]}, q {b}")
    o = torch.empty_like(q)
    work = _workspace(b, h, d, k.shape[1], q.device)
    _launch("repro_flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), work.data_ptr(), b, h, h_kv,
            k.shape[1], d, _DTYPES[q.dtype], d ** -0.5)
    LAUNCHES["flash_decode"] += 1
    return o


def flash_decode_paged(q, k_pool, v_pool, pages, lengths) -> torch.Tensor:
    """q: (B, 1, H, D); k_pool/v_pool: (N, page_size, H_kv, D); pages:
    (B, P) int block table, -1 = unassigned; lengths: (B,) int ->
    (B, 1, H, D) in q.dtype. The kernel reads the table only for the
    pages a slot's length covers and skips -1 entries."""
    if not _route(q):
        return flash_decode_paged_ref(q, k_pool, v_pool, pages, lengths)
    lengths = lengths.to(torch.int32)
    pages = pages.to(torch.int32)
    h_kv = _check("flash_decode_paged", q, k_pool, v_pool, lengths)
    b, _, h, d = q.shape
    if pages.dim() != 2 or pages.shape[0] != b or not pages.is_contiguous():
        raise ValueError(f"flash_decode_paged: pages {tuple(pages.shape)} "
                         f"must be a contiguous ({b}, P) table")
    if pages.device != q.device:
        raise ValueError(f"flash_decode_paged: pages on {pages.device}, "
                         f"q on {q.device}")
    o = torch.empty_like(q)
    page_size, p_tab = k_pool.shape[1], pages.shape[1]
    work = _workspace(b, h, d, p_tab * page_size, q.device)
    _launch("repro_flash_decode_paged", q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), pages.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), work.data_ptr(), b, h, h_kv, page_size, p_tab, d,
            _DTYPES[q.dtype], d ** -0.5)
    LAUNCHES["flash_decode_paged"] += 1
    return o
