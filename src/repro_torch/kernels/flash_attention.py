"""Flash attention on the card: wrappers around the CUDA kernels of
``csrc/flash_attention.cu`` (forward, dQ, dK/dV) and the
``torch.autograd.Function`` that joins them.

Layout is the kernels' (B, H, S, D), contiguous and 16-byte aligned,
bf16 or f32, head_dim 64, 112 (zamba2-7b's shared block), 128 or 160
(stablelm-12b). In bf16 all three run on the tensor cores (``mma.sync``,
``ldmatrix``, ``cp.async``; at head_dim 160 the one-pass dK/dV spills,
and is still faster than a dV pass then a dK pass); in f32 all three run
the scalar design, which holds them to 1e-5 of the plain version. Each
wrapper routes on the device of the tensor it is given: a CPU tensor
takes the plain PyTorch version (``ref.py``); a CUDA tensor launches the
kernel or raises, never falls back. ``LAUNCHES`` counts the kernel
launches of each wrapper, and only those.

Replaces the reference's ``kernels/flash_attention.py``
(``flash_attention_fwd`` / ``flash_attention_bwd`` and their
``custom_vjp``). The reference pads S to a block multiple; these kernels
mask the ragged edge themselves, with the same result. All three take
Sq query rows over Sk key rows: training has Sk == Sq, Whisper's
cross-attention (non-causal) Sq decoder rows over Sk encoder rows, and
the suffix prefill (forward only) a query offset.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.util.spans import span

from .ref import (attention_bwd_dkdv_ref, attention_bwd_dq_ref,
                  attention_ref)

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkdv": 0}
HEAD_DIMS = (64, 112, 128, 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name: str, ref: torch.Tensor, **tensors) -> None:
    """Each of ``tensors`` has ``ref``'s (B, H, S, D) shape, or its
    (B, H, S) for a row vector (lse, delta, f32), dtype and device, and
    is contiguous and aligned."""
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        "(float32 or bfloat16)")
    if ref.dim() != 4 or ref.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: expected (B, H, S, D) with D in "
                         f"{HEAD_DIMS}, got {tuple(ref.shape)}")
    b, h, s, _ = ref.shape
    for key, t in tensors.items():
        want = ref.shape if t.dim() == 4 else (b, h, s)
        want_dtype = ref.dtype if t.dim() == 4 else torch.float32
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, "
                             f"q on {ref.device}")
        if tuple(t.shape) != tuple(want) or t.dtype != want_dtype:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {tuple(want)} "
                             f"{want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dim() == 4 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned "
                             "(the kernels copy rows 16 bytes at a time)")


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no flash-attention path for device {t.device}")


def _launch(entry: str, counter: str, *args) -> None:
    from .build import launch
    launch("flash_attention", entry, *args)
    LAUNCHES[counter] += 1


def _check_kv(name: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """k and v (k's shape) against q: the same B, H and D, dtype and
    device; any number of rows."""
    _check(name, k, k=k, v=v)
    if (k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or k.dtype != q.dtype or k.device != q.device):
        raise ValueError(f"{name}: k {tuple(k.shape)} {k.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")


def _common(q, k, causal, window):
    b, h, sq, d = q.shape
    return (b * h, sq, k.shape[2], d, _DTYPES[q.dtype], int(bool(causal)),
            int(window), d ** -0.5)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, q_offset=0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Sq, D) q, (B, H, Sk, D) k/v -> O (B, H, Sq, D) in q's dtype,
    lse (B, H, Sq) f32. Query row i sits at absolute position
    ``q_offset + i``: training has Sk == Sq and ``q_offset`` 0, the
    suffix prefill attends its rows over the prefix and itself."""
    if not _route(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    _check("flash_attention_fwd", q, q=q)
    _check_kv("flash_attention_fwd", q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention_fwd: q_offset {q_offset} < 0")
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("repro_flash_fwd", "flash_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h, sq,
            k.shape[2], int(q_offset), d, _DTYPES[q.dtype],
            int(bool(causal)), int(window), d ** -0.5)
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           window=0) -> torch.Tensor:
    """dQ from the recomputed P = exp(s - lse) and delta = rowsum(dO*O).
    q, dO: (B, H, Sq, D); k, v: (B, H, Sk, D); lse, delta: (B, H, Sq)."""
    if not _route(q):
        return attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                    window=window)
    _check("flash_attention_bwd_dq", q, q=q, do=do, lse=lse, delta=delta)
    _check_kv("flash_attention_bwd_dq", q, k, v)
    dq = torch.empty_like(q)
    _launch("repro_flash_bwd_dq", "flash_bwd_dq", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *_common(q, k, causal, window))
    return dq


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True,
                             window=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV (B, H, Sk, D) from the same recompute, looping over q
    tiles."""
    if not _route(q):
        return attention_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                      causal=causal, window=window)
    _check("flash_attention_bwd_dkdv", q, q=q, do=do, lse=lse, delta=delta)
    _check_kv("flash_attention_bwd_dkdv", q, k, v)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("repro_flash_bwd_dkdv", "flash_bwd_dkdv", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_common(q, k, causal, window))
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward kernel plus the dQ and dK/dV backward kernels. Under
    activation checkpointing the forward runs twice per layer and
    micro-batch: once in the forward pass and once in the recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        with span("repro_torch.kernels.attention_bwd"):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.contiguous()
            # delta_i = rowsum(dO_i * O_i): elementwise, outside the kernels
            delta = (do.float() * o.float()).sum(dim=-1)
            kw = dict(causal=ctx.causal, window=ctx.window)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0) -> torch.Tensor:
    """Trainable flash attention in (B, H, S, D) layout: q (B, H, Sq, D)
    over k/v (B, H, Sk, D), any Sq and Sk; query row i at position i."""
    return FlashAttention.apply(q, k, v, causal, window)
