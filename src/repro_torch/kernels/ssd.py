"""Mamba2 SSD chunk scan on the card: wrappers around the CUDA kernels of
``csrc/ssd.cu`` (the forward, optionally keeping each chunk's input
state, and the reverse-chunk backward) and the ``torch.autograd.Function``
that joins them.

Model layout throughout: x (B,S,H,P), dt (B,S,H), A (H,) f32, Bm/Cm
(B,S,N). x, dt, Bm and Cm share one dtype, f32 or bf16; the arithmetic
is f32, y and dx come back in x's dtype. P is 64 or 128, N is 16 or 64,
and the kernels take S a multiple of ``CHUNK``: ``ssd`` pads S with
dt = 0, which makes the pad an exact no-op (dA = 0, so the carried state
passes through, and x dt = 0 adds nothing). Each wrapper routes on the
device of the tensor it is given: a CPU tensor takes the plain PyTorch
version (``ref.py``) at the same chunk; a CUDA tensor launches the kernel
or raises, never falls back. ``LAUNCHES`` counts the kernel launches of
each wrapper, and only those.

Replaces the reference's ``kernels/mamba2_scan.py`` (``ssd_fwd``,
``ssd_bwd``, their ``custom_vjp`` and the padded entry ``ssd``). The
reference's chunk is 256; its backward's (256, 256) f32 tiles do not fit
a Hopper block's 227 KB of shared memory, so the chunk here is 64. The
chunk changes results only by f32 rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import _DTYPES
from .ref import ssd_bwd_ref, ssd_fwd_ref

LAUNCHES: Dict[str, int] = {"ssd_fwd": 0, "ssd_bwd": 0}
CHUNK = 64
HEAD_DIMS = (64, 128)           # P
STATE_DIMS = (16, 64)           # N


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no SSD path for device {t.device}")


def _check(name: str, x, dt, A, Bm, Cm, **extra) -> Tuple[int, ...]:
    """Validate the kernel's inputs; returns (B, S, H, P, N)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"{name}: expected x (B,S,H,P) and Bm (B,S,N), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"{name}: P = {p}, N = {n}; the kernels take P in "
                         f"{HEAD_DIMS} and N in {STATE_DIMS}")
    if s % CHUNK:
        raise ValueError(f"{name}: S = {s} is not a multiple of the chunk "
                         f"{CHUNK}")
    want = {"dt": ((b, s, h), x.dtype), "A": ((h,), torch.float32),
            "Bm": ((b, s, n), x.dtype), "Cm": ((b, s, n), x.dtype),
            "states": ((b, h, s // CHUNK, p, n), torch.float32),
            "dy": (tuple(x.shape), x.dtype)}
    for key, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                   *extra.items()):
        if key != "x" and (tuple(t.shape), t.dtype) != want[key]:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {want[key][0]} {want[key][1]}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return b, s, h, p, n


def _launch(entry: str, counter: str, *args) -> None:
    from .build import launch
    launch("ssd", entry, *args)
    LAUNCHES[counter] += 1


def ssd_fwd(x, dt, A, Bm, Cm, *, return_states=False):
    """y (B,S,H,P) in x's dtype [, each chunk's input state (B,H,nc,P,N)
    f32, the backward's residual]. S a multiple of ``CHUNK``."""
    if not _route(x):
        return ssd_fwd_ref(x, dt, A, Bm, Cm, chunk=CHUNK,
                           return_states=return_states)
    b, s, h, p, n = _check("ssd_fwd", x, dt, A, Bm, Cm)
    y = torch.empty_like(x)
    states = (torch.empty((b, h, s // CHUNK, p, n), dtype=torch.float32,
                          device=x.device) if return_states else None)
    _launch("repro_ssd_fwd", "ssd_fwd", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            None if states is None else states.data_ptr(), b, s, h, p, n,
            _DTYPES[x.dtype])
    return (y, states) if return_states else y


def ssd_bwd(x, dt, A, Bm, Cm, states, dy):
    """The raw backward: dx (B,S,H,P) in x's dtype; the direct part of
    ddt, d(dA) (B,S,H) and the per-head dB, dC partials (B,S,H,N), f32."""
    if not _route(x):
        return ssd_bwd_ref(x, dt, A, Bm, Cm, states, dy, chunk=CHUNK)
    b, s, h, p, n = _check("ssd_bwd", x, dt, A, Bm, Cm, states=states,
                           dy=dy)
    dx = torch.empty_like(x)
    ddt, dda = (torch.empty((b, s, h), dtype=torch.float32, device=x.device)
                for _ in range(2))
    dbh, dch = (torch.empty((b, s, h, n), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    _launch("repro_ssd_bwd", "ssd_bwd", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), states.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dda.data_ptr(),
            dbh.data_ptr(), dch.data_ptr(), b, s, h, p, n, _DTYPES[x.dtype])
    return dx, ddt, dda, dbh, dch


def combine_grads(x, dt, A, Bm, Cm, raw):
    """The chain rule outside the kernel, as the reference's ``ssd_bwd``:
    dA = A dt gives ddt += d(dA) A and dA_total = sum d(dA) dt; Bm and Cm
    are shared by the heads, so their partials are summed over heads."""
    dx, ddt, dda, dbh, dch = raw
    ddt = ddt + dda * A.to(dda.dtype)
    d_a = (dda * dt.to(dda.dtype)).sum(dim=(0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), d_a.to(A.dtype),
            dbh.sum(dim=2).to(Bm.dtype), dch.sum(dim=2).to(Cm.dtype))


class SSD(torch.autograd.Function):
    """Forward kernel (keeping each chunk's input state) plus the
    backward kernel. Under activation checkpointing the forward runs
    twice per layer and micro-batch: once in the forward pass and once
    in the recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, states = ssd_fwd(x, dt, A, Bm, Cm, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        raw = ssd_bwd(x, dt, A, Bm, Cm, states, dy.contiguous())
        return combine_grads(x, dt, A, Bm, Cm, raw)


def ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Trainable Mamba2 SSD in model layout, any S: y (B,S,H,P)."""
    s = x.shape[1]
    pad = -s % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    args = [t.contiguous() for t in (x, dt, A, Bm, Cm)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y = SSD.apply(*args)
    else:
        y = ssd_fwd(*args)
    return y[:, :s]
